"""Columnar table abstraction: a pytree of device arrays + null masks.

Replaces the reference's DuckDB storage layer for the imputation workload:

- columns: FEATURES-FIRST device arrays — num_data f32[d, n],
  cat_codes i32[c, n]: each column is one contiguous run, which IS
  columnar storage.
  FLOAT/DOUBLE ⇒ numeric, anything else ⇒ categorical — the reference's
  dispatch rule (triple/lift.cpp:34-37).
- null masks: bool[d, n] — the `<col>_IS_NULL` flag columns that
  `init_baseline` materializes (imputation/algorithms/partition.cpp:671-719).
- write-back: functional row replace (jnp.where on one row of the matrix) —
  this dissolves the reference's patched `ALTER TABLE … SET DEFAULT`
  zero-copy column-segment swap (duckdb_imputation.patch:26-175): replacing
  one column is O(column) and touches nothing else; with donated buffers it
  is in-place.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..schema import FeatureSchema


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Table:
    """Columnar table. All arrays share trailing row count n.

    num_data: f32[d_num, n] — numeric columns (current, possibly imputed).
    cat_codes: i32[d_cat, n] — categorical columns as LOCAL per-column codes
      against `schema` (static field).
    num_null: bool[d_num, n] — True where the value was ORIGINALLY missing.
    cat_null: bool[d_cat, n].
    """
    num_data: jax.Array
    cat_codes: jax.Array
    num_null: jax.Array
    cat_null: jax.Array
    schema: FeatureSchema = dataclasses.field(
        metadata=dict(static=True))
    num_names: tuple[str, ...] = dataclasses.field(
        default=(), metadata=dict(static=True))
    cat_names: tuple[str, ...] = dataclasses.field(
        default=(), metadata=dict(static=True))
    # per cat col: None for native-integer categories, or the tuple of
    # original labels for dictionary-encoded string/object columns (the
    # reference ingests INTEGER categories only, triple/lift.cpp:34-37;
    # this is the encode-at-the-door convenience it tells users to do by
    # hand). Raw value v of column j decodes to cat_labels[j][v].
    cat_labels: tuple = dataclasses.field(
        default=(), metadata=dict(static=True))

    @property
    def n_rows(self) -> int:
        return self.num_data.shape[-1]

    def cat_values(self) -> np.ndarray:
        """Decode codes back to raw category values, [c, n] (host)."""
        codes = np.asarray(self.cat_codes)
        out = np.zeros_like(codes, dtype=np.int64)
        for j in range(self.schema.cat_cols):
            out[j] = self.schema.decode(j, codes[j])
        return out

    def to_pandas(self, nulls_as_na: bool = False):
        """Materialize as a pandas DataFrame: numeric columns f64,
        categorical columns as raw values (dictionary-encoded string
        columns decode back to their labels; integer categories come out
        as nullable Int64). By default CURRENT cell values are emitted —
        the natural output surface after MICE, where originally-null slots
        hold imputed values. Pass nulls_as_na=True to blank the
        originally-null slots (NaN / pd.NA / None) instead — the faithful
        `from_pandas` round trip for a table that was NOT imputed (its
        null slots hold fill placeholders, not data)."""
        import pandas as pd

        data = {}
        num = np.asarray(self.num_data, np.float64)
        num_null = np.asarray(self.num_null)
        for j, name in enumerate(self.num_names):
            data[name] = (np.where(num_null[j], np.nan, num[j])
                          if nulls_as_na else num[j])
        raw = self.cat_values()
        cat_null = np.asarray(self.cat_null)
        labels = self.cat_labels or (None,) * self.schema.cat_cols
        for j, name in enumerate(self.cat_names):
            if labels[j] is not None:
                col = np.asarray(labels[j], object)[raw[j]]
                if nulls_as_na:
                    col = np.where(cat_null[j], None, col)
            else:
                col = pd.array(raw[j], dtype="Int64")
                if nulls_as_na:
                    col[cat_null[j]] = pd.NA
            data[name] = col
        return pd.DataFrame(data)

    def with_num_col(self, j: int, values: jax.Array,
                     only_null: bool = True) -> "Table":
        """Write-back for a numeric column: replace (masked) values — the
        `CASE WHEN col_IS_NULL THEN pred ELSE col END` + column swap of the
        MICE loop (imputation_base.cpp:137-139)."""
        col = self.num_data[j]
        new = jnp.where(self.num_null[j], values, col) if only_null else values
        return dataclasses.replace(
            self, num_data=self.num_data.at[j].set(new))

    def with_cat_col(self, j: int, codes: jax.Array,
                     only_null: bool = True) -> "Table":
        col = self.cat_codes[j]
        new = jnp.where(self.cat_null[j], codes, col) if only_null else codes
        return dataclasses.replace(
            self, cat_codes=self.cat_codes.at[j].set(new))

    def null_count_per_row(self) -> jax.Array:
        """The `n_nulls` row histogram column of `partition`
        (partition.cpp:61-73)."""
        return (jnp.sum(self.num_null, axis=0)
                + jnp.sum(self.cat_null, axis=0)).astype(jnp.int32)


def from_pandas(df, schema: FeatureSchema | None = None) -> Table:
    """Build a Table from a pandas DataFrame.

    Column dispatch follows the reference's rule (triple/lift.cpp:34-37):
    float dtypes ⇒ numeric, integer/boolean/categorical-of-int ⇒
    categorical. String/object/categorical-of-string columns are
    dictionary-encoded at the door — sorted-unique labels → codes 0..k−1,
    the labels kept on `Table.cat_labels` so `to_pandas` decodes them back
    (the reference only ingests INTEGER categories and tells users to
    encode by hand; this does it for them). Missing cells (NaN / pandas
    NA / None) set the null masks."""
    import pandas as pd

    num_cols, cat_cols, str_cols = [], [], set()
    for name in df.columns:
        s = df[name]
        if pd.api.types.is_float_dtype(s):
            num_cols.append(name)
        elif (pd.api.types.is_integer_dtype(s)
              or pd.api.types.is_bool_dtype(s)):
            cat_cols.append(name)
        else:
            cat_cols.append(name)
            str_cols.add(name)
    n = len(df)
    num = np.zeros((len(num_cols), n), np.float32)
    num_null = np.zeros((len(num_cols), n), bool)
    for j, name in enumerate(num_cols):
        v = df[name].to_numpy(dtype=np.float64, na_value=np.nan)
        num_null[j] = np.isnan(v)
        num[j] = np.where(num_null[j], 0.0, v)
    cat = np.zeros((len(cat_cols), n), np.int64)
    cat_null = np.zeros((len(cat_cols), n), bool)
    labels: list = []
    for j, name in enumerate(cat_cols):
        s = df[name]
        isna = s.isna().to_numpy()
        cat_null[j] = isna
        if name in str_cols:
            vals = s.to_numpy(dtype=object)
            obs = vals[~isna]
            try:
                uniq = sorted({str(v) for v in obs})
            except TypeError:
                raise ValueError(
                    f"column {name!r}: mixed un-encodable values") from None
            lut = {v: i for i, v in enumerate(uniq)}
            cat[j] = [0 if na else lut[str(v)]
                      for v, na in zip(vals, isna)]
            labels.append(tuple(uniq))
        else:
            cat[j] = np.where(isna, 0, s.fillna(0).to_numpy(dtype=np.int64))
            labels.append(None)
    t = from_numpy(num, cat, num_null, cat_null,
                   num_names=tuple(num_cols), cat_names=tuple(cat_cols),
                   schema=schema, rows_first=False)
    return dataclasses.replace(t, cat_labels=tuple(labels))


def from_numpy(num_data=None, cat_data=None, num_null=None, cat_null=None,
               num_names=(), cat_names=(), schema: FeatureSchema | None = None,
               rows_first: bool = True) -> Table:
    """Build a Table from host arrays (default pandas-style [n, d] row-major;
    pass rows_first=False for features-first input). NaNs in num_data and
    negative values in cat_data are treated as missing when explicit masks
    are absent. Missing cells are zero/first-key placeholders (call
    mice.partition.init_fill to mean/mode-fill)."""
    if num_data is None and cat_data is None:
        raise ValueError("need at least one of num_data/cat_data")

    def orient(a):
        if a is None:
            return None
        a = np.asarray(a)
        return a.T if rows_first else a

    num_data = orient(num_data)
    cat_data = orient(cat_data)
    num_null = orient(num_null)
    cat_null = orient(cat_null)
    if num_data is None:
        num_data = np.zeros((0, cat_data.shape[-1]), np.float32)
    num_data = np.asarray(num_data, np.float32)
    n = num_data.shape[-1] if num_data.size or num_data.shape[0] == 0 else 0
    n = num_data.shape[-1]
    if cat_data is None:
        cat_data = np.zeros((0, n), np.int64)
    if num_null is None:
        num_null = np.isnan(num_data)
    if cat_null is None:
        cat_null = cat_data < 0
    num_null = np.asarray(num_null, bool)
    cat_null = np.asarray(cat_null, bool)
    if schema is None:
        # vocab from OBSERVED values only (missing cells don't define classes)
        keys = []
        for j in range(cat_data.shape[0]):
            obs = cat_data[j, ~cat_null[j]]
            keys.append(tuple(int(v) for v in np.unique(obs)))
        schema = FeatureSchema(num_cols=num_data.shape[0],
                               cat_keys=tuple(keys))
    if schema.cat_cols:
        filler = np.array([k[0] if k else 0 for k in schema.cat_keys])
        filled = np.where(cat_null, filler[:, None], cat_data)
        codes = schema.encode(filled.T).T
    else:
        codes = np.zeros((0, n), np.int32)
    if not num_names:
        num_names = tuple(f"num{j}" for j in range(num_data.shape[0]))
    if not cat_names:
        cat_names = tuple(f"cat{j}" for j in range(cat_data.shape[0]))
    return Table(
        num_data=jnp.asarray(np.where(num_null, 0.0, num_data), jnp.float32),
        cat_codes=jnp.asarray(codes, jnp.int32),
        num_null=jnp.asarray(num_null),
        cat_null=jnp.asarray(cat_null),
        schema=schema, num_names=num_names, cat_names=cat_names)
