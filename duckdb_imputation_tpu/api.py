"""Reference-parity API surface.

Python mirror of every SQL function the reference extension registers
(/root/reference/duckdb_extension/src/duckdb_imputation_extension.cpp:48-249)
and the client-side library entry points (imputation/include/*.h):

  ring ops:  to_cofactor, sum_triple, sum_to_triple_<x>_<y>, multiply_triple,
             to_nb_agg, sum_nb_agg, sum_to_nb_agg_<x>_<y>, multiply_nb_agg,
             subtract_triple (client-side, sum_sub.h:9-13)
  models:    lda_train/lda_predict, linreg_train/linreg_predict,
             qda_train/qda_predict, nb_train/nb_predict
  MICE:      run_MICE_baseline, run_MICE_low, run_MICE_high

Column-type dispatch follows the reference's rule (triple/lift.cpp:34-37):
float dtype ⇒ numerical, integer dtype ⇒ categorical; numerical columns must
precede categorical ones in the argument list. The reference registers a
fixed 20×20 grid of `sum_to_triple_{x}_{y}` names
(duckdb_imputation_extension.cpp:80-113); here any `sum_to_triple_<x>_<y>`
attribute resolves dynamically (no 20-column ceiling, and none of the
1024-column scratch limits of lift.cpp:29).

Values are `Cofactor` / `NBValue` wrappers (dense triple + schema) with
`.to_dict()` producing the reference's nested key/value format.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Sequence

import jax
import numpy as np

from .schema import FeatureSchema
from .ring import serialize
from .ring import sum as ring_sum
from .ring import triple as ring_triple
from . import models as _models


# ---------------------------------------------------------------------------
# value wrappers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cofactor:
    """A triple (or batch of per-group triples) + its schema."""
    triple: ring_triple.Triple
    schema: FeatureSchema
    batched: bool = False

    def to_dict(self, style: str = "agg"):
        if self.batched:
            n = self.triple.n.shape[0]
            return [serialize.triple_to_dict(
                jax.tree.map(lambda a, i=i: a[i], self.triple),
                self.schema, style) for i in range(n)]
        return serialize.triple_to_dict(self.triple, self.schema, style)

    def __add__(self, other: "Cofactor") -> "Cofactor":
        return Cofactor(ring_triple.triple_add(self.triple, other.triple),
                        self.schema, self.batched)

    def __sub__(self, other: "Cofactor") -> "Cofactor":
        return Cofactor(ring_triple.triple_sub(self.triple, other.triple),
                        self.schema, self.batched)


@dataclasses.dataclass
class NBValue:
    agg: ring_triple.NBAgg
    schema: FeatureSchema
    batched: bool = False

    def to_dict(self, style: str = "agg"):
        if self.batched:
            n = self.agg.n.shape[0]
            return [serialize.nb_to_dict(
                jax.tree.map(lambda a, i=i: a[i], self.agg),
                self.schema, style) for i in range(n)]
        return serialize.nb_to_dict(self.agg, self.schema, style)

    def __add__(self, other: "NBValue") -> "NBValue":
        return NBValue(ring_triple.triple_add(self.agg, other.agg),
                       self.schema, self.batched)

    def __sub__(self, other: "NBValue") -> "NBValue":
        return NBValue(ring_triple.triple_sub(self.agg, other.agg),
                       self.schema, self.batched)


# ---------------------------------------------------------------------------
# column splitting (the FLOAT⇒num / INTEGER⇒cat dispatch)
# ---------------------------------------------------------------------------

def _split_columns(cols: Sequence[np.ndarray]):
    num, cat = [], []
    seen_cat = False
    for c in cols:
        c = np.asarray(c)
        if np.issubdtype(c.dtype, np.floating):
            if seen_cat:
                raise ValueError(
                    "numerical columns must precede categorical ones "
                    "(reference rule, README.md:126)")
            num.append(c.astype(np.float32))
        else:
            seen_cat = True
            cat.append(c.astype(np.int64))
    n = len(num[0]) if num else len(cat[0])
    x = np.stack(num, 0) if num else None          # features-first [d, n]
    craw = np.stack(cat, 0) if cat else None
    return x, craw, n


def _schema_and_codes(x, craw, schema: FeatureSchema | None):
    if schema is None:
        schema = FeatureSchema.infer(
            x.T if x is not None else None,
            craw.T if craw is not None else None)
    codes = schema.encode(craw.T).T if craw is not None else None
    return schema, codes


# ---------------------------------------------------------------------------
# ring aggregate surface
# ---------------------------------------------------------------------------

def to_cofactor(*cols, schema: FeatureSchema | None = None) -> Cofactor:
    """`to_cofactor(cols…)` (lift): one degree-1 triple per row."""
    x, craw, n = _split_columns(cols)
    schema, codes = _schema_and_codes(x, craw, schema)
    return Cofactor(ring_sum.lift(x, codes, schema=schema), schema,
                    batched=True)


def sum_triple(value: Cofactor) -> Cofactor:
    """`sum_triple(triple)` aggregate over lifted triples."""
    return Cofactor(ring_sum.sum_triples(value.triple), value.schema)


def sum_to_triple(*cols, weights=None, group_by=None, num_groups=None,
                  schema: FeatureSchema | None = None,
                  backend: str = "auto") -> Cofactor:
    """`sum_to_triple_x_y(cols…)` — fused lift+sum; optional row weights
    (WHERE mask) and GROUP BY vector."""
    x, craw, n = _split_columns(cols)
    schema, codes = _schema_and_codes(x, craw, schema)
    if group_by is not None:
        g = np.asarray(group_by)
        if num_groups is None:
            num_groups = int(g.max()) + 1
        t = ring_sum.sum_to_triple_grouped(
            x, codes, g, schema=schema, num_groups=num_groups,
            weights=weights)
        return Cofactor(t, schema, batched=True)
    t = ring_sum.sum_to_triple(x, codes, weights, schema=schema,
                               backend=backend)
    return Cofactor(t, schema)


def multiply_triple(a: Cofactor, b: Cofactor) -> Cofactor:
    """`multiply_triple(t1, t2)` — the ring product for factorized joins."""
    return Cofactor(ring_triple.triple_multiply(a.triple, b.triple),
                    a.schema.concat(b.schema))


# Jitted once at module level so repeated factorized_sum calls hit the
# compilation cache instead of retracing per invocation.
_fused_join_sum = jax.jit(ring_triple.factorized_join_sum)
_fused_join_sum_nb = jax.jit(ring_triple.factorized_join_sum_nb)


def factorized_sum(a: Cofactor, b: Cofactor) -> Cofactor:
    """Fused `sum_triple(multiply_triple(A, B))` over per-join-key triples —
    the factorized-join aggregation of README.md:163-174 (and the intent of
    the reference's dead factorized_imputation_*.h drivers) as one jitted
    bundle of matrix contractions over the key axis.

    `a`/`b` are batched Cofactors from `sum_to_triple(..., group_by=key)`
    with the SAME num_groups (key space). Returns the single joined triple."""
    if not (a.batched and b.batched):
        raise ValueError("factorized_sum needs per-key (batched) cofactors; "
                         "use sum_to_triple(..., group_by=join_key)")
    return Cofactor(_fused_join_sum(a.triple, b.triple),
                    a.schema.concat(b.schema))


def factorized_sum_nb(a: NBValue, b: NBValue) -> NBValue:
    """NB-aggregate factorized join-sum (see factorized_sum)."""
    if not (a.batched and b.batched):
        raise ValueError("factorized_sum_nb needs per-key (batched) aggs")
    return NBValue(_fused_join_sum_nb(a.agg, b.agg),
                   a.schema.concat(b.schema))


def subtract_triple(a: Cofactor, b: Cofactor) -> Cofactor:
    """Client-side `Triple::subtract_triple` — the MICE delta operator
    (imputation/triple/sub.cpp)."""
    return a - b


def to_nb_agg(*cols, schema: FeatureSchema | None = None) -> NBValue:
    x, craw, n = _split_columns(cols)
    schema, codes = _schema_and_codes(x, craw, schema)
    return NBValue(ring_sum.nb_lift(x, codes, schema=schema), schema,
                   batched=True)


def sum_nb_agg(value: NBValue) -> NBValue:
    return NBValue(ring_sum.sum_nb_aggs(value.agg), value.schema)


def sum_to_nb_agg(*cols, weights=None, group_by=None, num_groups=None,
                  schema: FeatureSchema | None = None) -> NBValue:
    x, craw, n = _split_columns(cols)
    schema, codes = _schema_and_codes(x, craw, schema)
    if group_by is not None:
        g = np.asarray(group_by)
        if num_groups is None:
            num_groups = int(g.max()) + 1
        t = ring_sum.sum_to_nb_agg_grouped(
            x, codes, g, schema=schema, num_groups=num_groups,
            weights=weights)
        return NBValue(t, schema, batched=True)
    return NBValue(ring_sum.sum_to_nb_agg(x, codes, weights, schema=schema),
                   schema)


def multiply_nb_agg(a: NBValue, b: NBValue) -> NBValue:
    return NBValue(ring_triple.nb_multiply(a.agg, b.agg),
                   a.schema.concat(b.schema))


def sum_nb_triple(a: NBValue, b: NBValue) -> NBValue:
    """Client-side `Triple::sum_nb_triple` (imputation/triple/sum_nb.cpp)."""
    return a + b


# ---------------------------------------------------------------------------
# model surface — reference argument orders
# ---------------------------------------------------------------------------

def lda_train(value: Cofactor, label: int, shrinkage: float = 0.0,
              normalize: bool = False) -> np.ndarray:
    return _models.lda_train(value.triple, value.schema, label,
                             shrinkage=shrinkage, normalize=normalize)


def lda_predict(params, normalize: bool, *cols) -> np.ndarray:
    x, craw, n = _split_columns(cols)
    codes = None
    if craw is not None:
        # non-label columns use their own (stored) vocab; rebuild from params
        p = _models.LDAParams.decode(np.asarray(params),
                                     0 if x is None else x.shape[0],
                                     normalize)
        keys, offs = p.cat_keys, p.offsets
        cat_keys = tuple(
            tuple(int(k) for k in keys[offs[j]:offs[j + 1]])
            for j in range(len(offs) - 1))
        sch = FeatureSchema(num_cols=0, cat_keys=cat_keys)
        codes = sch.encode(craw.T).T
    return np.asarray(_models.lda_predict(np.asarray(params), x, codes,
                                          normalize=normalize))


def linreg_train(value: Cofactor, label: int, step_size: float = 0.001,
                 lambda_: float = 0.0, max_iterations: int = 10000,
                 compute_variance: bool = False,
                 normalize: bool = False) -> np.ndarray:
    return _models.linreg_train(value.triple, value.schema, label,
                                step_size=step_size, lam=lambda_,
                                max_iters=max_iterations,
                                compute_variance=compute_variance,
                                normalize=normalize)


def linreg_predict(params, add_noise: bool, normalize: bool, *cols,
                   key=None) -> np.ndarray:
    x, craw, n = _split_columns(cols)
    codes = None
    if craw is not None:
        p = _models.LinregParams.decode(np.asarray(params),
                                        0 if x is None else x.shape[0],
                                        normalize, add_noise)
        offs = p.offsets
        cat_keys = tuple(
            tuple(int(k) for k in p.cat_keys[offs[j]:offs[j + 1]])
            for j in range(p.n_cat))
        sch = FeatureSchema(num_cols=0, cat_keys=cat_keys)
        codes = sch.encode(craw.T).T
    return np.asarray(_models.linreg_predict(
        np.asarray(params), x, codes, add_noise=add_noise,
        normalize=normalize, key=key))


def qda_train(value: Cofactor, labels, normalize: bool = False) -> np.ndarray:
    """value: batched per-class Cofactor (from sum_to_triple(group_by=…))."""
    return _models.qda_train(value.triple, value.schema, labels,
                             normalize=normalize)


def qda_predict(params, normalize: bool, *cols) -> np.ndarray:
    x, craw, n = _split_columns(cols)
    codes = None
    if craw is not None:
        p = _models.QDAParams.decode(np.asarray(params),
                                     0 if x is None else x.shape[0],
                                     normalize)
        offs = p.offsets
        cat_keys = tuple(
            tuple(int(k) for k in p.cat_keys[offs[j]:offs[j + 1]])
            for j in range(len(offs) - 1))
        sch = FeatureSchema(num_cols=0, cat_keys=cat_keys)
        codes = sch.encode(craw.T).T
    return np.asarray(_models.qda_predict(np.asarray(params), x, codes,
                                          normalize=normalize))


def nb_train(value: NBValue, labels) -> np.ndarray:
    return _models.nb_train(value.agg, value.schema, labels)


def nb_predict(params, normalize: bool, *cols) -> np.ndarray:
    x, craw, n = _split_columns(cols)
    codes = None
    if craw is not None:
        p = _models.NBParams.decode(np.asarray(params),
                                    0 if x is None else x.shape[0])
        offs = p.offsets
        cat_keys = tuple(
            tuple(int(k) for k in p.cat_keys[offs[j]:offs[j + 1]])
            for j in range(len(offs) - 1))
        sch = FeatureSchema(num_cols=0, cat_keys=cat_keys)
        codes = sch.encode(craw.T).T
    return np.asarray(_models.nb_predict(np.asarray(params), x, codes))


# ---------------------------------------------------------------------------
# MICE surface — reference entry-point names
# ---------------------------------------------------------------------------

def run_MICE_baseline(table, con_columns_nulls=None, cat_columns_nulls=None,
                      mice_iters: int = 5, **kw):
    """`run_MICE_baseline(con, con_columns, cat_columns, con_columns_nulls,
    cat_columns_nulls, table_name, mice_iters)`
    (imputation/include/imputation_baseline.h:8). Columns are given by name
    or index; the full column lists are implied by the table."""
    from .mice import run_mice_baseline
    return run_mice_baseline(
        table, _resolve(table.num_names, con_columns_nulls),
        _resolve(table.cat_names, cat_columns_nulls), iters=mice_iters, **kw)


def run_MICE_low(table, con_columns_nulls=None, cat_columns_nulls=None,
                 mice_iters: int = 5, **kw):
    from .mice import run_mice_low
    return run_mice_low(
        table, _resolve(table.num_names, con_columns_nulls),
        _resolve(table.cat_names, cat_columns_nulls), iters=mice_iters, **kw)


def run_MICE_high(table, con_columns_nulls=None, cat_columns_nulls=None,
                  mice_iters: int = 5, **kw):
    from .mice import run_mice_high
    return run_mice_high(
        table, _resolve(table.num_names, con_columns_nulls),
        _resolve(table.cat_names, cat_columns_nulls), iters=mice_iters, **kw)


def _resolve(names, cols):
    if cols is None:
        return None
    return [names.index(c) if isinstance(c, str) else int(c) for c in cols]


# ---------------------------------------------------------------------------
# the registration grid: sum_to_triple_<x>_<y> / sum_to_nb_agg_<x>_<y>
# ---------------------------------------------------------------------------

_GRID_RE = re.compile(r"^(sum_to_triple|sum_to_nb_agg)_(\d+)_(\d+)$")


def __getattr__(name: str):
    m = _GRID_RE.match(name)
    if not m:
        raise AttributeError(name)
    base, n_num, n_cat = m.group(1), int(m.group(2)), int(m.group(3))
    fn = sum_to_triple if base == "sum_to_triple" else sum_to_nb_agg

    def grid_fn(*cols, **kw):
        if len(cols) != n_num + n_cat:
            raise TypeError(
                f"{name} expects {n_num + n_cat} columns, got {len(cols)}")
        num = [np.asarray(c, np.float32) for c in cols[:n_num]]
        cat = [np.asarray(c).astype(np.int64) for c in cols[n_num:]]
        return fn(*num, *cat, **kw)

    grid_fn.__name__ = name
    return grid_fn
