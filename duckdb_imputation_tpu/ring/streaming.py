"""Out-of-core streaming cofactor aggregation.

The reference can only aggregate what DuckDB has on disk inside one host
process; this module aggregates data that never fits in HBM (or host RAM):
chunks stream host→device and fold into a single resident Gram matrix.

The subtlety is MICE's init fill. `init_fill` (mice/partition.py, mirroring
`init_baseline`, /root/reference/imputation/algorithms/partition.cpp:671-719)
replaces numeric nulls with the column MEAN and categorical nulls with the
column MODE — but the mean/mode are global statistics, unknown until the
whole stream has been seen. Instead of a second aggregation pass over the
filled data, we accumulate ONE extended Gram over

    Aᵀ = [ Z₀ᵀ ; Mᵀ ]  ∈ f32[P+K, m]

where Z₀ is the feature block with nulls contributing NOTHING (numeric null
cells zeroed; categorical null cells encoded out-of-vocab so their one-hot
row is all zero) and M is the null-indicator block for the K nullable
columns (the `<col>_IS_NULL` flag columns of init_baseline, as f32 0/1).

Let U ∈ R[P, K] place each nullable column's fill value at its sigma row
(U[1+j, k] = mean_j for numeric col j; U[1+d+offs_c+mode_c, k] = 1 for
categorical col c). The filled feature block is exactly Z_filled = Z₀ + M·Uᵀ,
so with G = Aᵀ diag(w) A partitioned into blocks G_zz, G_zm, G_mm:

    S_filled = G_zz + G_zm·Uᵀ + U·G_zmᵀ + U·G_mm·Uᵀ

— the full triple over the mean/mode-filled table, from one pass, without
knowing the fills in advance. The fills themselves also come out of G:
observed sums/counts are row 0 of G_zz (null cells contribute zero by
construction) and per-column null counts are diag(G_mm).

This is the streaming analogue of the fused `sum_to_triple_x_y … WHERE`
aggregation (sum_no_lift.cpp:53-216) plus init_baseline's fill, collapsed
into one scan.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import Iterable, Iterator, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..schema import FeatureSchema
from .triple import Triple, triple_from_sigma

# Default rows per streamed chunk. 1M rows × (d+c) cols is a few MB per
# host→device copy — big enough to amortize dispatch, small enough to keep
# a few chunks in flight.
DEFAULT_STREAM_CHUNK = 1 << 20


class Chunk(NamedTuple):
    """One host chunk of a streamed table, features-first.

    num: f32[d, m] numeric columns (NaN ⇒ missing when num_null is None).
    cat: i64[c, m] RAW categorical values (negative ⇒ missing when
      cat_null is None) — encoding against the global schema happens
      inside the stream scan, after the vocab is known.
    """
    num: np.ndarray | None
    cat: np.ndarray | None
    num_null: np.ndarray | None = None
    cat_null: np.ndarray | None = None


def _normalize_chunk(ch) -> tuple[np.ndarray, np.ndarray,
                                  np.ndarray, np.ndarray]:
    if not isinstance(ch, Chunk):
        ch = Chunk(*ch)  # accept plain (num, cat[, num_null, cat_null])
    num = ch.num
    cat = ch.cat
    if num is None and cat is None:
        raise ValueError("chunk needs num or cat columns")
    m = num.shape[-1] if num is not None else cat.shape[-1]
    num = (np.zeros((0, m), np.float32) if num is None
           else np.asarray(num, np.float32))
    cat = (np.zeros((0, m), np.int64) if cat is None
           else np.asarray(cat, np.int64))
    num_null = (np.isnan(num) if ch.num_null is None
                else np.asarray(ch.num_null, bool))
    cat_null = (cat < 0 if ch.cat_null is None
                else np.asarray(ch.cat_null, bool))
    return num, cat, num_null, cat_null


def chunks_from_arrays(num, cat, num_null=None, cat_null=None,
                       chunk_rows: int = DEFAULT_STREAM_CHUNK):
    """Chunk source over in-memory features-first arrays (tests / adapters)."""
    ch = _normalize_chunk(Chunk(num, cat, num_null, cat_null))

    def source() -> Iterator[Chunk]:
        n = ch[0].shape[-1] if ch[0].shape[0] else ch[1].shape[-1]
        for lo in range(0, n, chunk_rows):
            hi = min(lo + chunk_rows, n)
            yield Chunk(*(a[:, lo:hi] for a in ch))
    return source


@dataclasses.dataclass(frozen=True)
class StreamSchema:
    """Global schema + nullable-column structure discovered by pass 0."""
    schema: FeatureSchema
    nullable_num: tuple[int, ...]   # numeric col ids with ≥1 null
    nullable_cat: tuple[int, ...]
    n_rows: int

    @property
    def k(self) -> int:
        return len(self.nullable_num) + len(self.nullable_cat)


@dataclasses.dataclass
class DirtyCache:
    """Host cache of the rows that contain at least one null — the only
    rows MICE ever rewrites. For the low-missing regime this is the whole
    working set after the stream pass: O(dirty) ≪ O(n)."""
    idx: np.ndarray        # i64[nd] global row indices, ascending
    num: np.ndarray        # f32[d, nd] raw values (null cells garbage)
    cat: np.ndarray        # i64[c, nd] raw values
    num_null: np.ndarray   # bool[d, nd]
    cat_null: np.ndarray   # bool[c, nd]


class DirtySpill:
    """Disk-backed dirty-row store — the HIGH-missing fallback.

    The in-RAM DirtyCache makes peak host memory O(chunk + dirty); at high
    missing rates dirty is O(n) and the out-of-core claim silently
    collapses. When the dirty count exceeds `dirty_budget_rows`, rows spill
    to temp files instead and every consumer (delta aggregation, predict
    write-back, output substitution) touches them through bounded windows:
    peak memory becomes O(chunk + window + (P+K)²), independent of both n
    AND the missing rate. Arrays are ROWS-FIRST on disk so appends are
    contiguous; `window(lo, hi)` returns features-first copies; writes go
    straight into the memmaps (the imputed values persist between rounds on
    disk, which is where they must live — they don't fit RAM by premise)."""

    def __init__(self, d: int, c: int, dir: str | None = None):
        import tempfile
        self._dir = tempfile.mkdtemp(prefix="dbi_spill_", dir=dir)
        self.d, self.c = d, c
        names = ("idx", "num", "cat", "num_null", "cat_null")
        self._paths = {nm: os.path.join(self._dir, nm + ".bin")
                       for nm in names}
        self._handles = {nm: open(p, "wb") for nm, p in self._paths.items()}
        self.n = 0
        self._maps = None

    def append(self, idx, num, cat, num_null, cat_null) -> None:
        """Append a features-first dirty slice (written rows-first)."""
        self._handles["idx"].write(
            np.ascontiguousarray(idx, np.int64).tobytes())
        self._handles["num"].write(
            np.ascontiguousarray(num.T, np.float32).tobytes())
        self._handles["cat"].write(
            np.ascontiguousarray(cat.T, np.int64).tobytes())
        self._handles["num_null"].write(
            np.ascontiguousarray(num_null.T, bool).tobytes())
        self._handles["cat_null"].write(
            np.ascontiguousarray(cat_null.T, bool).tobytes())
        self.n += len(idx)

    def finalize(self) -> None:
        for h in self._handles.values():
            h.close()
        self._handles = {}
        n, d, c = max(self.n, 1), self.d, self.c

        def mm(nm, dtype, shape):
            return np.memmap(self._paths[nm], dtype=dtype, mode="r+",
                             shape=shape) if self.n else \
                np.zeros(shape, dtype)
        self.idx = mm("idx", np.int64, (self.n,))
        self.num = mm("num", np.float32, (self.n, d))
        self.cat = mm("cat", np.int64, (self.n, c))
        self.num_null = mm("num_null", bool, (self.n, d))
        self.cat_null = mm("cat_null", bool, (self.n, c))

    def window(self, lo: int, hi: int):
        """Features-first copies of rows [lo, hi): (num f32[d, m],
        cat i64[c, m], num_null bool[d, m], cat_null bool[c, m])."""
        return (np.ascontiguousarray(self.num[lo:hi].T),
                np.ascontiguousarray(self.cat[lo:hi].T),
                np.ascontiguousarray(self.num_null[lo:hi].T),
                np.ascontiguousarray(self.cat_null[lo:hi].T))

    def write_num(self, col: int, lo: int, values, mask) -> None:
        """Masked write-back of imputed numeric values into rows
        [lo, lo+len(mask))."""
        block = self.num[lo:lo + len(mask), col]
        block[mask] = np.asarray(values, np.float32)[mask]

    def write_cat(self, col: int, lo: int, raw_values, mask) -> None:
        block = self.cat[lo:lo + len(mask), col]
        block[mask] = np.asarray(raw_values, np.int64)[mask]

    def cleanup(self) -> None:
        import shutil
        self._maps = None
        shutil.rmtree(self._dir, ignore_errors=True)


def scan_schema(chunk_source, *, collect_dirty: bool = True,
                dirty_budget_rows: int | None = None, spill_dir=None
                ) -> tuple[StreamSchema, "DirtyCache | DirtySpill | None"]:
    """Pass 0 (host-only): per-column vocab union over OBSERVED values
    (the streaming `build_list_of_uniq_categoricals`, partition.cpp:722-747),
    nullable-column detection, and the dirty-row cache. When the dirty
    count exceeds `dirty_budget_rows`, the cache converts to a disk-backed
    DirtySpill (see its docstring) and host memory stays bounded."""
    vocabs: list[set] | None = None
    d_num = None
    n_rows = 0
    any_num_null = None
    any_cat_null = None
    dirty: list[tuple] = []
    dirty_count = 0
    spill: DirtySpill | None = None
    for raw in chunk_source():
        num, cat, num_null, cat_null = _normalize_chunk(raw)
        m = num.shape[-1] if num.shape[0] else cat.shape[-1]
        if vocabs is None:
            d_num = num.shape[0]
            vocabs = [set() for _ in range(cat.shape[0])]
            any_num_null = np.zeros(num.shape[0], bool)
            any_cat_null = np.zeros(cat.shape[0], bool)
        for j in range(cat.shape[0]):
            obs = cat[j, ~cat_null[j]]
            vocabs[j].update(np.unique(obs).tolist())
        any_num_null |= num_null.any(axis=1)
        any_cat_null |= cat_null.any(axis=1)
        if collect_dirty:
            rows = num_null.any(axis=0) | cat_null.any(axis=0)
            if rows.any():
                (r,) = np.nonzero(rows)
                part = (r + n_rows, num[:, r], cat[:, r],
                        num_null[:, r], cat_null[:, r])
                dirty_count += len(r)
                if (spill is None and dirty_budget_rows is not None
                        and dirty_count > dirty_budget_rows):
                    spill = DirtySpill(d_num, cat.shape[0], dir=spill_dir)
                    for dpart in dirty:
                        spill.append(*dpart)
                    dirty = []
                if spill is not None:
                    spill.append(*part)
                else:
                    dirty.append(part)
        n_rows += m
    if vocabs is None:
        raise ValueError("empty stream")
    schema = FeatureSchema(
        num_cols=d_num,
        cat_keys=tuple(tuple(sorted(v)) for v in vocabs))
    ss = StreamSchema(
        schema=schema,
        nullable_num=tuple(int(j) for j in np.nonzero(any_num_null)[0]),
        nullable_cat=tuple(int(j) for j in np.nonzero(any_cat_null)[0]),
        n_rows=n_rows)
    cache = None
    if collect_dirty:
        if spill is not None:
            spill.finalize()
            cache = spill
        elif dirty:
            cache = DirtyCache(
                idx=np.concatenate([d[0] for d in dirty]),
                num=np.concatenate([d[1] for d in dirty], axis=1),
                cat=np.concatenate([d[2] for d in dirty], axis=1),
                num_null=np.concatenate([d[3] for d in dirty], axis=1),
                cat_null=np.concatenate([d[4] for d in dirty], axis=1))
        else:
            cache = DirtyCache(
                idx=np.zeros((0,), np.int64),
                num=np.zeros((schema.num_cols, 0), np.float32),
                cat=np.zeros((schema.cat_cols, 0), np.int64),
                num_null=np.zeros((schema.num_cols, 0), bool),
                cat_null=np.zeros((schema.cat_cols, 0), bool))
    return ss, cache


@functools.partial(jax.jit, static_argnames=("ss",), donate_argnums=(0,))
def _fold_chunk(gram, x_num, codes, num_null, cat_null, w, *,
                ss: StreamSchema):
    """gram += Aᵀ diag(w) A for one chunk; A = [Z₀ | M].

    Null handling happens HERE, on device: numeric null cells zeroed,
    categorical null cells pushed out-of-vocab (⇒ all-zero one-hot row),
    flag block M appended. f32 accumulation at HIGHEST precision — the same
    error class as the reference's own f32 sums."""
    from .sum import _zt_block  # local import to avoid a cycle

    schema = ss.schema
    # where(), not multiply-by-mask: null cells may hold NaN and NaN·0 = NaN
    x0 = jnp.where(num_null, 0.0, x_num) if schema.num_cols else x_num
    oov = jnp.asarray(schema.cat_sizes, jnp.int32)[:, None] if schema.cat_cols \
        else jnp.zeros((0, 1), jnp.int32)
    c0 = jnp.where(cat_null, oov, codes) if schema.cat_cols else codes
    rows = [_zt_block(x0, c0, schema)]
    for j in ss.nullable_num:
        rows.append(num_null[j][None, :].astype(jnp.float32))
    for j in ss.nullable_cat:
        rows.append(cat_null[j][None, :].astype(jnp.float32))
    at = jnp.concatenate(rows, axis=0)
    g = jax.lax.dot_general(at * w[None, :], at, (((1,), (1,)), ((), ())),
                            precision=jax.lax.Precision.HIGHEST,
                            preferred_element_type=jnp.float32)
    return gram + g


@functools.partial(jax.jit, static_argnames=("ss",), donate_argnums=(0,))
def _fold_chunk_packed(gram, x_num, codes_i8, null_bits, m, *,
                       ss: StreamSchema):
    """_fold_chunk with the host→device payload SHRUNK (every
    host-attached device pays the host link for these bytes):

      * codes ride as int8 (gated on every vocab < 127 — the oov code
        `size` must be representable), widened on device;
      * the nullable columns' masks ride as ONE uint8 bitmask per row
        (gated on ≤ 8 nullable columns), unpacked on device — the
        non-nullable columns' masks are identically False;
      * the zero-weight tail pad is derived from the scalar row count
        instead of shipping a f32[n] weight vector.

    34 → 19 bytes/row at the 4-num 2-cat benchmark schema. Bit-identical
    to _fold_chunk once unpacked."""
    schema = ss.schema
    n = (x_num.shape[-1] if schema.num_cols else codes_i8.shape[-1])
    nb = null_bits[0]
    num_null = (jnp.stack(
        [(nb >> ss.nullable_num.index(j)) & 1 if j in ss.nullable_num
         else jnp.zeros_like(nb)
         for j in range(schema.num_cols)]).astype(bool)
        if schema.num_cols else jnp.zeros((0, n), bool))
    k0 = len(ss.nullable_num)
    cat_null = (jnp.stack(
        [(nb >> (k0 + ss.nullable_cat.index(j))) & 1
         if j in ss.nullable_cat else jnp.zeros_like(nb)
         for j in range(schema.cat_cols)]).astype(bool)
        if schema.cat_cols else jnp.zeros((0, n), bool))
    w = (jnp.arange(n) < m).astype(jnp.float32)
    return _fold_chunk(gram, x_num, codes_i8.astype(jnp.int32),
                       num_null, cat_null, w, ss=ss)


def _pad_to(a, m):
    pad = m - a.shape[-1]
    if pad == 0:
        return a
    return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)])


def scan_gram(chunk_source, ss: StreamSchema, *,
              chunk_rows: int = DEFAULT_STREAM_CHUNK,
              mesh=None) -> np.ndarray:
    """Pass 1: stream chunks host→device, fold into the extended Gram.

    Chunks are re-blocked to a fixed `chunk_rows` so the fold compiles once
    (ragged tails ride with weight-0 padding). Dispatch is async: while the
    device folds chunk k, the host encodes and ships chunk k+1 — the
    transfer/compute overlap is the pipeline, no explicit double buffer
    needed.

    With a `mesh` (jax.sharding.Mesh with a 'data' axis), each chunk's rows
    shard across the devices and GSPMD inserts one psum of the [P+K, P+K]
    Gram per chunk — the out-of-core scan and the multi-chip combine
    compose: this is the reference's thread-merge (SumStateCombine) as a
    device all-reduce while the data streams from beyond device memory."""
    schema = ss.schema
    p_ext = schema.sigma_size + ss.k
    row_shard = rep = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        # the sharded row axis must divide evenly across the data axis
        d = mesh.shape["data"]
        chunk_rows = -(-chunk_rows // d) * d
        row_shard = NamedSharding(mesh, P(None, "data"))
        w_shard = NamedSharding(mesh, P("data"))
        rep = NamedSharding(mesh, P())
    gram = (jnp.zeros((p_ext, p_ext), jnp.float32) if rep is None
            else jax.device_put(np.zeros((p_ext, p_ext), np.float32), rep))

    # packed payload gate (see _fold_chunk_packed): int8 codes need every
    # vocab's oov code < 127, the uint8 bitmask needs ≤ 8 nullable cols
    packed = (ss.k <= 8
              and all(s < 127 for s in schema.cat_sizes))

    def fold(num, cat, num_null, cat_null, m):
        nonlocal gram
        # zero the null cells host-side: _fold_chunk masks them anyway, and
        # raw NaNs must not reach device_put — multihost shardings run a
        # cross-process equality check where NaN != NaN rejects the chunk
        if num.shape[0]:
            num = np.where(num_null, 0.0, num)
        codes = (schema.encode(cat.T).T.astype(np.int32)
                 if schema.cat_cols else np.zeros((0, chunk_rows), np.int32))
        if packed:
            bits = np.zeros((1, chunk_rows), np.uint8)
            for b, j in enumerate(ss.nullable_num):
                bits[0] |= num_null[j].astype(np.uint8) << b
            k0 = len(ss.nullable_num)
            for b, j in enumerate(ss.nullable_cat):
                bits[0] |= cat_null[j].astype(np.uint8) << (k0 + b)
            parts2 = (num, codes.astype(np.int8), bits)
            if row_shard is not None:
                args = tuple(jax.device_put(np.ascontiguousarray(a),
                                            row_shard) for a in parts2) \
                    + (jax.device_put(np.int32(m), rep),)
            else:
                args = tuple(jnp.asarray(a) for a in parts2) \
                    + (jnp.int32(m),)
            gram = _fold_chunk_packed(gram, *args, ss=ss)
            return
        w = (np.arange(chunk_rows) < m).astype(np.float32)
        if row_shard is not None:
            args = (jax.device_put(np.ascontiguousarray(num), row_shard),
                    jax.device_put(np.ascontiguousarray(codes), row_shard),
                    jax.device_put(np.ascontiguousarray(num_null), row_shard),
                    jax.device_put(np.ascontiguousarray(cat_null), row_shard),
                    jax.device_put(w, w_shard))
        else:
            args = (jnp.asarray(num), jnp.asarray(codes),
                    jnp.asarray(num_null), jnp.asarray(cat_null),
                    jnp.asarray(w))
        gram = _fold_chunk(gram, *args, ss=ss)

    buf = None  # accumulating re-blocker
    for raw in chunk_source():
        parts = _normalize_chunk(raw)
        buf = parts if buf is None else tuple(
            np.concatenate([b, p], axis=1) for b, p in zip(buf, parts))
        while buf[0].shape[-1] >= chunk_rows:
            take = tuple(a[:, :chunk_rows] for a in buf)
            buf = tuple(a[:, chunk_rows:] for a in buf)
            fold(*take, chunk_rows)
    if buf is not None and buf[0].shape[-1]:
        m = buf[0].shape[-1]
        # pad tail with zero rows; their weight is 0 so they add nothing
        # (real NaN null cells are neutralized by where() in _fold_chunk)
        fold(*(_pad_to(a, chunk_rows) for a in buf), m)
    return np.asarray(jax.device_get(gram), np.float64)


@dataclasses.dataclass(frozen=True)
class StreamFills:
    """The init fills recovered from the extended Gram (≙ init_baseline's
    AVG/MODE, partition.cpp:42-57) + null counts."""
    num_means: tuple[float, ...]        # per NUMERIC col (0.0 if not nullable)
    cat_modes: tuple[int, ...]          # per CAT col, LOCAL mode code
    num_null_counts: tuple[int, ...]
    cat_null_counts: tuple[int, ...]


def assemble_filled_triple(gram: np.ndarray, ss: StreamSchema
                           ) -> tuple[Triple, StreamFills]:
    """Blocks of the extended Gram → the full triple over the mean/mode
    FILLED table (see module docstring for the U algebra)."""
    schema = ss.schema
    p = schema.sigma_size
    d = schema.num_cols
    g = np.asarray(gram, np.float64)
    gzz, gzm, gmm = g[:p, :p], g[:p, p:], g[p:, p:]
    n = gzz[0, 0]
    nullc = np.diag(gmm)

    offs = schema.offsets
    means = [0.0] * d
    modes = [0] * schema.cat_cols
    num_nc = [0] * d
    cat_nc = [0] * schema.cat_cols
    u = np.zeros((p, ss.k), np.float64)
    for k, j in enumerate(ss.nullable_num):
        cnt = n - nullc[k]
        means[j] = float(gzz[0, 1 + j] / cnt) if cnt > 0 else 0.0
        num_nc[j] = int(round(nullc[k]))
        u[1 + j, k] = means[j]
    for k2, j in enumerate(ss.nullable_cat):
        k = len(ss.nullable_num) + k2
        counts = gzz[0, 1 + d + offs[j]:1 + d + offs[j + 1]]
        modes[j] = int(np.argmax(counts)) if counts.size else 0
        cat_nc[j] = int(round(nullc[k]))
        u[1 + d + offs[j] + modes[j], k] = 1.0
    sigma = gzz + gzm @ u.T + u @ gzm.T + u @ gmm @ u.T
    fills = StreamFills(num_means=tuple(means), cat_modes=tuple(modes),
                        num_null_counts=tuple(num_nc),
                        cat_null_counts=tuple(cat_nc))
    return triple_from_sigma(jnp.asarray(sigma, jnp.float32), d), fills


def aggregate_stream(chunk_source, *, chunk_rows: int = DEFAULT_STREAM_CHUNK,
                     collect_dirty: bool = True, mesh=None,
                     dirty_budget_rows: int | None = None, spill_dir=None):
    """Two-pass streaming aggregation: vocab/dirty scan, then one device
    pass (optionally row-sharded over a mesh's 'data' axis). Returns
    (filled full Triple, StreamFills, StreamSchema,
    DirtyCache | DirtySpill | None) — a DirtySpill when the dirty count
    exceeded `dirty_budget_rows` (bounded-memory high-missing regime)."""
    ss, cache = scan_schema(chunk_source, collect_dirty=collect_dirty,
                            dirty_budget_rows=dirty_budget_rows,
                            spill_dir=spill_dir)
    gram = scan_gram(chunk_source, ss, chunk_rows=chunk_rows, mesh=mesh)
    full, fills = assemble_filled_triple(gram, ss)
    return full, fills, ss, cache
