"""Multi-dimension star-join factorized aggregation.

The reference composes factorized joins by chaining `multiply_triple` over a
SHARED join key (README.md:163-174; mul.cpp:19-611) — it has no mechanism
for a star schema where the fact table references SEVERAL dimension tables
through DIFFERENT keys (the flight/retailer experiments its dead headers
point at, imputation/include/factorized_imputation_*.h). This module closes
that: the cofactor triple of

    fact ⋈_{k1} dim_1 ⋈_{k2} dim_2 ⋈ …      (FK → unique-PK joins)

is computed from per-key aggregates and pure matrix contractions, never
materializing the join. The algebra: let E_i = [num_i ‖ onehot(cat_i)] be
dimension i's per-key feature matrix (K_i × m_i), w the row mask, and

    R_i[k]  = Σ_{rows r with k_i(r)=k} w_r · [1, x_f(r), onehot(c_f(r))]
              (per-key grouped fact sigma ROW — n, lin, lin_cat; one
              segment-sum pass per dimension)
    C_ij[k,l] = Σ_r w_r · 1[k_i(r)=k] 1[k_j(r)=l]
              (key co-occurrence matrix; one segment-sum pass per pair)

then every block of the joined sigma matrix is a contraction:

    fact  × fact   = masked fact sigma                (existing kernel)
    fact  × dim_i  = R_iᵀ E_i
    dim_i × dim_i  = E_iᵀ diag(R_i[:,0]) E_i
    dim_i × dim_j  = E_iᵀ C_ij E_j

Cost: O(n) segment-sums + O(K²·m) matmuls — independent of join fan-out.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..schema import FeatureSchema
from .sum import DEFAULT_ROW_CHUNK, _zt_block, masked_sigma
from .triple import Triple, triple_from_sigma

# key spaces up to this size aggregate via chunk-scanned one-hot matmuls
# (O(n·K) FLOPs, where dense matmul throughput beats scatter-adds); larger
# key spaces fall back to segment-sums. The value is untuned on the GPU.
ONEHOT_KEY_LIMIT = 8192


def _dim_features(x_num, codes, schema: FeatureSchema) -> jax.Array:
    """E = [num ‖ onehot(cats)] per key, f32[K, d + V]."""
    k = x_num.shape[-1] if x_num is not None else codes.shape[-1]
    parts = []
    if schema.num_cols:
        parts.append(x_num.T)
    for j in range(schema.cat_cols):
        parts.append(jax.nn.one_hot(codes[j], schema.cat_sizes[j],
                                    dtype=jnp.float32))
    if not parts:
        return jnp.ones((k, 0), jnp.float32)
    return jnp.concatenate(parts, axis=1)


def _chunked(n: int, row_chunk: int) -> tuple[int, int]:
    m = min(row_chunk, max(n, 1))
    nc = -(-n // m)
    return nc, m


def _scan_chunks(arrs, n: int, m: int, nc: int, init, step):
    """Zero-pad row arrays to nc*m, reshape to [nc, …, m], lax.scan `step`."""
    def pad(a):
        p = nc * m - n
        if p:
            a = jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, p)])
        return jnp.moveaxis(a.reshape(a.shape[:-1] + (nc, m)), -2, 0)
    out, _ = jax.lax.scan(step, init, tuple(pad(a) for a in arrs))
    return out


def _grouped_sigma_row(x_num, codes, weights, keys, *, num_keys: int,
                       schema: FeatureSchema,
                       row_chunk: int = DEFAULT_ROW_CHUNK) -> jax.Array:
    """R[k] = per-key weighted sums of the fact sigma row
    [1 ‖ x_num ‖ onehot(cats)], f32[K, 1 + d + V].

    Matmul path (K ≤ ONEHOT_KEY_LIMIT): R = Σ_chunks OH_k (diag(w) Z)ᵀ — the
    one-hot key matrix is exact in bf16, the f32 feature operand runs at
    HIGHEST precision, so accuracy matches the segment-sum path. Large key
    spaces use combined-key segment-sums instead."""
    if num_keys <= ONEHOT_KEY_LIMIT:
        n = weights.shape[-1]
        nc, m = _chunked(n, row_chunk)
        p = schema.sigma_size
        kidx = jnp.arange(num_keys, dtype=keys.dtype)[:, None]

        def step(acc, chunk):
            xn, cd, w, k = chunk
            zt = _zt_block(xn, cd, schema) * w[None, :]       # [P, m]
            oh = (k[None, :] == kidx).astype(jnp.float32)     # [K, m]
            return acc + jax.lax.dot_general(
                oh, zt, (((1,), (1,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST), None

        return _scan_chunks((x_num, codes, weights, keys), n, m, nc,
                            jnp.zeros((num_keys, p), jnp.float32), step)

    seg = functools.partial(jax.ops.segment_sum, num_segments=num_keys)
    n_k = seg(weights, keys)[:, None]                       # [K, 1]
    parts = [n_k]
    if schema.num_cols:
        parts.append(seg((weights[None, :] * x_num).T, keys))  # [K, d]
    for j in range(schema.cat_cols):
        sz = schema.cat_sizes[j]
        # combined (key, code) segment-sum; out-of-vocab codes (== sz) are
        # accumulated into a discard slot
        flat = keys * (sz + 1) + jnp.minimum(codes[j], sz)
        lc = jax.ops.segment_sum(weights, flat,
                                 num_segments=num_keys * (sz + 1))
        parts.append(lc.reshape(num_keys, sz + 1)[:, :sz])
    return jnp.concatenate(parts, axis=1)


def _cooccurrence(weights, ki, kj, num_i: int, num_j: int,
                  row_chunk: int = DEFAULT_ROW_CHUNK) -> jax.Array:
    """C[k,l] = Σ w over rows with (ki, kj) = (k, l), f32[K_i, K_j].

    Matmul path: C = Σ_chunks OH_i diag(w) OH_jᵀ — both operands are binary
    (exact in bf16) and the accumulation is f32, so the counts are EXACT
    at single-pass bf16 speed."""
    if num_i * num_j <= ONEHOT_KEY_LIMIT ** 2 and \
            max(num_i, num_j) <= ONEHOT_KEY_LIMIT:
        n = weights.shape[-1]
        nc, m = _chunked(n, row_chunk)
        ii = jnp.arange(num_i, dtype=ki.dtype)[:, None]
        jj = jnp.arange(num_j, dtype=kj.dtype)[:, None]

        def step(acc, chunk):
            w, a, b = chunk
            ohi = ((a[None, :] == ii).astype(jnp.bfloat16)
                   * w[None, :].astype(jnp.bfloat16))
            ohj = (b[None, :] == jj).astype(jnp.bfloat16)
            return acc + jax.lax.dot_general(
                ohi, ohj, (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32), None

        return _scan_chunks((weights, ki, kj), n, m, nc,
                            jnp.zeros((num_i, num_j), jnp.float32), step)
    flat = ki * num_j + kj
    return jax.ops.segment_sum(
        weights, flat, num_segments=num_i * num_j).reshape(num_i, num_j)


def _star_aggregates(x_f, c_f, weights, keys, *, num_keys, schema,
                     row_chunk: int = DEFAULT_ROW_CHUNK):
    """All per-key aggregates of the star join in ONE chunk scan:
    R_i = OH_i (diag(w) Z)ᵀ (HIGHEST precision — f32-exact features) and
    C_ij = OH_i diag(w) OH_jᵀ (single-pass bf16 — EXACT for the binary
    one-hots and 0/1 masks the MICE drivers pass; arbitrary weights round
    to bf16). One-hot key matrices are built once per chunk and feed both."""
    nd = len(num_keys)
    n = weights.shape[-1]
    nc, m = _chunked(n, row_chunk)
    kidx = [jnp.arange(num_keys[i], dtype=jnp.int32)[:, None]
            for i in range(nd)]
    p = schema.sigma_size

    def step(carry, chunk):
        rs, cs = carry
        xn, cd, w, ks = chunk
        zt = _zt_block(xn, cd, schema) * w[None, :]           # [P, m]
        ohs = [(ks[i][None, :] == kidx[i]).astype(jnp.float32)
               for i in range(nd)]                            # [K_i, m]
        rs = tuple(
            r + jax.lax.dot_general(
                oh, zt, (((1,), (1,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST)
            for r, oh in zip(rs, ohs))
        new_cs = {}
        for (i, j), c in cs.items():
            wi = (ohs[i] * w[None, :]).astype(jnp.bfloat16)
            new_cs[(i, j)] = c + jax.lax.dot_general(
                wi, ohs[j].astype(jnp.bfloat16),
                (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32)
        return (rs, new_cs), None

    init = (tuple(jnp.zeros((num_keys[i], p), jnp.float32)
                  for i in range(nd)),
            {(i, j): jnp.zeros((num_keys[i], num_keys[j]), jnp.float32)
             for i in range(nd) for j in range(i + 1, nd)})
    (rs, cs) = _scan_chunks((x_f, c_f, weights, keys), n, m, nc, init, step)
    return list(rs), cs


def star_schema(fact_schema: FeatureSchema,
                dim_schemas: list[FeatureSchema]) -> FeatureSchema:
    """Joined schema: [fact nums ‖ dim nums…], [fact cats ‖ dim cats…]
    (the multiply concatenation order, mul.cpp:97-107, extended n-way)."""
    s = fact_schema
    for ds in dim_schemas:
        s = s.concat(ds)
    return s


@functools.partial(jax.jit, static_argnames=(
    "fact_schema", "dim_schemas", "num_keys", "row_chunk"))
def star_join_sigma(x_f, c_f, weights, keys, dim_num, dim_codes, *,
                    fact_schema: FeatureSchema,
                    dim_schemas: tuple[FeatureSchema, ...],
                    num_keys: tuple[int, ...],
                    row_chunk: int = DEFAULT_ROW_CHUNK) -> jax.Array:
    """Dense sigma matrix of the star join, f32[P, P] with
    P = 1 + D + V over the joined schema.

    x_f: f32[d_f, n]; c_f: i32[c_f, n]; weights: f32[n];
    keys: i32[n_dims, n] — per-dimension FK codes;
    dim_num[i]: f32[d_i, K_i] ordered by key; dim_codes[i]: i32[c_i, K_i].
    """
    nd = len(dim_schemas)
    ff = masked_sigma(x_f, c_f, weights, schema=fact_schema,
                      row_chunk=row_chunk)                   # [Pf, Pf]
    E = [_dim_features(dim_num[i], dim_codes[i], dim_schemas[i])
         for i in range(nd)]                                 # [K_i, m_i]
    if max(num_keys) <= ONEHOT_KEY_LIMIT:
        # one fused scan: each dimension's one-hot built once per chunk,
        # all R_i and C_ij accumulated together
        R, C = _star_aggregates(x_f, c_f, weights, keys,
                                num_keys=num_keys, schema=fact_schema,
                                row_chunk=row_chunk)
    else:
        R = [_grouped_sigma_row(x_f, c_f, weights, keys[i],
                                num_keys=num_keys[i], schema=fact_schema,
                                row_chunk=row_chunk)
             for i in range(nd)]                             # [K_i, Pf]
        C = {(i, j): _cooccurrence(weights, keys[i], keys[j],
                                   num_keys[i], num_keys[j],
                                   row_chunk=row_chunk)
             for i in range(nd) for j in range(i + 1, nd)}

    hp = jax.lax.Precision.HIGHEST
    mm = functools.partial(jnp.matmul, precision=hp)
    # assembled in [fact-block ‖ dim_1 ‖ dim_2 ‖ …] order, permuted after
    rows = [jnp.concatenate([ff] + [mm(R[i].T, E[i]) for i in range(nd)],
                            axis=1)]
    for i in range(nd):
        blocks = [mm(R[i].T, E[i]).T]                        # fact × dim_i ᵀ
        for j in range(nd):
            if j == i:
                blocks.append(mm(E[i].T * R[i][:, 0][None, :], E[i]))
            elif j > i:
                blocks.append(mm(mm(E[i].T, C[(i, j)]), E[j]))
            else:
                blocks.append(mm(mm(E[i].T, C[(j, i)].T), E[j]))
        rows.append(jnp.concatenate(blocks, axis=1))
    big = jnp.concatenate(rows, axis=0)

    # permute [1, f-num, f-cat, d1-num, d1-cat, …] → [1, nums…, cats…]
    perm = _star_permutation(fact_schema, dim_schemas)
    return big[jnp.asarray(perm)][:, jnp.asarray(perm)]


def _star_permutation(fs: FeatureSchema,
                      dss: tuple[FeatureSchema, ...]) -> np.ndarray:
    """Index map from the assembled block order to the joined-schema sigma
    order [1 | all nums | all vocabs]."""
    starts = []
    off = 0
    blocks = [(1, fs.num_cols, fs.vocab_size)]
    for ds in dss:
        blocks.append((0, ds.num_cols, ds.vocab_size))
    num_idx, cat_idx = [], []
    const_idx = []
    for (c, d, v) in blocks:
        if c:
            const_idx.append(off)
        num_idx.extend(range(off + c, off + c + d))
        cat_idx.extend(range(off + c + d, off + c + d + v))
        off += c + d + v
    return np.asarray(const_idx + num_idx + cat_idx, dtype=np.int64)


def star_join_triple(x_f=None, c_f=None, weights=None, keys=(), dims=(), *,
                     fact_schema: FeatureSchema,
                     dim_schemas,
                     num_keys=None,
                     row_chunk: int = DEFAULT_ROW_CHUNK) -> Triple:
    """Cofactor triple of `fact ⋈ dim_1 ⋈ …` (see module docstring).

    keys: per dimension, i32[n] FK codes into [0, K_i).
    dims: per dimension, (x_num f32[d_i, K_i], codes i32[c_i, K_i]) ordered
      by key (row k <-> key k).
    weights: f32[n] row weights. PRECISION: for binary weights (0/1 masks —
      what every MICE driver passes) all co-occurrence counts C_ij are EXACT
      (binary one-hots and masks are bf16-exact; accumulation is f32). A
      NON-binary weight is rounded to bf16 inside the ≤ONEHOT_KEY_LIMIT
      matmul co-occurrence path, while the >limit fallback uses exact f32
      segment-sums — path-dependent precision. Pre-scale or use the
      segment-sum path (num_keys > ONEHOT_KEY_LIMIT) if bf16 weight
      rounding matters.
    Returns the triple over `star_schema(fact_schema, dim_schemas)`.
    """
    dim_schemas = tuple(dim_schemas)
    n = (x_f.shape[-1] if x_f is not None else c_f.shape[-1])
    if x_f is None:
        x_f = np.zeros((0, n), np.float32)
    if c_f is None:
        c_f = np.zeros((0, n), np.int32)
    if weights is None:
        weights = np.ones((n,), np.float32)
    if num_keys is None:
        num_keys = tuple(d[0].shape[-1] if d[0] is not None
                         else d[1].shape[-1] for d in dims)
    dim_num = tuple(
        jnp.asarray(d[0], jnp.float32) if d[0] is not None
        else jnp.zeros((0, k), jnp.float32)
        for d, k in zip(dims, num_keys))
    dim_codes = tuple(
        jnp.asarray(d[1], jnp.int32) if d[1] is not None
        else jnp.zeros((0, k), jnp.int32)
        for d, k in zip(dims, num_keys))
    sigma = star_join_sigma(
        jnp.asarray(x_f, jnp.float32), jnp.asarray(c_f, jnp.int32),
        jnp.asarray(weights, jnp.float32),
        jnp.asarray(np.stack([np.asarray(k, np.int32) for k in keys], 0)),
        dim_num, dim_codes,
        fact_schema=fact_schema, dim_schemas=dim_schemas,
        num_keys=tuple(int(k) for k in num_keys), row_chunk=row_chunk)
    js = star_schema(fact_schema, list(dim_schemas))
    return triple_from_sigma(sigma, js.num_cols)
