"""Fused lift+sum cofactor aggregation — the hot path.

Reference: the fused aggregate `sum_to_triple_x_y` (Triple::SumNoLift,
/root/reference/duckdb_extension/src/triple/sum/sum_no_lift.cpp:53-216) runs an
O(d²·rows) scalar FMA loop plus per-row hash-map upserts for the categorical
sections, merged across threads by SumStateCombine (sum_state.cpp:10-114).

Gram formulation: with the dense vocab layout the WHOLE triple is one
masked Gram matrix. Let

    Zᵀ = [1 | X_num | onehot(X_cat)]ᵀ  ∈ f32[P, n],  P = 1 + d + V
    S  = Zᵀ · diag(w) · Z              (w = row mask / weights)

Then S contains every section: N = S[0,0], lin = S[0,1:1+d],
quad = S[1:1+d,1:1+d], lin_cat = S[0,1+d:], num_cat = S[1:1+d,1+d:],
cat_cat = S[1+d:,1+d:] — one matrix product replaces the scalar loop, the
hash maps, and (because the mask is fused in) every `WHERE col_IS_NULL IS
FALSE` scan of the MICE driver (imputation_base.cpp:29,100).

LAYOUT: all feature arrays are COLUMN-MAJOR ("features-first"):
x_num f32[d, n], codes i32[c, n], weights f32[n] — the huge row axis is
minor and each column is one contiguous run, the analogue of columnar
storage.

`masked_sigma` (plain XLA) processes rows in static-size chunks via
lax.scan so Z is never materialized at full length; padding rows carry
mask 0 and contribute nothing. Accumulation is f32 with
`precision=HIGHEST` (parity with the reference's f32 accumulation; no
TF32 or bf16 rounding). The Pallas kernel `kernels/sigma_triton.py`
implements the same contract on the GPU; `backend.resolve_kernel` picks
between them.

Grouped aggregation (GROUP BY g — per-class triples for QDA/NB,
qda.cpp:27, sum_to_nb_agg.cpp:39) masks the weight vector per group and is
vmapped over the group axis: skewed groups cost nothing extra because every
group does the same dense work.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..backend import resolve_kernel
from ..schema import FeatureSchema
from .triple import NBAgg, Triple, triple_from_sigma

# Rows per scan chunk for the streaming Gram accumulation (XLA path).
DEFAULT_ROW_CHUNK = 1 << 17

# The sigma → Triple split as ONE dispatch instead of six eager slices,
# whose host time rivals the aggregation itself at 10M rows.
_split_sigma = jax.jit(triple_from_sigma, static_argnums=1)


def _as_f32(x):
    return jnp.asarray(x, jnp.float32)


def _normalize_inputs(x_num, codes, weights):
    """Accept None columns; return features-first arrays + n."""
    if x_num is not None:
        x_num = _as_f32(x_num)
        n = x_num.shape[-1]
    elif codes is not None:
        codes = jnp.asarray(codes, jnp.int32)
        n = codes.shape[-1]
    else:
        raise ValueError("need x_num or codes")
    if x_num is None:
        x_num = jnp.zeros((0, n), jnp.float32)
    if codes is None:
        codes = jnp.zeros((0, n), jnp.int32)
    codes = jnp.asarray(codes, jnp.int32)
    if weights is None:
        weights = jnp.ones((n,), jnp.float32)
    return x_num, codes, _as_f32(weights), n


def onehot_block_t(codes: jax.Array, schema: FeatureSchema) -> jax.Array:
    """Bᵀ = concatenated per-column one-hots, f32[V, n], from codes i32[c, n].

    A code outside [0, size_j) (vocab miss, the find_in_array convention)
    yields an all-zero column for that categorical column."""
    n = codes.shape[-1]
    parts = []
    for j, size in enumerate(schema.cat_sizes):
        cat_iota = jax.lax.broadcasted_iota(jnp.int32, (size, n), 0)
        parts.append((codes[j][None, :] == cat_iota).astype(jnp.float32))
    if not parts:
        return jnp.zeros((0, n), jnp.float32)
    return jnp.concatenate(parts, axis=0)


def _zt_block(x_num, codes, schema: FeatureSchema) -> jax.Array:
    """Zᵀ f32[P, n]."""
    n = x_num.shape[-1] if x_num.shape[0] else codes.shape[-1]
    rows = [jnp.ones((1, n), jnp.float32)]
    if schema.num_cols:
        rows.append(x_num)
    if schema.cat_cols:
        rows.append(onehot_block_t(codes, schema))
    return jnp.concatenate(rows, axis=0)


# Up to this vocab size the per-category select-sum is used, above it one
# jnp.take per column. The value is untuned on the GPU.
_SELECT_VOCAB_LIMIT = 64


def _cat_contrib(seg, code, size):
    """Σ_v seg[v]·[code == v] for one categorical column: the coefficient
    picked by the code row, 0 for out-of-vocab/negative codes (matching
    one_hot's all-zero row). seg f32[size] traced, code i32[n]."""
    if size <= _SELECT_VOCAB_LIMIT:
        acc = seg[0] * (code == 0).astype(seg.dtype)
        for v in range(1, size):
            acc = acc + seg[v] * (code == v).astype(seg.dtype)
        return acc
    padded = jnp.concatenate([seg, jnp.zeros((1,), seg.dtype)])
    safe = jnp.where(jnp.logical_and(code >= 0, code < size), code, size)
    return jnp.take(padded, safe, axis=0)


def linear_predict(theta, x_cols, code_cols, *, schema: FeatureSchema):
    """θ·Z without materializing Z: ŷ[r] = θ₀ + Σⱼ θ₁₊ⱼ x[j,r] +
    Σ_c θ[offs_c + code[c,r]] — direct arithmetic on the numeric columns
    plus a compare-select over each categorical column's (small) vocab.

    x_cols / code_cols are TUPLES of per-column [n] arrays (the columnar
    pytree layout — a stacked [d, n] block in a loop carry can force XLA
    to copy the whole table on every single-column write-back).

    Exact f32, and XLA fuses everything into ONE pass over the rows — the
    [P, n] one-hot feature block never exists, which makes the 100M-row
    MICE predict phase bandwidth-bound instead of 10× over it. Batched fix
    of the reference's row-at-a-time predict loops
    (regression.cpp:456-491, lda.cpp:511-577)."""
    d = schema.num_cols
    n = x_cols[0].shape[-1] if d else code_cols[0].shape[-1]
    pred = jnp.broadcast_to(theta[0], (n,))
    for j in range(d):
        pred = pred + theta[1 + j] * x_cols[j]
    offs = schema.offsets
    for cj, size in enumerate(schema.cat_sizes):
        seg = theta[1 + d + offs[cj]:1 + d + offs[cj + 1]]
        pred = pred + _cat_contrib(seg, code_cols[cj], size)
    return pred


def class_argmax(w_full, intercept, x_cols, code_cols, *,
                 schema: FeatureSchema):
    """argmax_k (WᵀZ + b)[k] without materializing Z or the [C, n] score
    block: classes are streamed with a running (best value, best index)
    pair, each class's score computed like linear_predict. W f32[P, C]
    (rows in sigma layout; excluded features = zero rows), b f32[C].
    Returns i32[n] class indices."""
    d = schema.num_cols
    n = x_cols[0].shape[-1] if d else code_cols[0].shape[-1]
    offs = schema.offsets
    c_out = w_full.shape[1]
    best_v = jnp.full((n,), -jnp.inf, jnp.float32)
    best_i = jnp.zeros((n,), jnp.int32)
    for k in range(c_out):
        s = jnp.broadcast_to(intercept[k] + w_full[0, k], (n,))
        for j in range(d):
            s = s + w_full[1 + j, k] * x_cols[j]
        for cj, size in enumerate(schema.cat_sizes):
            seg = w_full[1 + d + offs[cj]:1 + d + offs[cj + 1], k]
            s = s + _cat_contrib(seg, code_cols[cj], size)
        upd = s > best_v
        best_v = jnp.where(upd, s, best_v)
        best_i = jnp.where(upd, jnp.int32(k), best_i)
    return best_i


def _stack_cols(x_cols, code_cols, schema: FeatureSchema):
    """Tuples of per-column arrays -> the stacked features-first blocks the
    XLA sigma path consumes (the Gram kernel reads the tuples in place)."""
    n = (x_cols[0].shape[-1] if schema.num_cols
         else code_cols[0].shape[-1])
    x = (jnp.stack(x_cols) if schema.num_cols
         else jnp.zeros((0, n), jnp.float32))
    c = (jnp.stack(code_cols) if schema.cat_cols
         else jnp.zeros((0, n), jnp.int32))
    return x, c


def _scan_zeros(shape, like):
    """f32 zeros for a lax.scan carry that vary over the same shard_map
    mesh axes as the data `like` (outside shard_map: plain zeros), so the
    carry's type matches what the scan body returns."""
    zeros = jnp.zeros(shape, jnp.float32)
    vma = tuple(jax.typeof(like).vma)
    return jax.lax.pcast(zeros, vma, to="varying") if vma else zeros


def _pad_cols(arr, mult):
    n = arr.shape[-1]
    pad = (-n) % mult
    if pad == 0:
        return arr
    widths = [(0, 0)] * (arr.ndim - 1) + [(0, pad)]
    return jnp.pad(arr, widths)


@functools.partial(jax.jit, static_argnames=("schema", "row_chunk"))
def masked_sigma(x_num, codes, weights, *, schema: FeatureSchema,
                 row_chunk: int = DEFAULT_ROW_CHUNK) -> jax.Array:
    """S = Zᵀ diag(w) Z, f32[P, P], streaming over row chunks.

    x_num: f32[d, n] features-first; codes: i32[c, n]; weights: f32[n]."""
    x_num, codes, weights, n = _normalize_inputs(x_num, codes, weights)
    p = schema.sigma_size

    def gram(xn, cd, w):
        zt = _zt_block(xn, cd, schema)
        return jax.lax.dot_general(
            zt * w[None, :], zt, (((1,), (1,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32)

    if n <= row_chunk:
        return gram(x_num, codes, weights)

    x_num = _pad_cols(x_num, row_chunk)
    codes = _pad_cols(codes, row_chunk)
    weights = _pad_cols(weights, row_chunk)
    nc = x_num.shape[-1] // row_chunk
    xs = (x_num.reshape(x_num.shape[0], nc, row_chunk).swapaxes(0, 1),
          codes.reshape(codes.shape[0], nc, row_chunk).swapaxes(0, 1),
          weights.reshape(nc, row_chunk))

    def body(acc, chunk):
        xn, cd, w = chunk
        return acc + gram(xn, cd, w), None

    sigma, _ = jax.lax.scan(body, _scan_zeros((p, p), weights), xs)
    return sigma


def aggregate_sigma(x_num, codes, weights, *, schema: FeatureSchema,
                    kernel: str = "auto", interpret: bool = False,
                    row_chunk: int = DEFAULT_ROW_CHUNK) -> jax.Array:
    """S = Zᵀ diag(w) Z through the dispatched implementation
    (backend.resolve_kernel): the Gram kernel or masked_sigma. x_num /
    codes are stacked features-first arrays or per-column tuples."""
    kernel = resolve_kernel(kernel, schema.sigma_size, interpret=interpret)
    if kernel == "triton":
        from .kernels.sigma_triton import sigma_triton
        return sigma_triton(x_num, codes, weights, schema=schema,
                            interpret=interpret)
    if isinstance(x_num, (tuple, list)):
        x_num, codes = _stack_cols(x_num, codes, schema)
    return masked_sigma(x_num, codes, weights, schema=schema,
                        row_chunk=row_chunk)


def sum_to_triple(x_num=None, codes=None, weights=None, *,
                  schema: FeatureSchema,
                  row_chunk: int = DEFAULT_ROW_CHUNK,
                  backend: str = "auto", interpret: bool = False) -> Triple:
    """Fused lift+sum: the `sum_to_triple_x_y(cols…)` aggregate
    (Triple::SumNoLift, sum_no_lift.cpp:53-216).

    Args:
      x_num: f32[d, n] numeric columns, features-first (d may be 0 / None).
      codes: i32[c, n] LOCAL per-column category codes (FeatureSchema.encode).
      weights: f32[n] row weights; 0 = filtered out (fuses WHERE masks).
      backend: 'auto' | 'xla' | 'triton' (backend.resolve_kernel).
      interpret: run the Gram kernel in the Pallas interpreter."""
    x_num, codes, weights, _ = _normalize_inputs(x_num, codes, weights)
    sigma = aggregate_sigma(x_num, codes, weights, schema=schema,
                            kernel=backend, interpret=interpret,
                            row_chunk=row_chunk)
    return _split_sigma(sigma, schema.num_cols)


@functools.partial(jax.jit, static_argnames=("schema", "num_groups", "row_chunk"))
def _grouped_sigma(x_num, codes, weights, group_ids, *, schema: FeatureSchema,
                   num_groups: int, row_chunk: int) -> jax.Array:
    def one_group(g):
        w = weights * (group_ids == g).astype(jnp.float32)
        return masked_sigma(x_num, codes, w, schema=schema,
                            row_chunk=row_chunk)
    return jax.vmap(one_group)(jnp.arange(num_groups))


_GROUPED_METHODS = ("auto", "masked", "sorted")


def sum_to_triple_grouped(x_num, codes, group_ids, *, schema: FeatureSchema,
                          num_groups: int, weights=None,
                          row_chunk: int = DEFAULT_ROW_CHUNK,
                          method: str = "auto") -> Triple:
    """GROUP BY aggregation: one triple per group id in [0, num_groups).

    Replaces the reference's per-group hash-aggregation (DuckDB GROUP BY over
    SumState); per-class triples for QDA/LDA/NB come out of one data pass.
    Rows with group_ids outside [0, num_groups) are dropped.

    method:
      'masked' — per-group weight masks vmapped over groups: G full passes
        over the data (cheap for small G, skew-immune, fully jittable).
      'sorted' — counting-sort rows by group id (host), then one
        contiguous-segment Gram per group: TOTAL work is a single data pass
        regardless of G — the hash-aggregation analogue. Skew-immune too:
        a hot key just owns a longer contiguous range.
      'auto' — sorted for large n·G (G > 2), masked otherwise."""
    x_num, codes, weights, n = _normalize_inputs(x_num, codes, weights)
    if method not in _GROUPED_METHODS:
        raise ValueError(f"unknown grouped method {method!r}; valid choices "
                         f"are {', '.join(map(repr, _GROUPED_METHODS))}")
    if method == "auto":
        method = "sorted" if (n * num_groups >= (1 << 22)
                              and num_groups > 2) else "masked"
    if method == "sorted":
        g = np.asarray(jax.device_get(jnp.asarray(group_ids)))
        order = np.argsort(g, kind="stable")
        # out-of-range ids are DROPPED (same contract as the masked path):
        # after the sort, negatives sit before segment 0 and ids >= G after
        # the last segment, so offsetting the segment starts by the negative
        # count excludes both.
        valid = (g >= 0) & (g < num_groups)
        counts = np.bincount(g[valid], minlength=num_groups)
        ends = int((g < 0).sum()) + np.cumsum(counts)
        starts = ends - counts
        jord = jnp.asarray(order)
        xs = x_num[:, jord]
        cs = codes[:, jord]
        ws = weights[jord]
        sigmas = []
        for gidx in range(num_groups):
            lo, hi = int(starts[gidx]), int(ends[gidx])
            if hi == lo:
                sigmas.append(jnp.zeros((schema.sigma_size,) * 2, jnp.float32))
                continue
            # bucket segment length to the next power of two (zero-weight
            # pad) so the number of distinct compiled shapes stays O(log n)
            size = hi - lo
            bucket = 1 << (size - 1).bit_length()
            pad = bucket - size
            xg = jnp.pad(xs[:, lo:hi], ((0, 0), (0, pad)))
            cg = jnp.pad(cs[:, lo:hi], ((0, 0), (0, pad)))
            wg = jnp.pad(ws[lo:hi], (0, pad))
            sigmas.append(masked_sigma(xg, cg, wg, schema=schema,
                                       row_chunk=row_chunk))
        sigma = jnp.stack(sigmas)
    else:
        sigma = _grouped_sigma(x_num, codes, weights,
                               jnp.asarray(group_ids), schema=schema,
                               num_groups=num_groups, row_chunk=row_chunk)
    return _split_sigma(sigma, schema.num_cols)


# ---------------------------------------------------------------------------
# Lift (to_cofactor): per-row degree-1 triples
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("schema",))
def lift(x_num=None, codes=None, *, schema: FeatureSchema) -> Triple:
    """`to_cofactor(cols…)` (Triple::CustomLift, lift.cpp:15-243): each row
    becomes a degree-1 triple (N=1, lin=x, quad=x xᵀ, singleton cat maps).
    Returns a batched Triple with leading axis n."""
    x_num, codes, _, n = _normalize_inputs(x_num, codes, None)
    x = x_num.T                                   # [n, d] — small per-row math
    b = onehot_block_t(codes, schema).T           # [n, V]
    return Triple(
        n=jnp.ones((n,), jnp.float32),
        lin=x,
        quad=jnp.einsum("ni,nj->nij", x, x),
        lin_cat=b,
        num_cat=jnp.einsum("ni,nv->niv", x, b),
        cat_cat=jnp.einsum("nu,nv->nuv", b, b),
    )


def sum_triples(t: Triple, axis: int = 0) -> Triple:
    """`sum_triple(triple)` over pre-lifted triples (Triple::Sum,
    sum.cpp:57-261): reduce a batched triple along `axis`."""
    return jax.tree.map(lambda x: jnp.sum(x, axis=axis), t)


# ---------------------------------------------------------------------------
# Naive-Bayes aggregate variants
# ---------------------------------------------------------------------------

def _nb_feature_block(xn, cd, schema: FeatureSchema) -> jax.Array:
    """F = [1 ‖ x ‖ x² ‖ onehot(codes)]ᵀ, f32[1+2d+V, chunk] — every NB
    aggregate section as one stacked feature matrix."""
    n = xn.shape[-1] if xn.shape[0] else cd.shape[-1]
    rows = [jnp.ones((1, n), jnp.float32)]
    if schema.num_cols:
        rows.append(xn)
        rows.append(xn * xn)
    if schema.cat_cols:
        rows.append(onehot_block_t(cd, schema))
    return jnp.concatenate(rows, axis=0)


@functools.partial(jax.jit, static_argnames=("schema", "num_groups",
                                             "row_chunk"))
def _nb_sums(x_num, codes, weights, group_ids, *, schema: FeatureSchema,
             num_groups: int, row_chunk: int) -> jax.Array:
    """Per-group NB sums as ONE segment-sum matmul: F[1+2d+V, n] @ Wᵀ[n, G]
    — a single data pass for any number of groups (the grouped
    hash aggregation of sum_to_nb_agg.cpp:39-146 / GROUP BY label). The
    feature block, one-hot expansion, and the [G, chunk] group mask are all
    built per row chunk so nothing wider than the raw columns touches HBM:
    the pass is bandwidth-bound on the inputs alone."""
    n = weights.shape[-1]
    gi = jax.lax.broadcasted_iota(jnp.int32, (num_groups, 1), 0)

    def part(xn, cd, w, g):
        feats = _nb_feature_block(xn, cd, schema)
        wmat = (g[None, :] == gi).astype(jnp.float32) * w[None, :]
        return jax.lax.dot_general(
            feats, wmat, (((1,), (1,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32)

    if n <= row_chunk:
        return part(x_num, codes, weights, group_ids)
    x_num = _pad_cols(x_num, row_chunk)
    codes = _pad_cols(codes, row_chunk)
    weights = _pad_cols(weights, row_chunk)
    # pad with an out-of-range group id so padded rows hit no group
    gpad = jnp.full(((-n) % row_chunk,), num_groups, jnp.int32)
    group_ids = jnp.concatenate([jnp.asarray(group_ids, jnp.int32), gpad])
    nc = x_num.shape[-1] // row_chunk
    xs = (x_num.reshape(x_num.shape[0], nc, row_chunk).swapaxes(0, 1),
          codes.reshape(codes.shape[0], nc, row_chunk).swapaxes(0, 1),
          weights.reshape(nc, row_chunk),
          group_ids.reshape(nc, row_chunk))

    def body(acc, chunk):
        xn, cd, w, g = chunk
        return acc + part(xn, cd, w, g), None

    f = 1 + 2 * schema.num_cols + schema.vocab_size
    out, _ = jax.lax.scan(body, _scan_zeros((f, num_groups), weights), xs)
    return out


def _nb_from_sums(sums: jax.Array, schema: FeatureSchema, squeeze: bool
                  ) -> NBAgg:
    d = schema.num_cols
    if squeeze:
        sums = sums[:, 0]
        return NBAgg(n=sums[0], lin=sums[1:1 + d],
                     quad_diag=sums[1 + d:1 + 2 * d],
                     lin_cat=sums[1 + 2 * d:])
    g = sums.T  # [G, F]
    return NBAgg(n=g[:, 0], lin=g[:, 1:1 + d],
                 quad_diag=g[:, 1 + d:1 + 2 * d],
                 lin_cat=g[:, 1 + 2 * d:])


@functools.partial(jax.jit, static_argnames=("schema", "row_chunk"))
def _sum_to_nb_agg_xla(x_num=None, codes=None, weights=None, *,
                       schema: FeatureSchema,
                       row_chunk: int = DEFAULT_ROW_CHUNK) -> NBAgg:
    x_num, codes, weights, n = _normalize_inputs(x_num, codes, weights)
    sums = _nb_sums(x_num, codes, weights, jnp.zeros((n,), jnp.int32),
                    schema=schema, num_groups=1, row_chunk=row_chunk)
    return _nb_from_sums(sums, schema, squeeze=True)


def _check_nb_backend(backend: str) -> None:
    if backend not in ("auto", "xla"):
        raise ValueError(f"unknown NB aggregation backend {backend!r}; "
                         f"valid choices are 'auto', 'xla'")


def sum_to_nb_agg(x_num=None, codes=None, weights=None, *,
                  schema: FeatureSchema,
                  row_chunk: int = DEFAULT_ROW_CHUNK,
                  backend: str = "auto") -> NBAgg:
    """Fused NB aggregate `sum_to_nb_agg_x_y(cols…)` (Triple::sum_to_nb_agg,
    sum/sum_to_nb_agg.cpp:39-146): lin + diagonal quad + category counts.
    One data pass (the G=1 case of the segment-sum matmul).
    backend: 'auto' | 'xla' (both the XLA path)."""
    _check_nb_backend(backend)
    return _sum_to_nb_agg_xla(x_num, codes, weights, schema=schema,
                              row_chunk=row_chunk)


@functools.partial(jax.jit, static_argnames=("schema", "num_groups",
                                             "row_chunk"))
def _sum_to_nb_agg_grouped_xla(x_num, codes, group_ids, *,
                               schema: FeatureSchema, num_groups: int,
                               weights=None,
                               row_chunk: int = DEFAULT_ROW_CHUNK) -> NBAgg:
    x_num, codes, weights, n = _normalize_inputs(x_num, codes, weights)
    sums = _nb_sums(x_num, codes, weights,
                    jnp.asarray(group_ids, jnp.int32), schema=schema,
                    num_groups=num_groups, row_chunk=row_chunk)
    return _nb_from_sums(sums, schema, squeeze=False)


def sum_to_nb_agg_grouped(x_num, codes, group_ids, *, schema: FeatureSchema,
                          num_groups: int, weights=None,
                          row_chunk: int = DEFAULT_ROW_CHUNK,
                          backend: str = "auto") -> NBAgg:
    """Grouped NB aggregate — one NBAgg per group (GROUP BY label) in a
    single data pass: the group masks form W[G, n] and all sections fall
    out of one F @ Wᵀ matmul. Skew-immune by construction (a hot label is
    just a denser column of W). backend: 'auto' | 'xla'."""
    _check_nb_backend(backend)
    return _sum_to_nb_agg_grouped_xla(
        x_num, codes, group_ids, schema=schema, num_groups=num_groups,
        weights=weights, row_chunk=row_chunk)


@functools.partial(jax.jit, static_argnames=("schema",))
def nb_lift(x_num=None, codes=None, *, schema: FeatureSchema) -> NBAgg:
    """`to_nb_agg(cols…)` (Triple::to_nb_lift, lift_to_nb_agg.cpp:13-136)."""
    x_num, codes, _, n = _normalize_inputs(x_num, codes, None)
    x = x_num.T
    b = onehot_block_t(codes, schema).T
    return NBAgg(n=jnp.ones((n,), jnp.float32), lin=x, quad_diag=x * x,
                 lin_cat=b)


def sum_nb_aggs(t: NBAgg, axis: int = 0) -> NBAgg:
    """`sum_nb_agg(agg)` (Triple::sum_nb_agg, sum/sum_nb_agg.cpp:45-175)."""
    return jax.tree.map(lambda x: jnp.sum(x, axis=axis), t)


# Backwards-compat name (row-major one-hot used by a few callers/tests).
def onehot_block(codes_rowmajor: jax.Array, schema: FeatureSchema) -> jax.Array:
    """B f32[n, V] from row-major codes i32[n, c] (convenience for predict
    paths and tests; the aggregation path uses onehot_block_t)."""
    return onehot_block_t(jnp.asarray(codes_rowmajor).T, schema).T
