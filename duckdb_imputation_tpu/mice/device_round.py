"""Fully on-device MICE rounds — one jit per round (or per run).

The host-driven drivers (baseline/low/high) mirror the reference's
client↔engine round trips (imputation_base.cpp: one SQL query per phase).
Every dispatch costs host latency, so the production path fuses the
ENTIRE round — for every null column: masked cofactor aggregation → train →
batched predict → masked write-back — into one compiled program
(`mice_round_device`), and `run_mice_device` runs all rounds inside a single
lax.fori_loop: the whole MICE loop is ONE dispatch.

COLUMNAR CARRY: inside the loops the table is a TUPLE of per-column [n]
arrays, not a stacked [d, n] block (SURVEY §7.1's "pytree of device arrays,
one per column", taken literally). A stacked block in a lax loop carry
makes every single-column write-back a dynamic-update-slice of the whole
block, which XLA cannot always keep in place. The Gram kernel
(ring/kernels/sigma_triton.py) reads the tuples in place; the XLA
aggregation stacks them first.

Training inside jit:
  * continuous columns: a direct normal-equations lstsq on the P×P sigma
    (trainer='solve', default) or the reference's GD loop as lax.while_loop
    (trainer='gd', models/device.linreg_train_device);
  * categorical columns: device LDA — label-excluded sigma gathers (static
    index sets), class sums pulled from the triple's own categorical
    sections, pooled covariance + shrinkage, lstsq solve (SVD-backed,
    jittable), argmax predict. f32 on-device (the host f64 trainers remain
    the parity reference).

Prediction never materializes the [P, n] feature block: numeric
contributions are direct multiply-adds on the column arrays and
categorical contributions compare-select against each (small) vocab
(ring.sum.linear_predict / class_argmax) — one fused bandwidth-bound pass
over the rows, the batched fix of the reference's row-at-a-time predict
loops (regression.cpp:456-491, lda.cpp:511-577).

Noise for stochastic regression uses a per-(round, column) fold of the
PRNG key.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..schema import FeatureSchema
from ..backend import resolve_kernel
from ..ring.sum import aggregate_sigma, class_argmax, linear_predict
from ..models.device import linreg_solve_device, linreg_train_device
from ..table.table import Table


def _row_noise(key, gidx):
    """Standard normals keyed by GLOBAL row index — counter-based: each
    row's draw is a pure function of (key, global index), so stochastic
    MICE results are identical for any device count, shard layout, or
    predict chunking. Replacement for the reference's
    /dev/urandom-seeded Box-Muller stream (regression.cpp:377-395,493-504),
    which is not reproducible at all."""
    return jax.vmap(
        lambda j: jax.random.normal(jax.random.fold_in(key, j)))(gidx)


def _lda_device(sigma: jax.Array, schema: FeatureSchema, label: int,
                shrinkage: float):
    """Device LDA from the full sigma: returns (W [m, C], intercept [C],
    keep_idx) where features = [num cols ‖ non-label one-hot]."""
    d = schema.num_cols
    offs = schema.offsets
    lab_lo = 1 + d + offs[label]
    lab_hi = 1 + d + offs[label + 1]
    keep = np.asarray(
        [i for i in range(schema.sigma_size)
         if not (lab_lo <= i < lab_hi)], np.int32)
    sig = sigma[jnp.ix_(jnp.asarray(keep), jnp.asarray(keep))]
    n_total = sigma[0, 0]

    # class sums from the label block rows (the factorized GROUP BY label)
    sums = sigma[lab_lo:lab_hi][:, jnp.asarray(keep)]       # [C, P']
    counts = sums[:, 0]                                      # [C]
    # zero-count class guard: clamp the divisor (zero mean / no scatter
    # contribution) and keep log(0) = -inf so argmax never predicts the
    # class — matches host lda_train (see models/lda.py)
    cnt = jnp.maximum(counts, 1.0)

    m = len(keep) - 1
    cov = sig[1:, 1:]
    mean_c = sums[:, 1:] / cnt[:, None]                      # [C, m]
    # full-f32 products: the scatter is a difference of large sums, and a
    # GPU f32 dot at default precision rounds its inputs to TF32
    with jax.default_matmul_precision("highest"):
        cov = cov - jnp.einsum("ci,cj->ij",
                               sums[:, 1:] / jnp.sqrt(cnt)[:, None],
                               sums[:, 1:] / jnp.sqrt(cnt)[:, None])
        mu = jnp.trace(cov) / m
        cov = cov * (1.0 - shrinkage) + shrinkage * mu * jnp.eye(m)
        cov = cov / n_total
        w = jnp.linalg.lstsq(cov, mean_c.T)[0]               # [m, C]
        intercept = (-0.5 * jnp.einsum("cm,mc->c", mean_c, w)
                     + jnp.log(counts / n_total))
    return w, intercept, keep


def _w_full(w, keep, schema: FeatureSchema):
    """Scatter LDA coefficients back to full sigma layout: excluded rows
    (ones + the label's own one-hot block) get zero coefficients, so the
    fused predict never needs a keep-index view of the features."""
    return jnp.zeros((schema.sigma_size, w.shape[1]),
                     w.dtype).at[jnp.asarray(keep[1:])].set(w)


def _round_columns(x_cols, code_cols, num_null, cat_null, *,
                   schema: FeatureSchema,
                   num_cols_to_impute: tuple[int, ...],
                   cat_cols_to_impute: tuple[int, ...],
                   agg, gd_iters: int, lda_shrinkage: float,
                   noise_key_for, trainer: str = "solve", row_offset=0):
    """One MICE round's per-column body, shared by the single-device and
    sharded loops. x_cols/code_cols are TUPLES of per-column [n] arrays
    (see module docstring). `agg(x_cols, code_cols, null_row) -> sigma`
    abstracts how the aggregate is produced (device-local kernel vs
    psum-combined shard_map); `noise_key_for(col) -> key | None` abstracts
    the noise keying (None ⇒ deterministic prediction); `row_offset` is
    this shard's global row offset so noise draws are keyed by GLOBAL row
    index (mesh-shape invariant). Categorical columns first — the
    reference's ordering (imputation_base.cpp:18-87).

    trainer: 'solve' (default) — ONE lstsq on the P×P sigma per column;
    'gd' — the reference's sequential GD (regression.cpp:157-238) as a
    lax.while_loop, kept for iteration-parity studies. The GD path is
    hundreds of dependent tiny matvecs, so the direct solve is the
    production trainer."""
    x_cols = tuple(x_cols)
    code_cols = tuple(code_cols)
    for col in cat_cols_to_impute:
        sigma = agg(x_cols, code_cols, cat_null[col])
        w, intercept, keep = _lda_device(sigma, schema, col, lda_shrinkage)
        pred = class_argmax(_w_full(w, keep, schema), intercept,
                            x_cols, code_cols, schema=schema)
        old = code_cols[col]
        new = jnp.where(cat_null[col], pred.astype(old.dtype), old)
        code_cols = code_cols[:col] + (new,) + code_cols[col + 1:]

    for col in num_cols_to_impute:
        sigma = agg(x_cols, code_cols, num_null[col])
        if trainer == "solve":
            coeff = linreg_solve_device(sigma, label=col + 1)
        else:
            coeff = linreg_train_device(sigma, label=col + 1,
                                        max_iters=gd_iters)
        theta = coeff * (1.0 - jax.nn.one_hot(col + 1, coeff.shape[0],
                                              dtype=coeff.dtype))
        pred = linear_predict(theta, x_cols, code_cols, schema=schema)
        nkey = noise_key_for(col)
        if nkey is not None:
            theta_full = coeff.at[col + 1].set(-1.0)
            var = (_quad_form(theta_full, sigma)
                   / jnp.maximum(sigma[0, 0], 1.0))
            std = jnp.sqrt(jnp.maximum(var, 0.0))
            gidx = row_offset + jnp.arange(pred.shape[0])
            pred = pred + std * _row_noise(nkey, gidx)
        old = x_cols[col]
        new = jnp.where(num_null[col], pred, old)
        x_cols = x_cols[:col] + (new,) + x_cols[col + 1:]

    return x_cols, code_cols


def _quad_form(theta, sigma):
    """θᵀΣθ in full f32: the residual variance θᵀΣθ/N is a small
    difference of large sums, which TF32 inputs would swamp."""
    hi = jax.lax.Precision.HIGHEST
    return jnp.dot(theta, jnp.dot(sigma, theta, precision=hi), precision=hi)


def _make_agg(kernel: str, schema: FeatureSchema, interpret: bool = False):
    """(x_cols, code_cols, null_row) → masked sigma via the resolved
    kernel ('xla' | 'triton'), fed by the per-column tuples."""
    def agg(x_cols, code_cols, null_row):
        return aggregate_sigma(x_cols, code_cols,
                               1.0 - null_row.astype(jnp.float32),
                               schema=schema, kernel=kernel,
                               interpret=interpret)
    return agg


def _to_cols(x_num, codes, schema: FeatureSchema):
    return (tuple(x_num[j] for j in range(schema.num_cols)),
            tuple(codes[j] for j in range(schema.cat_cols)))


def _from_cols(x_cols, code_cols, schema: FeatureSchema, n):
    x = (jnp.stack(x_cols) if schema.num_cols
         else jnp.zeros((0, n), jnp.float32))
    c = (jnp.stack(code_cols) if schema.cat_cols
         else jnp.zeros((0, n), jnp.int32))
    return x, c


@functools.partial(
    jax.jit,
    static_argnames=("schema", "num_cols_to_impute", "cat_cols_to_impute",
                     "gd_iters", "lda_shrinkage", "noise", "kernel", "trainer",
                     "interpret"))
def mice_round_device(x_num, codes, num_null, cat_null, key, *,
                      schema: FeatureSchema,
                      num_cols_to_impute: tuple[int, ...],
                      cat_cols_to_impute: tuple[int, ...],
                      gd_iters: int = 500, lda_shrinkage: float = 0.001,
                      noise: bool = False, kernel: str = "xla",
                      trainer: str = "solve", interpret: bool = False):
    """One MICE round, entirely on device. Arrays are features-first.
    Returns (x_num, codes, key). kernel: 'xla' | 'triton' (the Gram
    kernel; `interpret` runs it in the Pallas interpreter)."""
    noise_key_for = ((lambda col: jax.random.fold_in(key, col)) if noise
                     else (lambda col: None))
    x_cols, code_cols = _to_cols(x_num, codes, schema)
    x_cols, code_cols = _round_columns(
        x_cols, code_cols, num_null, cat_null, schema=schema,
        num_cols_to_impute=num_cols_to_impute,
        cat_cols_to_impute=cat_cols_to_impute,
        agg=_make_agg(kernel, schema, interpret), gd_iters=gd_iters,
        lda_shrinkage=lda_shrinkage, noise_key_for=noise_key_for,
        trainer=trainer)
    x_num, codes = _from_cols(x_cols, code_cols, schema, x_num.shape[-1])
    return x_num, codes, jax.random.fold_in(key, 2 ** 20)


@functools.partial(
    jax.jit,
    static_argnames=("schema", "num_cols_to_impute", "cat_cols_to_impute",
                     "gd_iters", "lda_shrinkage", "noise", "kernel", "trainer",
                     "interpret"),
    donate_argnames=("x_num", "codes"))
def mice_loop_device(x_num, codes, num_null, cat_null, key, *,
                     schema: FeatureSchema,
                     num_cols_to_impute: tuple[int, ...],
                     cat_cols_to_impute: tuple[int, ...],
                     iters, gd_iters: int = 500,
                     lda_shrinkage: float = 0.001, noise: bool = False,
                     kernel: str = "xla", trainer: str = "solve",
                     interpret: bool = False):
    """The WHOLE MICE loop in one dispatch: lax.fori_loop over rounds with
    the columnar tuple carry (un/re-stacked once at the jit boundary).
    `iters` may be a traced scalar — one compile serves any round count."""
    agg = _make_agg(kernel, schema, interpret)
    n = num_null.shape[-1]

    def body(r, carry):
        x_cols, code_cols, k = carry
        noise_key_for = ((lambda col: jax.random.fold_in(k, col)) if noise
                         else (lambda col: None))
        x_cols, code_cols = _round_columns(
            x_cols, code_cols, num_null, cat_null, schema=schema,
            num_cols_to_impute=num_cols_to_impute,
            cat_cols_to_impute=cat_cols_to_impute, agg=agg,
            gd_iters=gd_iters, lda_shrinkage=lda_shrinkage,
            noise_key_for=noise_key_for, trainer=trainer)
        return x_cols, code_cols, jax.random.fold_in(k, 2 ** 20)

    x_cols, code_cols, key = jax.lax.fori_loop(
        0, iters, body, (*_to_cols(x_num, codes, schema), key))
    x_num, codes = _from_cols(x_cols, code_cols, schema, n)
    return x_num, codes, key


def run_mice_device(t: Table, num_null_cols=None, cat_null_cols=None,
                    iters: int = 5, *, gd_iters: int = 500,
                    lda_shrinkage: float = 0.001, noise: bool = False,
                    seed: int = 0, kernel: str = "auto",
                    trainer: str = "solve", interpret: bool = False) -> Table:
    """Host wrapper: mean/mode init, then the single-dispatch device loop.
    kernel: 'auto' | 'xla' | 'triton' (backend.resolve_kernel)."""
    import dataclasses

    from .partition import init_fill

    t = init_fill(t)
    schema = t.schema
    if num_null_cols is None:
        num_null_cols = tuple(
            j for j in range(schema.num_cols)
            if bool(np.asarray(t.num_null[j]).any()))
    if cat_null_cols is None:
        cat_null_cols = tuple(
            j for j in range(schema.cat_cols)
            if bool(np.asarray(t.cat_null[j]).any()))
    kernel = resolve_kernel(kernel, schema.sigma_size, interpret=interpret)
    x, c, _ = mice_loop_device(
        t.num_data, t.cat_codes, t.num_null, t.cat_null,
        jax.random.PRNGKey(seed), schema=schema,
        num_cols_to_impute=tuple(num_null_cols),
        cat_cols_to_impute=tuple(cat_null_cols), iters=iters,
        gd_iters=gd_iters, lda_shrinkage=lda_shrinkage, noise=noise,
        kernel=kernel, trainer=trainer, interpret=interpret)
    return dataclasses.replace(t, num_data=x, cat_codes=c)

def _make_delta_agg(kernel: str, schema: FeatureSchema,
                    interpret: bool = False):
    """(x_cols, code_cols, weights) → sigma for the delta loops (weights
    are the validity mask of the gathered dirty rows)."""
    return functools.partial(aggregate_sigma, schema=schema, kernel=kernel,
                             interpret=interpret)


def _delta_round_columns(xc, cc, k, full, nn_c, cn_c, w_valid, gidx, *,
                         schema: FeatureSchema,
                         num_cols_to_impute: tuple[int, ...],
                         cat_cols_to_impute: tuple[int, ...],
                         agg, combine, gd_iters: int, lda_shrinkage: float,
                         noise: bool, trainer: str):
    """One delta-MICE round over the COMPACT union sub-table
    (imputation_low.cpp:42-110 algebra), shared by the single-device and
    sharded loops.

    The dirty-row set is STATIC (null positions never move), so the union
    of all dirty rows is gathered ONCE into a compact [K] sub-table before
    the rounds instead of gathering each column's dirty rows from the full
    table every round; every delta aggregation is then a sequential masked
    pass over K rows (weights = this column's compact dirty mask),
    predictions and write-backs stay compact, and the full table is
    touched again only by the one scatter per column at exit. This is the
    analogue of the reference's physical t_complete_<col> partition tables
    (partition.cpp:77-237) — materialize the dirty partition once, not per
    round.

    xc/cc: compact per-column tuples [K]; nn_c/cn_c: compact null masks;
    w_valid f32[K] union-row validity (0 = padding); gidx i64[K] GLOBAL
    row ids of the union rows (noise keying — mesh-shape invariant).
    `combine` merges shard partials (identity / psum)."""
    xc = tuple(xc)
    cc = tuple(cc)

    for col in cat_cols_to_impute:
        wdirty = cn_c[col].astype(jnp.float32) * w_valid
        delta = combine(agg(xc, cc, wdirty))
        train = full - delta
        w, intercept, keep = _lda_device(train, schema, col,
                                         lda_shrinkage)
        pred = class_argmax(_w_full(w, keep, schema), intercept,
                            xc, cc, schema=schema)
        old = cc[col]
        new = jnp.where(cn_c[col] & (w_valid > 0),
                        pred.astype(old.dtype), old)
        cc = cc[:col] + (new,) + cc[col + 1:]
        full = train + combine(agg(xc, cc, wdirty))

    for col in num_cols_to_impute:
        wdirty = nn_c[col].astype(jnp.float32) * w_valid
        delta = combine(agg(xc, cc, wdirty))
        train = full - delta
        if trainer == "solve":
            coeff = linreg_solve_device(train, label=col + 1)
        else:
            coeff = linreg_train_device(train, label=col + 1,
                                        max_iters=gd_iters)
        theta = coeff * (1.0 - jax.nn.one_hot(
            col + 1, coeff.shape[0], dtype=coeff.dtype))
        pred = linear_predict(theta, xc, cc, schema=schema)
        if noise:
            nkey = jax.random.fold_in(k, col)
            theta_full = coeff.at[col + 1].set(-1.0)
            var = (_quad_form(theta_full, train)
                   / jnp.maximum(train[0, 0], 1.0))
            pred = pred + jnp.sqrt(jnp.maximum(var, 0.0)) \
                * _row_noise(nkey, gidx)
        old = xc[col]
        new = jnp.where(nn_c[col] & (w_valid > 0), pred, old)
        xc = xc[:col] + (new,) + xc[col + 1:]
        full = train + combine(agg(xc, cc, wdirty))
    return xc, cc, k, full


@functools.partial(
    jax.jit,
    static_argnames=("schema", "num_cols_to_impute", "cat_cols_to_impute",
                     "gd_iters", "lda_shrinkage", "noise", "kernel",
                     "trainer", "interpret"),
    donate_argnames=("x_num", "codes"))
def mice_loop_device_delta(x_num, codes, num_null, cat_null, key,
                           union_idx, union_valid, full_sigma=None, *,
                           schema: FeatureSchema,
                           num_cols_to_impute: tuple[int, ...],
                           cat_cols_to_impute: tuple[int, ...],
                           iters, gd_iters: int = 500,
                           lda_shrinkage: float = 0.001,
                           noise: bool = False, kernel: str = "xla",
                           trainer: str = "solve", interpret: bool = False,
                           round_offset=0):
    """The low-missing delta strategy (imputation_low.cpp) fused on-device:
    ONE full aggregation up front, ONE gather of the union-of-dirty-rows
    compact sub-table, then every round runs entirely compact:

        delta  = sigma(compact rows, weights = col's dirty mask)
        train  = full - delta          -> train / impute compact cells
        full   = train + sigma(compact rows, updated values)

    and ONE scatter per column writes the imputed cells back at exit.
    union_idx i64[K] (pad-aliased to row 0), union_valid f32[K].
    Work per round: O(K = |union dirty|), sequential-access only (see
    _delta_round_columns).

    full_sigma: optionally the [P, P] FULL-data sigma computed elsewhere
    (the out-of-core streaming pass — the table here may then be ONLY the
    dirty cache, whose clean-row mass lives inside full_sigma; the delta
    algebra never references clean rows except through `full`).
    round_offset: global index of the first round (noise keys fold it, so
    checkpointed runs resume onto the identical stream)."""
    agg = _make_delta_agg(kernel, schema, interpret)
    n = x_num.shape[-1] if schema.num_cols else codes.shape[-1]
    x_cols0, code_cols0 = _to_cols(x_num, codes, schema)
    full0 = (full_sigma if full_sigma is not None
             else agg(x_cols0, code_cols0, jnp.ones((n,), jnp.float32)))

    xc0 = tuple(a[union_idx] for a in x_cols0)
    cc0 = tuple(a[union_idx] for a in code_cols0)
    nn_c = num_null[:, union_idx] if schema.num_cols else num_null
    cn_c = cat_null[:, union_idx] if schema.cat_cols else cat_null

    def body(r, carry):
        xc, cc, kk, full = carry
        xc, cc, _, full = _delta_round_columns(
            xc, cc, jax.random.fold_in(kk, r), full, nn_c, cn_c,
            union_valid, union_idx, schema=schema,
            num_cols_to_impute=num_cols_to_impute,
            cat_cols_to_impute=cat_cols_to_impute, agg=agg,
            combine=lambda s: s, gd_iters=gd_iters,
            lda_shrinkage=lda_shrinkage, noise=noise, trainer=trainer)
        return xc, cc, kk, full

    xc, cc, _, _ = jax.lax.fori_loop(
        round_offset, round_offset + iters, body, (xc0, cc0, key, full0))

    # write-back: one scatter-ADD per imputed column (pad indices alias
    # row 0 with valid 0 => exact no-op; untouched compact cells add 0)
    x_cols, code_cols = x_cols0, code_cols0
    for col in num_cols_to_impute:
        newc = x_cols[col].at[union_idx].add(
            union_valid * (xc[col] - xc0[col]))
        x_cols = x_cols[:col] + (newc,) + x_cols[col + 1:]
    for col in cat_cols_to_impute:
        newc = code_cols[col].at[union_idx].add(
            (union_valid > 0).astype(code_cols[col].dtype)
            * (cc[col] - cc0[col]))
        code_cols = code_cols[:col] + (newc,) + code_cols[col + 1:]
    x_num, codes = _from_cols(x_cols, code_cols, schema, n)
    return x_num, codes, key


def build_union_gather(dirty_idx_lists):
    """Union of per-column dirty-row index lists -> (union_idx i64[K_pad],
    union_valid f32[K_pad]) with K_pad the next pow2 (compile-count
    O(log n))."""
    if dirty_idx_lists:
        union = np.unique(np.concatenate(
            [np.asarray(ix, np.int64) for ix in dirty_idx_lists]))
    else:
        union = np.zeros((0,), np.int64)
    size = max(len(union), 1)
    bucket = 1 << (size - 1).bit_length()
    idx = np.zeros(bucket, np.int64)
    idx[:len(union)] = union
    valid = (np.arange(bucket) < len(union)).astype(np.float32)
    return jnp.asarray(idx), jnp.asarray(valid)


def run_mice_device_delta(t: Table, num_null_cols=None, cat_null_cols=None,
                          iters: int = 5, *, gd_iters: int = 500,
                          lda_shrinkage: float = 0.001, noise: bool = False,
                          seed: int = 0, kernel: str = "auto",
                          trainer: str = "solve",
                          interpret: bool = False) -> Table:
    """Host wrapper for the compact delta loop: builds the union dirty-row
    gather once, then a single dispatch runs every round.
    kernel: 'auto' | 'xla' | 'triton' (backend.resolve_kernel)."""
    import dataclasses

    from .partition import build_partitions, init_fill

    t = init_fill(t)
    parts = build_partitions(t)
    schema = t.schema
    if num_null_cols is None:
        num_null_cols = tuple(j for j in range(schema.num_cols)
                              if len(parts.num_dirty_idx[j]))
    if cat_null_cols is None:
        cat_null_cols = tuple(j for j in range(schema.cat_cols)
                              if len(parts.cat_dirty_idx[j]))
    kernel = resolve_kernel(kernel, schema.sigma_size, interpret=interpret)
    union_idx, union_valid = build_union_gather(
        [parts.num_dirty_idx[j] for j in num_null_cols]
        + [parts.cat_dirty_idx[j] for j in cat_null_cols])

    x, c, _ = mice_loop_device_delta(
        t.num_data, t.cat_codes, t.num_null, t.cat_null,
        jax.random.PRNGKey(seed), union_idx, union_valid,
        schema=schema, num_cols_to_impute=tuple(num_null_cols),
        cat_cols_to_impute=tuple(cat_null_cols), iters=iters,
        gd_iters=gd_iters, lda_shrinkage=lda_shrinkage, noise=noise,
        kernel=kernel, trainer=trainer, interpret=interpret)
    return dataclasses.replace(t, num_data=x, cat_codes=c)
