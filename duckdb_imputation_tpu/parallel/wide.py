"""Wide-V training: solve the MICE column step with sigma COLUMN-SHARDED
over the 'model' mesh axis — sigma is never materialized on one device.

SURVEY.md §7 hard part 3: the dense quad_cat section is V×V (V=64k ⇒ 16GB
f32), so for wide one-hot expansions the P×P sigma must stay sharded
through the SOLVE, not just through the aggregation. This module is the
consumer of `parallel/sharded2d.sigma_wide`:

  * aggregation: each (data, model) device computes S[:, cols_m] for its row
    shard; psum over 'data' leaves sigma column-sharded over 'model' with
    per-device memory P × (P/M) — `sigma_wide`;
  * solve: preconditioned conjugate gradient on the normal equations
      (Σ_keep/N + λ·D) w = Σ[keep, label]/N       (ridge linear regression,
    the same system `models.device.linreg_solve_device` solves densely;
    reference objective: /root/reference/imputation/ML/regression.cpp:48-77)
    where the matvec is   y = psum_m( S[:, cols_m] @ v[cols_m] )
    — each CG iteration moves ONE P-vector between devices; the P×P matrix never
    moves and never gathers. Label row/col exclusion (θ[label] = −1) is a
    mask inside the operator, matching the dense trainer's `keep` slicing;
  * predict: θ is a tiny replicated P-vector; ŷ = θᵀZᵀ runs row-sharded
    over 'data' ('zt' built per shard, never materialized globally).

λ > 0 is required here: full one-hot blocks make Σ exactly singular (each
column's one-hots sum to the intercept column); the dense trainer absorbs
that with lstsq's min-norm pseudo-inverse, CG needs the ridge to pin the
solution. (With λ=0 CG still converges to *a* least-squares solution —
predictions agree — but coefficient comparison needs the unique λ>0 one.)
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..schema import FeatureSchema
from ..ring.sum import _zt_block
from .sharded2d import _sigma_2d, DEFAULT_ROW_CHUNK


def sigma_wide(x_num, codes, weights, *, schema: FeatureSchema, mesh: Mesh,
               row_chunk: int = DEFAULT_ROW_CHUNK) -> jax.Array:
    """Column-sharded sigma: f32[P, cols_per·M] sharded P(None, 'model') —
    stays on the mesh (per-device block P × cols_per). The production
    entry point for wide-V flows; `sum_to_triple_sharded2d` gathers it into
    a Triple for narrow-V tests only."""
    n = x_num.shape[-1] if x_num is not None else codes.shape[-1]
    if x_num is None:
        x_num = jnp.zeros((0, n), jnp.float32)
    if codes is None:
        codes = jnp.zeros((0, n), jnp.int32)
    if weights is None:
        weights = jnp.ones((n,), jnp.float32)
    nd = mesh.shape["data"]

    def pad(a):
        padn = (-a.shape[-1]) % nd
        if padn == 0:
            return a
        widths = [(0, 0)] * (a.ndim - 1) + [(0, padn)]
        return jnp.pad(a, widths)

    return _sigma_2d(pad(jnp.asarray(x_num, jnp.float32)),
                     pad(jnp.asarray(codes, jnp.int32)),
                     pad(jnp.asarray(weights, jnp.float32)),
                     schema=schema, mesh=mesh, row_chunk=row_chunk)


@functools.partial(jax.jit,
                   static_argnames=("mesh", "label", "p", "iters"))
def cg_solve_wide(sigma_cols, *, mesh: Mesh, label: int, p: int,
                  ridge: float = 1e-3, iters: int = 500,
                  tol: float = 1e-7) -> jax.Array:
    """Ridge normal-equations solve against the column-sharded sigma.

    sigma_cols: f32[P, P_pad] sharded P(None, 'model') from `sigma_wide`
    (P_pad = cols_per·M ≥ P, zero-padded). Returns coeff f32[P] replicated,
    coeff[label] = −1 — the contract of linreg_solve_device. The ridge
    applies to every active feature except the intercept (index 0), exactly
    like the dense trainer's diag(0,1,…)."""
    p_pad = sigma_cols.shape[1]
    n_model = mesh.shape["model"]
    cols_per = p_pad // n_model

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(None, "model"),), out_specs=P(None),
        check_vma=False,
    )
    def solve(s_loc):
        m = jax.lax.axis_index("model")
        lo = m * cols_per
        idx = jnp.arange(p_pad)
        active = ((idx < p) & (idx != label)).astype(jnp.float32)
        ridge_m = active * (idx != 0).astype(jnp.float32)

        # N = sigma[0, 0] lives in the shard owning column 0
        n_rows = jax.lax.psum(
            jnp.where(lo == 0, s_loc[0, 0], 0.0), "model")
        n_rows = jnp.maximum(n_rows, 1.0)

        def matvec(v):
            v_loc = jax.lax.dynamic_slice_in_dim(v, lo, cols_per)
            y = jax.lax.psum(
                jax.lax.dot_general(
                    s_loc, v_loc, (((1,), (0,)), ((), ())),
                    precision=jax.lax.Precision.HIGHEST,
                    preferred_element_type=jnp.float32), "model")
            return jnp.pad(y, (0, p_pad - s_loc.shape[0]))

        def op(v):
            return (active * matvec(active * v) / n_rows
                    + ridge * ridge_m * v + (1.0 - active) * v)

        # rhs = Σ[:, label]/N masked to the active rows (label col lives in
        # one shard; broadcast it)
        j = jnp.clip(label - lo, 0, cols_per - 1)
        col = jax.lax.dynamic_index_in_dim(s_loc, j, axis=1, keepdims=False)
        in_range = (label >= lo) & (label < lo + cols_per)
        b_rows = jax.lax.psum(jnp.where(in_range, col, 0.0), "model")
        b = active * jnp.pad(b_rows, (0, p_pad - s_loc.shape[0])) / n_rows

        # Jacobi preconditioner from the (distributed) diagonal of the op
        rows = lo + jnp.arange(cols_per)
        d_loc = s_loc[jnp.clip(rows, 0, s_loc.shape[0] - 1),
                      jnp.arange(cols_per)]
        d_loc = jnp.where(rows < s_loc.shape[0], d_loc, 0.0)
        diag = jax.lax.psum(
            jnp.zeros((p_pad,), jnp.float32).at[rows].set(d_loc), "model")
        op_diag = active * (diag / n_rows + ridge * ridge_m) + (1.0 - active)
        pinv = jnp.where(op_diag > 1e-30, 1.0 / op_diag, 1.0)

        bnorm = jnp.sqrt(jnp.sum(b * b))

        # standard PCG with explicit search direction
        def pcg(b):
            x = jnp.zeros_like(b)
            r = b
            z = r * pinv
            pvec = z
            rz = jnp.sum(r * z)

            def cond(st):
                k, x, r, pv, z, rz = st
                return (k < iters) & (
                    jnp.sqrt(jnp.sum(r * r))
                    > tol * jnp.maximum(bnorm, 1e-30))

            def body(st):
                k, x, r, pv, z, rz = st
                ap = op(pv)
                alpha = rz / jnp.maximum(jnp.sum(pv * ap), 1e-30)
                x = x + alpha * pv
                r = r - alpha * ap
                z = r * pinv
                rz_new = jnp.sum(r * z)
                beta = rz_new / jnp.maximum(rz, 1e-30)
                return (k + 1, x, r, z + beta * pv, z, rz_new)

            _, x, _, _, _, _ = jax.lax.while_loop(
                cond, body, (jnp.int32(0), x, r, pvec, z, rz))
            return x

        return pcg(b)

    w = solve(sigma_cols)
    coeff = w[:p].at[label].set(-1.0)
    return coeff


def linreg_train_wide(x_num, codes, weights, *, schema: FeatureSchema,
                      mesh: Mesh, label: int, ridge: float = 1e-3,
                      iters: int = 500, tol: float = 1e-7,
                      row_chunk: int = DEFAULT_ROW_CHUNK) -> jax.Array:
    """Wide-V ridge linear regression: aggregation and solve both sharded;
    per-device sigma memory P × (P/M). `label` indexes the numeric columns
    (the reference's label-from-num-cols convention, regression.cpp:161);
    returns coeff f32[P] with coeff[label_sigma] = −1."""
    sigma_cols = sigma_wide(x_num, codes, weights, schema=schema, mesh=mesh,
                            row_chunk=row_chunk)
    return cg_solve_wide(sigma_cols, mesh=mesh, label=1 + label,
                         p=schema.sigma_size, ridge=ridge, iters=iters,
                         tol=tol)


@functools.partial(jax.jit, static_argnames=("schema", "mesh", "label"))
def predict_wide(x_num, codes, coeff, *, schema: FeatureSchema, mesh: Mesh,
                 label: int) -> jax.Array:
    """Row-sharded prediction ŷ = Σ_{i≠label_sigma} θ_i z_i over 'data'
    (coeff replicated; Z never materialized globally)."""
    n = x_num.shape[-1]
    nd = mesh.shape["data"]
    padn = (-n) % nd
    x_in = jnp.pad(jnp.asarray(x_num, jnp.float32), ((0, 0), (0, padn)))
    c_in = jnp.pad(jnp.asarray(codes, jnp.int32), ((0, 0), (0, padn)))
    p = schema.sigma_size
    theta = coeff * (1.0 - jax.nn.one_hot(1 + label, p, dtype=coeff.dtype))

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(None, "data"), P(None, "data"), P(None)),
        out_specs=P("data"),
    )
    def pred(xn, cd, th):
        zt = _zt_block(xn, cd, schema)
        return th @ zt

    return pred(x_in, c_in, theta)[:n]


def mice_column_step_wide(x_num, codes, null_mask, *,
                          schema: FeatureSchema, mesh: Mesh, label: int,
                          ridge: float = 1e-3, iters: int = 500,
                          tol: float = 1e-7) -> jax.Array:
    """One MICE column step at wide V, fully sharded: masked aggregate
    (WHERE col_IS_NULL IS FALSE ≡ weights = ¬null), CG train, predict the
    null rows, functional write-back. The full-width analogue of
    imputation_base.cpp:92-139 whose sigma never fits one device."""
    weights = 1.0 - jnp.asarray(null_mask, jnp.float32)
    coeff = linreg_train_wide(x_num, codes, weights, schema=schema,
                              mesh=mesh, label=label, ridge=ridge,
                              iters=iters, tol=tol)
    preds = predict_wide(x_num, codes, coeff, schema=schema, mesh=mesh,
                         label=label)
    new_col = jnp.where(null_mask, preds, x_num[label])
    return x_num.at[label].set(new_col)


# ---------------------------------------------------------------------------
# Wide-V CATEGORICAL column step: LDA against the column-sharded sigma.
#
# The dense trainer (models/lda.py, following lda.cpp:154-416) materializes
# the P×P sigma and the m×m pooled covariance on one device. At wide V
# neither fits; but the covariance is never needed as a MATRIX — only its
# action on a vector:
#
#   S_w v = Σ' v − Σ_c s_c (s_cᵀ v)/N_c          (pooled within-class scatter)
#
# where Σ' is the label-excluded sigma (a row/col MASK over the full sharded
# sigma — the label block just gets zero weight, matching build_sigma's
# exclude_cat gather) and s_c are the per-class sum vectors, which are
# COLUMNS of the full sigma at the label block (build_sum_vector,
# lda.cpp:58-144, reads them out of the triple's categorical sections the
# same way). s_c is C small P-vectors — replicated low-rank data, O(P·C).
# The shrinkage solve cov·W = M (dgelsd, lda.cpp:284-297) becomes a
# preconditioned CG on that operator: per iteration one distributed matvec
# (psum over 'model') + a C-rank correction. Shrinkage > 0 makes cov PD, so
# CG converges to the unique solution the least-squares solve finds.
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("mesh", "schema", "label",
                                             "iters"))
def lda_solve_wide(sigma_cols, *, mesh: Mesh, schema: FeatureSchema,
                   label: int, shrinkage: float = 1e-3, iters: int = 500,
                   tol: float = 1e-7):
    """LDA train against the column-sharded FULL sigma (label included).

    sigma_cols: f32[P, P_pad] sharded P(None, 'model') from `sigma_wide`
    over the full schema. `label` indexes the categorical columns. Returns
    (w f32[P, C] replicated — zero on the intercept row and the label
    block, class-c coefficients in column c — and intercept f32[C]).
    Memory is O(P·C) replicated + the sharded sigma; the P×P matrix never
    gathers."""
    p = schema.sigma_size
    p_pad = sigma_cols.shape[1]
    n_model = mesh.shape["model"]
    cols_per = p_pad // n_model
    d = schema.num_cols
    offs = schema.offsets
    lab_lo = 1 + d + offs[label]
    n_classes = offs[label + 1] - offs[label]

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(None, "model"),), out_specs=(P(None), P(None)),
        check_vma=False,
    )
    def solve(s_loc):
        m_idx = jax.lax.axis_index("model")
        lo = m_idx * cols_per
        idx = jnp.arange(p_pad)
        in_label = (idx >= lab_lo) & (idx < lab_lo + n_classes)
        active = ((idx >= 1) & (idx < p) & ~in_label).astype(jnp.float32)
        m_eff = jnp.sum(active)

        # per-class sum vectors = the label block's COLUMNS of sigma
        cidx = lab_lo + jnp.arange(n_classes)
        jrel = jnp.clip(cidx - lo, 0, cols_per - 1)
        sel = jnp.take(s_loc, jrel, axis=1)               # [P, C]
        valid = ((cidx >= lo) & (cidx < lo + cols_per))
        s_full = jax.lax.psum(
            sel * valid[None, :].astype(s_loc.dtype), "model")
        s_full = jnp.pad(s_full, ((0, p_pad - s_loc.shape[0]), (0, 0)))

        n_total = jax.lax.psum(
            jnp.where(lo == 0, s_loc[0, 0], 0.0), "model")
        n_total = jnp.maximum(n_total, 1.0)
        counts = s_full[0, :]                             # [C] class counts
        cnt = jnp.maximum(counts, 1.0)   # zero-count class guard (lda.py)
        sc = s_full * active[:, None]                     # masked s_c

        # distributed diagonal of sigma (for trace and preconditioner)
        rows = lo + jnp.arange(cols_per)
        d_loc = s_loc[jnp.clip(rows, 0, s_loc.shape[0] - 1),
                      jnp.arange(cols_per)]
        d_loc = jnp.where(rows < s_loc.shape[0], d_loc, 0.0)
        diag = jax.lax.psum(
            jnp.zeros((p_pad,), jnp.float32).at[rows].set(d_loc), "model")

        low_diag = jnp.sum(sc * sc / cnt[None, :], axis=1)  # Σ_c s²/N_c
        mu = (jnp.sum(active * diag) - jnp.sum(active * low_diag)) / m_eff

        def cov_mat(v):
            """cov @ V for V f32[p_pad, C] (zero off the active rows)."""
            v_loc = jax.lax.dynamic_slice_in_dim(v, lo, cols_per, axis=0)
            sv = jax.lax.psum(
                jax.lax.dot_general(
                    s_loc, v_loc, (((1,), (0,)), ((), ())),
                    precision=jax.lax.Precision.HIGHEST,
                    preferred_element_type=jnp.float32), "model")
            sv = jnp.pad(sv, ((0, p_pad - s_loc.shape[0]), (0, 0)))
            sv = sv * active[:, None]
            low = sc @ ((sc.T @ v) / cnt[:, None])        # rank-C correction
            sw = sv - low
            return ((1.0 - shrinkage) * sw + shrinkage * mu * v) / n_total

        rhs = sc / cnt[None, :]                           # class means [P,C]
        cov_diag = ((1.0 - shrinkage) * (diag - low_diag)
                    + shrinkage * mu) / n_total
        pinv = jnp.where(active * cov_diag > 1e-30, 1.0 / cov_diag, 1.0)
        pinv = active * pinv + (1.0 - active)

        bnorm = jnp.sqrt(jnp.sum(rhs * rhs))

        def pcg(b):
            x = jnp.zeros_like(b)
            r = b
            z = r * pinv[:, None]
            pvec = z
            rz = jnp.sum(r * z, axis=0)                   # per class

            def cond(st):
                k, x, r, pv, z, rz = st
                return (k < iters) & (
                    jnp.sqrt(jnp.sum(r * r))
                    > tol * jnp.maximum(bnorm, 1e-30))

            def body(st):
                k, x, r, pv, z, rz = st
                ap = cov_mat(pv * active[:, None]) * active[:, None]
                alpha = rz / jnp.maximum(jnp.sum(pv * ap, axis=0), 1e-30)
                x = x + alpha[None, :] * pv
                r = r - alpha[None, :] * ap
                z = r * pinv[:, None]
                rz_new = jnp.sum(r * z, axis=0)
                beta = rz_new / jnp.maximum(rz, 1e-30)
                return (k + 1, x, r, z + beta[None, :] * pv, z, rz_new)

            _, x, _, _, _, _ = jax.lax.while_loop(
                cond, body, (jnp.int32(0), x, r, pvec, z, rz))
            return x * active[:, None]

        w = pcg(rhs)
        log_prior = jnp.where(counts > 0, jnp.log(cnt / n_total), -jnp.inf)
        intercept = -0.5 * jnp.sum(rhs * w, axis=0) + log_prior
        return w, intercept

    w, intercept = solve(sigma_cols)
    return w[:p], intercept


@functools.partial(jax.jit, static_argnames=("schema", "mesh"))
def lda_predict_wide(x_num, codes, w, intercept, *, schema: FeatureSchema,
                     mesh: Mesh) -> jax.Array:
    """Row-sharded LDA scoring: i32[n] 0-based class indices (the
    reference's LDA return convention, lda.cpp:575). `w` has zero rows on
    the label block, so the label column's CURRENT (to-be-replaced) values
    never leak into their own prediction."""
    n = x_num.shape[-1] if x_num is not None else codes.shape[-1]
    nd = mesh.shape["data"]
    padn = (-n) % nd
    x_in = jnp.pad(jnp.asarray(x_num, jnp.float32), ((0, 0), (0, padn)))
    c_in = jnp.pad(jnp.asarray(codes, jnp.int32), ((0, 0), (0, padn)))

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(None, "data"), P(None, "data"), P(None, None), P(None)),
        out_specs=P("data"),
    )
    def pred(xn, cd, wm, b):
        zt = _zt_block(xn, cd, schema)                    # [P, n_loc]
        scores = jax.lax.dot_general(
            wm, zt, (((0,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32)           # [C, n_loc]
        return jnp.argmax(scores + b[:, None], axis=0).astype(jnp.int32)

    return pred(x_in, c_in, w, intercept)[:n]


def mice_cat_step_wide(x_num, codes, null_mask, *, schema: FeatureSchema,
                       mesh: Mesh, label: int, shrinkage: float = 1e-3,
                       iters: int = 500, tol: float = 1e-7) -> jax.Array:
    """One CATEGORICAL MICE column step at wide V: masked full-schema
    aggregate, sharded-LDA train (label excluded by masking inside the
    operator), row-sharded argmax predict, write-back of the local codes.
    Completes the wide path for mixed tables — imputation_base.cpp:21-83
    (the categorical half) without a single-device P×P sigma."""
    weights = 1.0 - jnp.asarray(null_mask, jnp.float32)
    sigma_cols = sigma_wide(x_num, codes, weights, schema=schema, mesh=mesh)
    w, intercept = lda_solve_wide(sigma_cols, mesh=mesh, schema=schema,
                                  label=label, shrinkage=shrinkage,
                                  iters=iters, tol=tol)
    pred = lda_predict_wide(x_num, codes, w, intercept, schema=schema,
                            mesh=mesh)
    new_col = jnp.where(null_mask, pred, codes[label])
    return codes.at[label].set(new_col)


def run_mice_wide(x_num, codes, num_null, cat_null, *,
                  schema: FeatureSchema, mesh: Mesh, iters: int = 5,
                  num_cols_to_impute=None, cat_cols_to_impute=None,
                  ridge: float = 1e-3, shrinkage: float = 1e-3,
                  cg_iters: int = 500, tol: float = 1e-7):
    """MICE over a mixed numeric+categorical table at wide V: every
    aggregate and solve stays sharded (rows over 'data', sigma columns
    over 'model'); per-device sigma memory is P×(P/M) throughout.

    The wide-V analogue of run_MICE_baseline (imputation_base.cpp:6-146):
    mean/mode init, then per round categorical columns first (sharded LDA),
    continuous columns second (sharded ridge CG — the reference's GD
    trainer needs λ>0 here to pin the one-hot null space, module
    docstring). Returns (x_num, codes) imputed."""
    x_num = jnp.asarray(x_num, jnp.float32)
    codes = jnp.asarray(codes, jnp.int32)
    num_null = jnp.asarray(num_null, bool)
    cat_null = jnp.asarray(cat_null, bool)
    if num_cols_to_impute is None:
        num_cols_to_impute = tuple(
            j for j in range(schema.num_cols)
            if bool(np.asarray(num_null[j]).any()))
    if cat_cols_to_impute is None:
        cat_cols_to_impute = tuple(
            j for j in range(schema.cat_cols)
            if bool(np.asarray(cat_null[j]).any()))

    # init fills: observed mean / mode (partition.cpp:42-57 AVG/MODE)
    for j in num_cols_to_impute:
        obs = 1.0 - num_null[j].astype(jnp.float32)
        mean = jnp.sum(x_num[j] * obs) / jnp.maximum(jnp.sum(obs), 1.0)
        x_num = x_num.at[j].set(
            jnp.where(num_null[j], mean, x_num[j]))
    for j in cat_cols_to_impute:
        obs = (~cat_null[j]).astype(jnp.float32)
        hist = jnp.zeros((schema.cat_sizes[j],),
                         jnp.float32).at[codes[j]].add(obs)
        mode = jnp.argmax(hist).astype(jnp.int32)
        codes = codes.at[j].set(jnp.where(cat_null[j], mode, codes[j]))

    for _ in range(iters):
        for j in cat_cols_to_impute:
            codes = mice_cat_step_wide(
                x_num, codes, cat_null[j], schema=schema, mesh=mesh,
                label=j, shrinkage=shrinkage, iters=cg_iters, tol=tol)
        for j in num_cols_to_impute:
            x_num = mice_column_step_wide(
                x_num, codes, num_null[j], schema=schema, mesh=mesh,
                label=j, ridge=ridge, iters=cg_iters, tol=tol)
    return x_num, codes
