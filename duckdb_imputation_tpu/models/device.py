"""Device-side (jittable) trainers — the on-device training path.

The host trainers in linear_regression.py / lda.py are exact-parity f64
LAPACK reproductions of the reference. These versions run the same
algorithms as jit-compilable f32 programs so a FULL MICE column step
(aggregate → train → predict → write-back) stays on-device under one jit,
shardable over a mesh. The GD loop becomes a lax.while_loop with the nested
backtracking loop intact (regression.cpp:179-238).

Every f32 product that consumes a sigma states its precision: on a GPU an
f32 dot at default precision rounds its inputs to TF32 (~3 decimal
digits), and the quantities here (gradients, residual variances, QDA
scores) are small differences of large sums."""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import numpy as np
import jax.numpy as jnp

from ..ring.triple import Triple, sigma_from_triple


class _GDState(NamedTuple):
    it: jnp.ndarray
    step: jnp.ndarray
    coeff: jnp.ndarray
    grad: jnp.ndarray
    prev_coeff: jnp.ndarray
    prev_grad: jnp.ndarray
    prev_error: jnp.ndarray
    done: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("label", "max_iters"))
def linreg_train_device(sigma: jax.Array, *, label: int,
                        step_size: float = 0.001, lam: float = 0.0,
                        max_iters: int = 1000) -> jax.Array:
    """GD ridge regression on the Gram matrix, fully on device.

    sigma: f32[P, P] (from sigma_from_triple). label: sigma row index of the
    target (numeric col l -> l+1). Returns coeff f32[P] with coeff[label]
    pinned to −1; the usual prediction uses all entries except label."""
    p = sigma.shape[0]
    n = sigma[0, 0]
    lam = jnp.float32(lam)
    label_onehot = jax.nn.one_hot(label, p, dtype=jnp.float32)

    hi = jax.lax.Precision.HIGHEST

    def gradient(theta):
        g = jnp.dot(sigma, theta, precision=hi) / jnp.maximum(n, 1.0)
        return g * (1.0 - label_onehot)

    def error(theta):
        e = (jnp.dot(theta, jnp.dot(sigma, theta, precision=hi),
                     precision=hi) / jnp.maximum(n, 1.0))
        pn = theta[1:] @ theta[1:] - 1.0
        return (e + lam * pn) / 2.0

    coeff0 = -label_onehot
    grad0 = gradient(coeff0)
    upd0 = grad0 + lam * coeff0 * (1.0 - jax.nn.one_hot(0, p, dtype=jnp.float32))
    first_gnorm = jnp.sqrt(jnp.maximum(upd0 @ upd0 - lam * lam, 0.0))

    def body(s: _GDState) -> _GDState:
        update = s.grad + lam * s.coeff
        update = update.at[0].set(s.grad[0])
        coeff = s.coeff - s.step * update
        coeff = coeff * (1 - label_onehot) - label_onehot
        gnorm2 = update @ update - lam * lam
        dparam = s.step * jnp.sqrt(update @ update)

        err = error(coeff)

        def bt_cond(c):
            step, coeff_b, err_b, dp, k = c
            return jnp.logical_and(
                err_b > s.prev_error - (step / 2) * gnorm2, k < 500)

        def bt_body(c):
            step, coeff_b, err_b, dp, k = c
            step = step / 2
            newp = s.coeff - step * update
            dp = jnp.sqrt(jnp.sum((coeff_b - newp) ** 2))
            coeff_b = newp * (1 - label_onehot) - label_onehot
            return step, coeff_b, error(coeff_b), dp, k + 1

        step, coeff, err, dparam, _ = jax.lax.while_loop(
            bt_cond, bt_body,
            (s.step, coeff, err, dparam, jnp.int32(0)))

        gnorm = jnp.sqrt(jnp.maximum(gnorm2, 0.0))
        done = jnp.logical_or(dparam < 1e-20,
                              gnorm / (first_gnorm + 0.001) < 1e-8)
        grad = gradient(coeff)

        dtheta = coeff - s.coeff
        dgrad = grad - s.grad
        dss = dtheta @ dtheta
        gss = dgrad @ dgrad
        dgs = dtheta @ dgrad
        ts = dss / jnp.where(dgs == 0, 1.0, dgs)
        tm = dgs / jnp.where(gss == 0, 1.0, gss)
        bb = jnp.where(tm / ts > 0.5, tm, ts - 0.5 * tm)
        new_step = jnp.where(
            jnp.logical_or(jnp.logical_or(dgs == 0, gss == 0),
                           jnp.logical_or(tm < 0, ts < 0)),
            step, bb)
        return _GDState(s.it + 1, new_step, coeff, grad, s.coeff, s.grad,
                        err, done)

    def cond(s: _GDState):
        return jnp.logical_and(s.it < max_iters, jnp.logical_not(s.done))

    init = _GDState(jnp.int32(1), jnp.float32(step_size), coeff0, grad0,
                    coeff0, grad0, error(coeff0), jnp.bool_(False))
    final = jax.lax.while_loop(cond, body, init)
    return final.coeff


@functools.partial(jax.jit, static_argnames=("label",))
def linreg_solve_device(sigma: jax.Array, *, label: int,
                        lam: float = 0.0) -> jax.Array:
    """Direct least-squares trainer: the normal equations of the Gram
    objective solved in ONE SVD-backed lstsq instead of the reference's
    200+ sequential GD iterations (regression.cpp:157-238 — each GD step
    is a tiny dependent matvec).

    minimize θᵀΣθ/N + λ(‖θ₁:‖²−1) s.t. θ[label] = −1  ⇒
        (Σ_keep/N + λ·diag(0,1,…)) w = Σ[keep, label]/N.

    lstsq (min-norm) handles the EXACT singularity of full one-hot blocks +
    intercept (the collinearity GD never excites). Same return contract as
    linreg_train_device: coeff f32[P] with coeff[label] = −1. GD remains
    available (trainer='gd') for iteration-exact reference parity."""
    p = sigma.shape[0]
    keep = [i for i in range(p) if i != label]
    n = jnp.maximum(sigma[0, 0], 1.0)
    a = sigma[jnp.ix_(jnp.asarray(keep), jnp.asarray(keep))] / n
    if lam:
        d = jnp.ones((p - 1,), jnp.float32).at[0].set(0.0)
        a = a + lam * jnp.diag(d)
    b = sigma[jnp.asarray(keep), label] / n
    with jax.default_matmul_precision("highest"):
        w = jnp.linalg.lstsq(a, b)[0]
    coeff = jnp.zeros((p,), jnp.float32).at[jnp.asarray(keep)].set(w)
    return coeff.at[label].set(-1.0)


@jax.jit
def linreg_predict_device(coeff: jax.Array, zt: jax.Array,
                          label: int | jax.Array) -> jax.Array:
    """Prediction from the device coeff vector over the features-first
    feature matrix Zᵀ = [1 | x_num | onehot]ᵀ f32[P, n] (same layout as the
    sigma): the model solves θ·z ≈ 0 with θ[label] = −1, so
    ŷ = Σ_{i≠label} θ_i z_i. Returns f32[n]."""
    p = coeff.shape[0]
    theta = coeff * (1.0 - jax.nn.one_hot(label, p, dtype=coeff.dtype))
    return theta @ zt


def mice_column_step_device(x_num, codes, null_mask, *, schema, label: int,
                            max_iters: int = 200):
    """One fully-on-device MICE continuous-column step: masked aggregate →
    GD train → batched predict → masked write-back. jit/shard_map-able.
    x_num f32[d, n] features-first, codes i32[c, n], null_mask bool[n]."""
    from ..ring.sum import aggregate_sigma, linear_predict

    w = 1.0 - null_mask.astype(jnp.float32)
    sigma = aggregate_sigma(x_num, codes, w, schema=schema)
    coeff = linreg_train_device(sigma, label=label + 1,
                                max_iters=max_iters)
    theta = coeff * (1.0 - jax.nn.one_hot(label + 1, coeff.shape[0],
                                          dtype=coeff.dtype))
    pred = linear_predict(theta,
                          tuple(x_num[j] for j in range(schema.num_cols)),
                          tuple(codes[j] for j in range(schema.cat_cols)),
                          schema=schema)
    new_col = jnp.where(null_mask, pred, x_num[label])
    return x_num.at[label].set(new_col), coeff


@functools.partial(jax.jit, static_argnames=("drop_d",))
def qda_train_device(sigmas: jax.Array, tot: jax.Array, drop_d: int):
    """Device QDA from per-class sigmas f32[C, P, P] (drop-first vocab
    already applied upstream). Returns (quad [C,m,m], lin [C,m],
    intercept [C]) with the reference's parameterization
    (−½cov⁻¹, cov⁻¹μ, −½μᵀcov⁻¹μ −½log pdet + log(Nc/N)); SVD pinv with
    the 1e-9 cutoff, pseudo-determinant. drop_d = 1 (the constant row)."""
    def one(sig):
        n_c = sig[0, 0]
        n_safe = jnp.maximum(n_c, 1.0)  # zero-count class guard (see qda.py)
        s = sig[1:, 1:]
        sv = sig[0, 1:]
        cov = (s - jnp.outer(sv, sv) / n_safe) / n_safe
        u, svals, vt = jnp.linalg.svd(cov)
        inv_s = jnp.where(svals > 1e-9, 1.0 / jnp.where(svals > 1e-9,
                                                        svals, 1.0), svals)
        inva = (vt.T * inv_s) @ u.T
        logdet = jnp.sum(jnp.where(svals > 1e-9, jnp.log(svals), 0.0))
        mu = sv / n_safe
        lin = inva @ mu
        intercept = (-0.5 * mu @ lin - 0.5 * logdet
                     + jnp.log(n_c / tot))
        return -0.5 * inva, lin, intercept
    with jax.default_matmul_precision("highest"):
        return jax.vmap(one)(sigmas)


@jax.jit
def nb_train_device(n, lin, quad_diag, lin_cat):
    """Device NB from batched NBAgg arrays ([C], [C,d], [C,d], [C,V]):
    returns (priors [C], mean [C,d], var [C,d], freqs [C,V])."""
    tot = jnp.sum(n)
    n_safe = jnp.maximum(n, 1.0)[:, None]  # zero-count class guard
    mean = lin / n_safe
    var = quad_diag / n_safe - mean * mean
    freqs = lin_cat / n_safe
    return n / tot, mean, var, freqs


def qda_predict_device(quad, lin, intercept, x_num, codes, *,
                       schema, method: str = "auto") -> jax.Array:
    """Batched device QDA scoring + argmax over ALL rows at once — the
    batched fix of the reference's row-at-a-time predict loop
    (qda.cpp:444-481, 3 dgemv per row·class; the author's own "batched
    rewrite" future-work note is qda.cpp:407).

    quad/lin/intercept: qda_train_device's output ([C, m, m] with
    quad = −½cov⁻¹ negative definite, [C, m], [C]); features
    z = [x_num ‖ onehot] of width m = P−1. Scores stream per class over
    a factored form: quad = −LLᵀ (Cholesky of the PSD −quad), so
    s_c = −‖Lᵀz‖² + lin_c·z + b_c — the square-reduce can fuse into the
    matmul's output instead of materializing the [m, n] product of the
    naive zᵀ(Qz) form. Products run in full f32, so exact ties are
    decided the same way on every backend. Returns the argmax class
    INDEX i32[n] (callers map to label values — the reference's QDA
    returns values, qda.cpp:483-486).

    method: 'auto' | 'xla' (both the XLA scorer)."""
    if method not in ("auto", "xla"):
        raise ValueError(f"unknown QDA predict method {method!r}; valid "
                         f"choices are 'auto', 'xla'")
    return _qda_predict_xla(quad, lin, intercept, x_num, codes,
                            schema=schema)


@functools.partial(jax.jit, static_argnames=("schema",))
def _qda_predict_xla(quad, lin, intercept, x_num, codes, *, schema):
    from ..ring.sum import _zt_block

    n = x_num.shape[-1] if schema.num_cols else codes.shape[-1]
    # −quad is PSD by construction (−½cov⁻¹ from an SVD pinv); the tiny
    # jitter keeps cholesky off exact-zero eigenvalues of pinv'd covs
    eye = jnp.eye(quad.shape[-1], dtype=quad.dtype)
    chol = jnp.linalg.cholesky(-quad + 1e-12 * eye)      # [C, m, m]
    zt = _zt_block(x_num, codes, schema)[1:]             # [m, n]

    hi = jax.lax.Precision.HIGHEST

    def one_class(cc, carry):
        best, idx = carry
        y = jnp.dot(jax.lax.dynamic_index_in_dim(chol, cc, keepdims=False).T,
                    zt, precision=hi)
        s = (-jnp.sum(y * y, axis=0)
             + jnp.dot(jax.lax.dynamic_index_in_dim(lin, cc, keepdims=False),
                       zt, precision=hi)
             + jax.lax.dynamic_index_in_dim(intercept, cc))
        better = s > best
        return jnp.where(better, s, best), jnp.where(better, cc, idx)

    best0 = jnp.full((n,), -jnp.inf, jnp.float32)
    _, pred = jax.lax.fori_loop(
        0, quad.shape[0], one_class,
        (best0, jnp.zeros((n,), jnp.int32)))
    return pred


def nb_predict_device(priors, mean, var, freqs, x_num, codes, *,
                      schema, method: str = "auto") -> jax.Array:
    """Batched device NB scoring + argmax — naive Bayes is QDA with a
    DIAGONAL quadratic form, so this reuses qda_predict_device's
    one-table-pass machinery: in log space

        s_c = log prior_c + Σ_num [−(x−μ)²/2σ² − ½log(2πσ²)]
                          + Σ_cat log freq_c[code]

    maps onto (quad = diag(−1/2σ²) over the numeric slots, lin = μ/σ²
    ‖ log freq over the one-hot slots, intercept = the x-free terms).
    Inputs are nb_train_device's outputs ([C], [C, d], [C, d], [C, V]);
    var gets the reference's +1e-9 (naive_bayes.cpp:222-227). Returns
    the argmax class index i32[n].

    Deviations from the host/reference path (documented miss
    semantics): zero training frequency scores −1e30 (≙ probability 0)
    and an UNSEEN predict-time category contributes nothing instead of
    zeroing every class (the host path then falls back to class 0)."""
    d = schema.num_cols
    m = schema.sigma_size - 1
    var = jnp.asarray(var, jnp.float32) + 1e-9
    c_cls = priors.shape[0]
    quad = jnp.zeros((c_cls, m, m), jnp.float32)
    di = jnp.arange(d)
    quad = quad.at[:, di, di].set(-0.5 / var)
    log_freq = jnp.where(freqs > 0.0, jnp.log(jnp.maximum(freqs, 1e-38)),
                         -1e30)
    lin = jnp.concatenate([mean / var, log_freq], axis=1)    # [C, m]
    icpt = (jnp.log(jnp.maximum(priors, 1e-38))
            - 0.5 * jnp.sum(mean * mean / var
                            + jnp.log(2.0 * np.pi * var), axis=1))
    return qda_predict_device(quad, lin, icpt, x_num, codes,
                              schema=schema, method=method)
