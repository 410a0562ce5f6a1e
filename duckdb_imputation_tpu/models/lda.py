"""Linear Discriminant Analysis trained from a single cofactor triple.

Train follows `lda_train` (/root/reference/duckdb_extension/src/ML/
lda.cpp:154-416): build sigma excluding the label's categorical column,
per-class sum vectors straight from the triple's own categorical sections
(build_sum_vector, lda.cpp:58-144 — the factorized GROUP BY label), pooled
within-class scatter by subtracting class-mean outer products (:242-251),
shrinkage toward μI (:259-273), /N (:275-279), least-squares solve
cov·W = M (LAPACK dgelsd ≙ numpy lstsq, :284-297), intercepts
−½ μ_cᵀw_c + log(N_c/N) (:311-320). Solver precision float64.

Flat float32 parameter layout (lda.cpp:335-386):

  [ n_classes,
    size_idxs                (= n_cat_vars, but 0 when the label is the only cat),
    (adjusted cat_vars_idxs — n_cat values (label slot skipped),
     cat_values of non-label columns,)?          # if non-label cats exist
    label category values    (n_classes values),
    coef                     (class-major: class c's m values contiguous),
    intercepts               (n_classes),
    (means[1:] — m values)?  ]                   # if normalize

Predict (LDA_impute, lda.cpp:421-590) is batched: one matmul + argmax over
all rows; returns the 0-based CLASS INDEX, not the label value (lda.cpp:575)
— a deliberate reference quirk kept for parity (QDA/NB return the value).
"""
from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from ..schema import FeatureSchema
from ..ring.triple import Triple
from .sigma import build_sigma, class_sums, standardize_sigma


def lda_train(t: Triple, schema: FeatureSchema, label: int,
              shrinkage: float = 0.0, normalize: bool = False) -> np.ndarray:
    """`lda_train(triple, label, shrinkage, normalize)`; `label` indexes the
    CATEGORICAL columns from 0."""
    sigma, sel = build_sigma(t, schema, exclude_cat=label)
    p = sigma.shape[0]
    n_total = float(np.asarray(t.n))
    sums = class_sums(t, schema, label, sel)          # [C, p]
    n_classes = sums.shape[0]

    means = std = None
    if normalize:
        means, std = standardize_sigma(sigma)
        # standardize the class sums too (lda.cpp:206-212)
        for c in range(n_classes):
            sums[c, 1:] = (sums[c, 1:] - means[1:] * sums[c, 0]) / std[1:]

    m = p - 1
    cov = sigma[1:, 1:].copy()
    class_mean = np.zeros((n_classes, m))
    # Zero-count class guard: with the dense schema vocab a class can be
    # absent under the observed-mask (the reference builds its class list
    # from the triple itself, so an absent class simply doesn't exist there,
    # lda.cpp:58-144). Clamp the count for the mean/scatter (zero class mean,
    # no covariance contribution) and give the class a -inf intercept via
    # log(0) so argmax can never predict it — the same observable behavior.
    cnt = np.maximum(sums[:, 0], 1.0)
    for c in range(n_classes):
        cov -= np.outer(sums[c, 1:], sums[c, 1:]) / cnt[c]
        class_mean[c] = sums[c, 1:] / cnt[c]

    mu = np.trace(cov) / m
    cov *= (1.0 - shrinkage)
    cov[np.diag_indices(m)] += shrinkage * mu
    cov /= n_total

    # dgelsd least-squares: cov · W = Mᵀ  (lda.cpp:294-297)
    w, *_ = np.linalg.lstsq(cov, class_mean.T, rcond=-1)   # [m, C]
    with np.errstate(divide="ignore"):
        log_prior = np.log(sums[:, 0] / n_total)
    intercept = (-0.5 * np.einsum("cm,mc->c", class_mean, w) + log_prior)

    if normalize:
        w = w / std[1:, None]

    out: list[float] = [float(n_classes)]
    size_idxs = schema.cat_cols if schema.cat_cols != 1 else 0
    out.append(float(size_idxs))
    offs = schema.offsets
    label_size = offs[label + 1] - offs[label]
    if sel.schema.vocab_size > 0:      # non-label categorical columns exist
        remove = 0
        for i in range(schema.cat_cols + 1):
            if i == label:
                remove = label_size
                continue
            out.append(float(offs[i] - remove))
        for j in sel.kept_cols:
            out.extend(float(k) for k in schema.cat_keys[j])
    out.extend(float(k) for k in schema.cat_keys[label])
    out.extend(float(x) for x in w.T.flatten())            # class-major
    out.extend(float(x) for x in intercept)
    if normalize:
        out.extend(float(x) for x in means[1:])
    return np.asarray(out, np.float32)


@dataclasses.dataclass(frozen=True)
class LDAParams:
    n_classes: int
    offsets: np.ndarray     # i64[size_idxs] (or [1] if none)
    cat_keys: np.ndarray    # i64[V'] non-label vocab
    labels: np.ndarray      # i64[C] label category values
    coef: np.ndarray        # f64[m, C]
    intercept: np.ndarray   # f64[C]
    num_means: np.ndarray | None
    cat_means: np.ndarray | None

    @staticmethod
    def decode(params: np.ndarray, num_cols: int, normalize: bool) -> "LDAParams":
        params = np.asarray(params, np.float64)
        n_classes = int(params[0])
        size_idxs = int(params[1])
        i = 2
        if size_idxs > 0:
            offsets = params[i:i + size_idxs].astype(np.int64)
            i += size_idxs
            v = int(offsets[-1])
            cat_keys = params[i:i + v].astype(np.int64)
            i += v
        else:
            offsets = np.zeros(1, np.int64)
            cat_keys = np.zeros(0, np.int64)
            v = 0
        labels = params[i:i + n_classes].astype(np.int64)
        i += n_classes
        m = num_cols + v
        coef = params[i:i + m * n_classes].reshape(n_classes, m).T
        i += m * n_classes
        intercept = params[i:i + n_classes]
        i += n_classes
        num_means = cat_means = None
        if normalize:
            num_means = params[i:i + num_cols]
            cat_means = params[i + num_cols:i + m]
        return LDAParams(n_classes, offsets, cat_keys, labels, coef,
                         intercept, num_means, cat_means)


def _onehot_features_t(x_num, codes, offsets, v, normalize,
                       num_means, cat_means):
    """Features-first [m, n] feature matrix: numeric rows then concatenated
    one-hots (LDA_impute :511-549, batched column-major)."""
    x = jnp.asarray(x_num, jnp.float32)
    n = x.shape[-1]
    feats = [x if not normalize
             else x - jnp.asarray(num_means, jnp.float32)[:, None]]
    if v > 0:
        parts = []
        codes = jnp.asarray(codes)
        for j in range(len(offsets) - 1):
            size = int(offsets[j + 1] - offsets[j])
            cat_iota = jax.lax.broadcasted_iota(jnp.int32, (size, n), 0)
            parts.append((codes[j][None, :] == cat_iota).astype(jnp.float32))
        oh = jnp.concatenate(parts, axis=0)
        if normalize:
            oh = oh - jnp.asarray(cat_means, jnp.float32)[:, None]
        feats.append(oh)
    return jnp.concatenate(feats, axis=0)


def lda_predict(params: np.ndarray, x_num, codes=None, *,
                normalize: bool = False) -> jax.Array:
    """Batched `lda_predict(params, normalize, cols…)` → i32[n] 0-based class
    indices (lda.cpp:575). x_num f32[dn, n] features-first; codes i32[c, n]
    LOCAL codes of the non-label categorical columns."""
    x_num = jnp.asarray(x_num, jnp.float32)
    p = LDAParams.decode(params, x_num.shape[0], normalize)
    v = len(p.cat_keys)
    # the stored idxs are the full boundary list of the remaining (non-label)
    # columns: n_cat values = (n_cat-1)+1 boundaries, first always 0
    feats = _onehot_features_t(x_num, codes, p.offsets if v > 0 else [0], v,
                               normalize, p.num_means, p.cat_means)
    scores = jnp.dot(jnp.asarray(p.coef, jnp.float32).T, feats,
                     precision=jax.lax.Precision.HIGHEST) \
        + jnp.asarray(p.intercept, jnp.float32)[:, None]
    return jnp.argmax(scores, axis=0).astype(jnp.int32)
