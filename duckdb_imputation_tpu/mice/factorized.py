"""Factorized MICE — imputation over a normalized (star) schema WITHOUT
materializing the join.

The reference declares paper-experiment drivers for exactly this
(/root/reference/imputation/include/factorized_imputation_flight.h,
factorized_imputation_retailer.h — their .cpp bodies are not in the repo;
SURVEY.md §2 L4 "dead headers") on top of its factorized-join plan
`sum_triple(multiply_triple(A, B))` (README.md:163-174): per-join-key
triples on each side, ring product per key, ring sum over keys.

Design: the per-key triples are grouped aggregates (one segment-sum
pass per side) and the product-sum over keys collapses into matrix
contractions (ring.triple.factorized_join_sum). The complete dimension
side is aggregated ONCE for the whole MICE run — each round/column only
re-aggregates the fact side under that column's observed-mask, so the
per-column cost is O(fact rows), never O(join rows). This is the
factorized-learning win: the logical training set is the join (|fact|×fanout
rows) but nothing of that size is ever built.

Prediction gathers the dimension attributes of each fact row by key
(requires the dimension key to be unique — the usual FK→PK star shape; the
TRAINING path has no such restriction, many-to-many keys are handled by the
ring product itself).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..models import lda_predict, lda_train, linreg_predict, linreg_train
from ..ring.sum import sum_to_triple_grouped
from ..ring.triple import factorized_join_sum
from ..table.table import Table
from .partition import init_fill, observed_weights
from ..utils.profiling import PhaseTimer


def _dim_row_of_key(dim_key: np.ndarray, num_keys: int) -> np.ndarray:
    rows = np.full(num_keys, -1, dtype=np.int64)
    for i, k in enumerate(dim_key):
        if rows[k] != -1:
            raise ValueError("dimension key must be unique for prediction "
                             "(FK -> PK star join)")
        rows[k] = i
    return rows


def _fact_gather(row_of_key: np.ndarray, fact_key: np.ndarray) -> np.ndarray:
    """Dimension row index per fact row; a fact FK with no matching dim row
    (row_of_key == -1) would silently wrap the gather to the LAST dim row,
    so dangling FKs are a hard error (an inner join would drop them; here
    the join is assumed lossless FK -> PK)."""
    g = row_of_key[fact_key]
    if (g < 0).any():
        bad = np.unique(fact_key[g < 0])
        raise ValueError(
            f"dangling foreign keys with no matching dimension row: "
            f"{bad[:10].tolist()}{'...' if bad.size > 10 else ''}")
    return g


def run_mice_factorized(fact: Table, fact_key, dim: Table, dim_key=None,
                        num_null_cols=None, cat_null_cols=None,
                        iters: int = 5, *, lda_shrinkage: float = 0.001,
                        linreg_step: float = 0.001,
                        linreg_lambda: float = 0.0,
                        linreg_iters: int = 10000, noise: bool = True,
                        seed: int = 0,
                        timer: PhaseTimer | None = None,
                        grouped_aggregate=sum_to_triple_grouped) -> Table:
    """MICE over `fact JOIN dim ON fact_key = dim_key`, imputing the fact
    table's null columns; models train on the joined feature space.

    fact_key: i64[n_fact] join-key codes in [0, num_keys).
    dim_key:  i64[n_dim] unique key per dim row (default: row g <-> key g).
    grouped_aggregate: may be swapped for the multi-chip implementation
      (parallel.sum_to_triple_grouped_sharded).
    Column order of the joined feature space follows the ring product
    (mul.cpp:97-107): [fact nums ‖ dim nums], [fact cats ‖ dim cats] — so a
    fact column keeps its index as the training label.
    """
    timer = timer or PhaseTimer()
    fact_key = np.asarray(fact_key, dtype=np.int64)
    with timer.phase("prepare"):
        fact = init_fill(fact)
        fs, ds = fact.schema, dim.schema
        joined = fs.concat(ds)
        if dim_key is None:
            dim_key = np.arange(dim.n_rows, dtype=np.int64)
        else:
            dim_key = np.asarray(dim_key, dtype=np.int64)
        num_keys = int(max(fact_key.max(), dim_key.max())) + 1
        row_of_key = _dim_row_of_key(dim_key, num_keys)
        # the complete dimension side: per-key triples, aggregated ONCE
        dim_grouped = grouped_aggregate(
            dim.num_data, dim.cat_codes, dim_key, schema=ds,
            num_groups=num_keys)
        # dimension attributes of each fact row (for prediction)
        gather = jnp.asarray(_fact_gather(row_of_key, fact_key))
        dim_num_g = dim.num_data[:, gather] if ds.num_cols else \
            jnp.zeros((0, fact.n_rows), jnp.float32)
        dim_cat_g = dim.cat_codes[:, gather] if ds.cat_cols else \
            jnp.zeros((0, fact.n_rows), jnp.int32)
        if num_null_cols is None:
            num_null_cols = [j for j in range(fs.num_cols)
                             if bool(np.asarray(fact.num_null[j]).any())]
        if cat_null_cols is None:
            cat_null_cols = [j for j in range(fs.cat_cols)
                             if bool(np.asarray(fact.cat_null[j]).any())]

    fused_join = jax.jit(factorized_join_sum)

    def train_triple(num, codes, w):
        # grouped fact aggregate does host-side group prep; the contraction
        # over keys is the jitted contraction bundle
        fg = grouped_aggregate(num, codes, fact_key, schema=fs,
                               num_groups=num_keys, weights=w)
        return fused_join(fg, dim_grouped)
    key = jax.random.PRNGKey(seed)

    for _ in range(iters):
        # categorical fact columns first (imputation_base.cpp:18-87 order)
        for col in cat_null_cols:
            with timer.phase("cofactor"):
                w = observed_weights(fact, "cat", col)
                triple = train_triple(fact.num_data, fact.cat_codes, w)
            with timer.phase("train"):
                params = lda_train(triple, joined, label=col,
                                   shrinkage=lda_shrinkage)
            with timer.phase("impute"):
                x_num = jnp.concatenate([fact.num_data, dim_num_g], axis=0)
                other = [j for j in range(fs.cat_cols) if j != col]
                codes = jnp.concatenate(
                    [fact.cat_codes[jnp.asarray(other)]
                     if other else fact.cat_codes[:0], dim_cat_g], axis=0)
                pred_idx = lda_predict(params, x_num,
                                       codes if codes.shape[0] else None)
                fact = fact.with_cat_col(col, pred_idx.astype(jnp.int32))

        for col in num_null_cols:
            with timer.phase("cofactor"):
                w = observed_weights(fact, "num", col)
                triple = train_triple(fact.num_data, fact.cat_codes, w)
            with timer.phase("train"):
                params = linreg_train(triple, joined, label=col,
                                      step_size=linreg_step,
                                      lam=linreg_lambda,
                                      max_iters=linreg_iters,
                                      compute_variance=noise)
            with timer.phase("impute"):
                keep = [j for j in range(fs.num_cols) if j != col]
                fact_num = (fact.num_data[jnp.asarray(keep)] if keep
                            else fact.num_data[:0])
                x_num = jnp.concatenate([fact_num, dim_num_g], axis=0)
                codes = jnp.concatenate([fact.cat_codes, dim_cat_g], axis=0)
                key, sub = jax.random.split(key)
                pred = linreg_predict(
                    params, x_num, codes if codes.shape[0] else None,
                    add_noise=noise, key=sub)
                fact = fact.with_num_col(col, pred)
    return fact


def run_mice_star(fact: Table, fact_keys, dims, dim_keys=None,
                  num_null_cols=None, cat_null_cols=None,
                  iters: int = 5, *, lda_shrinkage: float = 0.001,
                  linreg_step: float = 0.001, linreg_lambda: float = 0.0,
                  linreg_iters: int = 10000, noise: bool = True,
                  seed: int = 0, timer: PhaseTimer | None = None) -> Table:
    """MICE over a multi-dimension star schema
    `fact ⋈ dims[0] ⋈ dims[1] ⋈ …` with a DIFFERENT FK per dimension —
    beyond what the reference's shared-key multiply chain can express
    (SURVEY.md §2 L4 dead headers; see ring/star.py for the algebra).
    Training triples come from `ring.star.star_join_triple`: O(fact rows)
    segment-sums + matrix contractions per column, join never materialized.

    fact_keys: per dimension, i64[n_fact] FK codes.
    dims: list of complete dimension Tables; dim_keys[i] (optional) gives
      each dim row's unique key (default: row g <-> key g).
    """
    from ..ring.star import star_join_triple, star_schema

    timer = timer or PhaseTimer()
    nd = len(dims)
    fact_keys = [np.asarray(k, dtype=np.int64) for k in fact_keys]
    with timer.phase("prepare"):
        fact = init_fill(fact)
        fs = fact.schema
        dss = [d.schema for d in dims]
        joined = star_schema(fs, dss)
        if dim_keys is None:
            dim_keys = [np.arange(d.n_rows, dtype=np.int64) for d in dims]
        num_keys = tuple(int(max(fk.max(), dk.max())) + 1
                         for fk, dk in zip(fact_keys, dim_keys))
        gathers, dim_arrays, dim_num_g, dim_cat_g = [], [], [], []
        for i, d in enumerate(dims):
            row_of_key = _dim_row_of_key(np.asarray(dim_keys[i], np.int64),
                                         num_keys[i])
            order = jnp.asarray(row_of_key)   # key -> dim row
            xnum = (d.num_data[:, order] if dss[i].num_cols
                    else jnp.zeros((0, num_keys[i]), jnp.float32))
            codes = (d.cat_codes[:, order] if dss[i].cat_cols
                     else jnp.zeros((0, num_keys[i]), jnp.int32))
            dim_arrays.append((xnum, codes))
            g = jnp.asarray(_fact_gather(row_of_key, fact_keys[i]))
            dim_num_g.append(d.num_data[:, g] if dss[i].num_cols
                             else jnp.zeros((0, fact.n_rows), jnp.float32))
            dim_cat_g.append(d.cat_codes[:, g] if dss[i].cat_cols
                             else jnp.zeros((0, fact.n_rows), jnp.int32))
        dim_num_g = jnp.concatenate(dim_num_g, axis=0) if nd else \
            jnp.zeros((0, fact.n_rows), jnp.float32)
        dim_cat_g = jnp.concatenate(dim_cat_g, axis=0) if nd else \
            jnp.zeros((0, fact.n_rows), jnp.int32)
        if num_null_cols is None:
            num_null_cols = [j for j in range(fs.num_cols)
                             if bool(np.asarray(fact.num_null[j]).any())]
        if cat_null_cols is None:
            cat_null_cols = [j for j in range(fs.cat_cols)
                             if bool(np.asarray(fact.cat_null[j]).any())]

    def train_triple(w):
        return star_join_triple(
            fact.num_data, fact.cat_codes, w, keys=fact_keys,
            dims=dim_arrays, fact_schema=fs, dim_schemas=dss,
            num_keys=num_keys)

    key = jax.random.PRNGKey(seed)
    for _ in range(iters):
        for col in cat_null_cols:
            with timer.phase("cofactor"):
                triple = train_triple(observed_weights(fact, "cat", col))
            with timer.phase("train"):
                params = lda_train(triple, joined, label=col,
                                   shrinkage=lda_shrinkage)
            with timer.phase("impute"):
                x_num = jnp.concatenate([fact.num_data, dim_num_g], axis=0)
                other = [j for j in range(fs.cat_cols) if j != col]
                codes = jnp.concatenate(
                    [fact.cat_codes[jnp.asarray(other)]
                     if other else fact.cat_codes[:0], dim_cat_g], axis=0)
                pred_idx = lda_predict(params, x_num,
                                       codes if codes.shape[0] else None)
                fact = fact.with_cat_col(col, pred_idx.astype(jnp.int32))
        for col in num_null_cols:
            with timer.phase("cofactor"):
                triple = train_triple(observed_weights(fact, "num", col))
            with timer.phase("train"):
                params = linreg_train(triple, joined, label=col,
                                      step_size=linreg_step,
                                      lam=linreg_lambda,
                                      max_iters=linreg_iters,
                                      compute_variance=noise)
            with timer.phase("impute"):
                keep = [j for j in range(fs.num_cols) if j != col]
                fact_num = (fact.num_data[jnp.asarray(keep)] if keep
                            else fact.num_data[:0])
                x_num = jnp.concatenate([fact_num, dim_num_g], axis=0)
                codes = jnp.concatenate([fact.cat_codes, dim_cat_g], axis=0)
                key, sub = jax.random.split(key)
                pred = linreg_predict(
                    params, x_num, codes if codes.shape[0] else None,
                    add_noise=noise, key=sub)
                fact = fact.with_num_col(col, pred)
    return fact
