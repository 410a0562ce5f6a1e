"""Sharded MICE — the full loop under one shard_map over the data axis.

BASELINE config 5 is the full MICE loop over a 100M-row mixed table,
multi-host. The single-device loop (device_round.py) covers one device;
this module scales it over a `jax.sharding.Mesh`:

  * rows are sharded over the 'data' axis (hosts × devices; the psum is
    an all-reduce over whatever links the devices share);
  * each round, per null column: every device aggregates the masked sigma
    of ITS row shard and one `psum` combines them — the same
    update/combine contract as the reference's per-thread SumStates merged
    by SumStateCombine (sum_state.cpp:10-114), with the all-reduce as the
    combine;
  * the train solve consumes the (replicated) psum'd sigma identically on
    every device — params never need broadcasting, they are born
    replicated (the standard DP pattern for tiny models);
  * predict + write-back are shard-local (chunk-streamed, so no [P, n]
    block materializes on any device);
  * the per-round sequential dependency means the loop is latency-bound at
    scale (SURVEY §7 hard part 5) — everything stays inside ONE dispatch
    (lax.fori_loop over rounds), so the only host sync is the final fetch.

Scaling efficiency: per round the compute is O(n/D) per device and the
communication is D-independent (one P×P psum per column) — efficiency
approaches 1 as n grows; the ≥80%-at-N-hosts target is met whenever the
per-shard aggregation time dominates the ~µs sigma all-reduce.

Stochastic-regression noise is keyed per (round, column, GLOBAL row index)
— counter-based draws, no shard fold — so shards draw independent gaussians
AND the result is bit-identical across mesh shapes (1 chip ≡ N chips).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from ..backend import resolve_kernel
from ..schema import FeatureSchema
from ..table.table import Table
from .device_round import _from_cols, _make_agg, _round_columns, _to_cols


@functools.partial(
    jax.jit,
    static_argnames=("schema", "mesh", "num_cols_to_impute",
                     "cat_cols_to_impute", "gd_iters", "lda_shrinkage",
                     "noise", "axis", "trainer", "kernel", "interpret"))
def mice_loop_sharded(x_num, codes, num_null, cat_null, valid, key, *,
                      schema: FeatureSchema, mesh,
                      num_cols_to_impute: tuple[int, ...],
                      cat_cols_to_impute: tuple[int, ...],
                      iters, gd_iters: int = 500,
                      lda_shrinkage: float = 0.001, noise: bool = False,
                      axis: str = "data", trainer: str = "solve",
                      kernel: str = "xla", interpret: bool = False,
                      round_offset=0):
    """The whole sharded MICE loop in one dispatch. Arrays features-first,
    row axis sharded over `axis`; `valid` is f32[n] 1/0 (zero-weight row
    padding). `iters` may be traced. Inside the shard the table is the
    columnar tuple carry (see device_round module docstring); each device
    aggregates its shard with `kernel` ('xla' | 'triton') and one psum
    combines the partial sigmas before the replicated solve (the
    reference's SumStateCombine boundary, sum_state.cpp:10-114, as the
    all-reduce)."""

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(None, axis), P(None, axis), P(None, axis),
                  P(None, axis), P(axis), P()),
        out_specs=(P(None, axis), P(None, axis)),
        # pallas_call outputs carry no varying-mesh-axes annotation, so the
        # vma check rejects the Gram kernel inside shard_map; the psum
        # combine makes the sharding contract explicit regardless
        check_vma=False,
    )
    def local(x, c, nn, cn, val, k):
        base_agg = _make_agg(kernel, schema, interpret)
        invalid = val == 0.0

        def agg(x_cols, code_cols, null_row):
            # pad rows fold into the mask: w = valid * (1 - null)
            local_sigma = base_agg(x_cols, code_cols,
                                   jnp.logical_or(null_row, invalid))
            return jax.lax.psum(local_sigma, axis)

        # noise is keyed by (round, column, GLOBAL row index) — no shard
        # fold — so stochastic results are identical for any device count
        row_offset = jax.lax.axis_index(axis) * x.shape[-1]

        def one_round(r, carry):
            x_cols, code_cols = carry
            if noise:
                noise_key_for = (
                    lambda col: jax.random.fold_in(k, r * 131 + col))
            else:
                noise_key_for = lambda col: None
            return _round_columns(
                x_cols, code_cols, nn, cn, schema=schema,
                num_cols_to_impute=num_cols_to_impute,
                cat_cols_to_impute=cat_cols_to_impute, agg=agg,
                gd_iters=gd_iters, lda_shrinkage=lda_shrinkage,
                noise_key_for=noise_key_for, trainer=trainer,
                row_offset=row_offset)

        # rounds run over GLOBAL indices [round_offset, round_offset +
        # iters): noise keys fold the global round, so a checkpointed run
        # resumed mid-way draws the identical stream as an uninterrupted one
        cols = jax.lax.fori_loop(round_offset, round_offset + iters,
                                 one_round, _to_cols(x, c, schema))
        return _from_cols(*cols, schema, x.shape[-1])

    return local(x_num, codes, num_null, cat_null, valid, key)


def _checkpointed_rounds(t, x, c, n, iters, checkpoint_path,
                         checkpoint_every, padded, col_sh, run_chunk):
    """Shared round-boundary checkpoint driver for the sharded wrappers:
    `run_chunk(x, c, iters, round_offset) -> (x_out, c_out)` runs a
    dispatch of that many GLOBAL rounds; the table is persisted after
    every chunk and a saved run resumes from its last completed round."""
    from ..utils.checkpoint import MiceCheckpointer
    ckpt = MiceCheckpointer(checkpoint_path)
    start = 0
    res = ckpt.resume()
    if res is not None:
        t_saved, start = res
        if start >= iters:
            return t_saved, None, None
        x = jax.device_put(padded(t_saved.num_data), col_sh)
        c = jax.device_put(padded(t_saved.cat_codes), col_sh)
    x_out, c_out = x, c
    for r0 in range(start, iters, checkpoint_every):
        k_rounds = min(checkpoint_every, iters - r0)
        x_out, c_out = run_chunk(x_out, c_out, k_rounds, r0)
        ckpt(dataclasses.replace(
            t, num_data=x_out[:, :n], cat_codes=c_out[:, :n]),
            r0 + k_rounds - 1)
    return None, x_out, c_out



def run_mice_sharded(t: Table, num_null_cols=None, cat_null_cols=None,
                     iters: int = 5, *, mesh=None, gd_iters: int = 500,
                     lda_shrinkage: float = 0.001, noise: bool = False,
                     seed: int = 0, axis: str = "data",
                     trainer: str = "solve", kernel: str = "auto",
                     interpret: bool = False,
                     checkpoint_path: str | None = None,
                     checkpoint_every: int = 1) -> Table:
    """Host wrapper: mean/mode init, zero-weight row padding to the mesh
    size, sharded placement, one dispatch, unpad. kernel: 'auto' | 'xla' |
    'triton' (backend.resolve_kernel).

    checkpoint_path: persist the table every `checkpoint_every` rounds and
    resume from the latest checkpoint if one exists — a killed run resumes
    to the same trajectory (bit-identical: noise keys fold global rounds)."""
    from ..parallel.mesh import make_mesh
    from .partition import init_fill

    t = init_fill(t)
    schema = t.schema
    mesh = mesh or make_mesh()
    ndev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    n = t.n_rows
    kernel = resolve_kernel(kernel, schema.sigma_size, interpret=interpret)
    pad = (-n) % ndev

    def padded(a, fill=0):
        if pad == 0 or a is None:
            return np.asarray(a) if a is not None else None
        a = np.asarray(a)
        widths = [(0, 0)] * (a.ndim - 1) + [(0, pad)]
        return np.pad(a, widths, constant_values=fill)

    if num_null_cols is None:
        num_null_cols = tuple(j for j in range(schema.num_cols)
                              if bool(np.asarray(t.num_null[j]).any()))
    if cat_null_cols is None:
        cat_null_cols = tuple(j for j in range(schema.cat_cols)
                              if bool(np.asarray(t.cat_null[j]).any()))

    col_sh = NamedSharding(mesh, P(None, axis))
    row_sh = NamedSharding(mesh, P(axis))
    x = jax.device_put(padded(t.num_data), col_sh)
    c = jax.device_put(padded(t.cat_codes), col_sh)
    nn = jax.device_put(padded(t.num_null), col_sh)
    cn = jax.device_put(padded(t.cat_null), col_sh)
    valid = jax.device_put(
        np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)]),
        row_sh)

    loop_kw = dict(
        schema=schema, mesh=mesh,
        num_cols_to_impute=tuple(num_null_cols),
        cat_cols_to_impute=tuple(cat_null_cols), gd_iters=gd_iters,
        lda_shrinkage=lda_shrinkage, noise=noise, axis=axis,
        trainer=trainer, kernel=kernel, interpret=interpret)
    key = jax.random.PRNGKey(seed)

    if checkpoint_path is None:
        x_out, c_out = mice_loop_sharded(x, c, nn, cn, valid, key,
                                         iters=iters, **loop_kw)
    else:
        # host-side round-boundary checkpoints (the reference has none —
        # SURVEY §5): rounds run in checkpoint_every-sized dispatches;
        # noise keys fold the GLOBAL round (round_offset), so the resumed
        # trajectory is bit-identical to the uninterrupted one
        done, x_out, c_out = _checkpointed_rounds(
            t, x, c, n, iters, checkpoint_path, checkpoint_every,
            padded, col_sh,
            lambda xx, cc, k_rounds, r0: mice_loop_sharded(
                xx, cc, nn, cn, valid, key, iters=k_rounds,
                round_offset=r0, **loop_kw))
        if done is not None:
            return done
    # drop the pad rows ON DEVICE — no host round trip of the full table
    if pad:
        x_out = x_out[:, :n]
        c_out = c_out[:, :n]
    return dataclasses.replace(t, num_data=x_out, cat_codes=c_out)


@functools.partial(
    jax.jit,
    static_argnames=("schema", "mesh", "num_cols_to_impute",
                     "cat_cols_to_impute", "gd_iters", "lda_shrinkage",
                     "noise", "axis", "trainer", "kernel", "interpret"))
def mice_loop_sharded_delta(x_num, codes, num_null, cat_null, valid, key,
                            union_idx, union_valid, *,
                            schema: FeatureSchema, mesh,
                            num_cols_to_impute: tuple[int, ...],
                            cat_cols_to_impute: tuple[int, ...],
                            iters, gd_iters: int = 500,
                            lda_shrinkage: float = 0.001,
                            noise: bool = False, axis: str = "data",
                            trainer: str = "solve", kernel: str = "xla",
                            interpret: bool = False, round_offset=0):
    """The delta-MICE strategy (imputation_low.cpp:42-110,188-194) under one
    shard_map, COMPACT union form (see device_round._delta_round_columns
    for why per-round full-table gathers lost to the rescan): each shard
    gathers the union of ITS dirty rows once into a compact sub-table,
    every round runs compact masked aggregations whose tiny P×P
    delta/readd sigmas are psum'd (communication per round: column-count ×
    2 sigma all-reduces, D-independent), `full`/`train` stay replicated,
    and one scatter per column per dispatch writes back shard-locally.

    union_idx i32[D, K], union_valid f32[D, K]: SHARD-LOCAL union
    dirty-row indices, padded to a common width, sharded over the leading
    axis; num_null/cat_null are the full masks (compact masks gathered
    in-shard)."""
    from .device_round import (_delta_round_columns, _from_cols,
                               _make_delta_agg, _to_cols)

    agg = _make_delta_agg(kernel, schema, interpret)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(None, axis), P(None, axis), P(None, axis),
                  P(None, axis), P(axis), P(), P(axis, None),
                  P(axis, None)),
        out_specs=(P(None, axis), P(None, axis)),
        check_vma=False,   # Pallas outputs carry no vma (see above)
    )
    def local(x, c, nn, cn, val, k, uidx, uval):
        uidx, uval = uidx[0], uval[0]
        combine = lambda s: jax.lax.psum(s, axis)
        x_cols0, code_cols0 = _to_cols(x, c, schema)
        full0 = combine(agg(x_cols0, code_cols0, val))
        # noise keyed by (round, col, GLOBAL row index): mesh-shape
        # invariant, no shard fold
        row_offset = jax.lax.axis_index(axis) * x.shape[-1]

        xc0 = tuple(a[uidx] for a in x_cols0)
        cc0 = tuple(a[uidx] for a in code_cols0)
        nn_c = nn[:, uidx] if schema.num_cols else nn
        cn_c = cn[:, uidx] if schema.cat_cols else cn

        def body(r, carry):
            xc, cc, kk, full = carry
            xc, cc, _, full = _delta_round_columns(
                xc, cc, jax.random.fold_in(kk, r), full, nn_c, cn_c,
                uval, row_offset + uidx, schema=schema,
                num_cols_to_impute=num_cols_to_impute,
                cat_cols_to_impute=cat_cols_to_impute, agg=agg,
                combine=combine, gd_iters=gd_iters,
                lda_shrinkage=lda_shrinkage, noise=noise, trainer=trainer)
            return xc, cc, kk, full

        xc, cc, _, _ = jax.lax.fori_loop(
            round_offset, round_offset + iters, body,
            (xc0, cc0, k, full0))

        x_cols, code_cols = x_cols0, code_cols0
        for col in num_cols_to_impute:
            newc = x_cols[col].at[uidx].add(uval * (xc[col] - xc0[col]))
            x_cols = x_cols[:col] + (newc,) + x_cols[col + 1:]
        for col in cat_cols_to_impute:
            newc = code_cols[col].at[uidx].add(
                (uval > 0).astype(code_cols[col].dtype)
                * (cc[col] - cc0[col]))
            code_cols = code_cols[:col] + (newc,) + code_cols[col + 1:]
        return _from_cols(x_cols, code_cols, schema, x.shape[-1])

    return local(x_num, codes, num_null, cat_null, valid, key,
                 union_idx, union_valid)


def run_mice_sharded_delta(t: Table, num_null_cols=None, cat_null_cols=None,
                           iters: int = 5, *, mesh=None,
                           gd_iters: int = 500,
                           lda_shrinkage: float = 0.001,
                           noise: bool = False, seed: int = 0,
                           axis: str = "data",
                           trainer: str = "solve", kernel: str = "auto",
                           interpret: bool = False,
                           checkpoint_path: str | None = None,
                           checkpoint_every: int = 1) -> Table:
    """Host wrapper for sharded delta-MICE: mean/mode init, rows padded to
    the mesh and block-sharded, per-shard dirty-row gathers built once
    (global dirty indices split by owning shard, pow2-padded to a common
    width), then the whole loop is one dispatch.

    checkpoint_path: round-boundary checkpoints + resume (see
    run_mice_sharded). Each resumed chunk recomputes `full` from the
    current table — the delta algebra's own invariant (full = train +
    delta), so the trajectory matches up to f32 re-accumulation."""
    from ..parallel.mesh import make_mesh
    from .partition import build_partitions, init_fill

    t = init_fill(t)
    parts = build_partitions(t)
    schema = t.schema
    mesh = mesh or make_mesh()
    ndev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    kernel = resolve_kernel(kernel, schema.sigma_size, interpret=interpret)
    n = t.n_rows
    pad = (-n) % ndev
    m = (n + pad) // ndev          # rows per shard (block sharding)

    if num_null_cols is None:
        num_null_cols = tuple(j for j in range(schema.num_cols)
                              if len(parts.num_dirty_idx[j]))
    if cat_null_cols is None:
        cat_null_cols = tuple(j for j in range(schema.cat_cols)
                              if len(parts.cat_dirty_idx[j]))

    # SHARD-LOCAL union of dirty rows (all imputed columns), padded to a
    # common pow2 width — gathered once per dispatch into each shard's
    # compact sub-table (see mice_loop_sharded_delta); per shard this is
    # build_union_gather's rule applied to the shard's slice
    from .device_round import build_union_gather
    all_dirty = ([parts.num_dirty_idx[j] for j in num_null_cols]
                 + [parts.cat_dirty_idx[j] for j in cat_null_cols])
    union = (np.unique(np.concatenate(
        [np.asarray(ix, np.int64) for ix in all_dirty]))
        if all_dirty else np.zeros((0,), np.int64))
    per = [union[(union >= s * m) & (union < (s + 1) * m)] - s * m
           for s in range(ndev)]
    width = max(len(build_union_gather([p2])[0]) for p2 in per)
    union_i = np.zeros((ndev, width), np.int64)
    union_v = np.zeros((ndev, width), np.float32)
    for s, pidx in enumerate(per):
        union_i[s, :len(pidx)] = pidx
        union_v[s, :len(pidx)] = 1.0

    def padded(a, fill=0):
        if pad == 0:
            return np.asarray(a)
        a = np.asarray(a)
        widths = [(0, 0)] * (a.ndim - 1) + [(0, pad)]
        return np.pad(a, widths, constant_values=fill)

    col_sh = NamedSharding(mesh, P(None, axis))
    shard_sh = NamedSharding(mesh, P(axis, None))
    x = jax.device_put(padded(t.num_data), col_sh)
    c = jax.device_put(padded(t.cat_codes), col_sh)
    nn = jax.device_put(padded(t.num_null), col_sh)
    cn = jax.device_put(padded(t.cat_null), col_sh)
    valid = jax.device_put(
        np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)]),
        NamedSharding(mesh, P(axis)))
    union_i = jax.device_put(jnp.asarray(union_i), shard_sh)
    union_v = jax.device_put(jnp.asarray(union_v), shard_sh)

    loop_kw = dict(
        schema=schema, mesh=mesh,
        num_cols_to_impute=tuple(num_null_cols),
        cat_cols_to_impute=tuple(cat_null_cols), gd_iters=gd_iters,
        lda_shrinkage=lda_shrinkage, noise=noise, axis=axis,
        trainer=trainer, kernel=kernel, interpret=interpret)
    key = jax.random.PRNGKey(seed)
    if checkpoint_path is None:
        x_out, c_out = mice_loop_sharded_delta(
            x, c, nn, cn, valid, key, union_i, union_v, iters=iters,
            **loop_kw)
    else:
        done, x_out, c_out = _checkpointed_rounds(
            t, x, c, n, iters, checkpoint_path, checkpoint_every,
            padded, col_sh,
            lambda xx, cc, k_rounds, r0: mice_loop_sharded_delta(
                xx, cc, nn, cn, valid, key, union_i, union_v,
                iters=k_rounds, round_offset=r0, **loop_kw))
        if done is not None:
            return done
    if pad:
        x_out = x_out[:, :n]
        c_out = c_out[:, :n]
    return dataclasses.replace(t, num_data=x_out, cat_codes=c_out)
