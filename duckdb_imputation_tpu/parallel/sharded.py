"""Sharded cofactor aggregation: shard_map over the row axis + psum combine.

This is the data-parallel analogue of the reference's thread-level
aggregation (SumNoLift update per thread → SumStateCombine merge,
sum_state.cpp:10-114), mapped onto a device mesh: every device runs the
dense masked-Gram aggregation (`ring.sum.aggregate_sigma`) on its row
shard, and one `psum` over the mesh axis IS the combine — the whole communication story for a triple is a
single all-reduce of a (P,P) f32 matrix.

Row counts are padded to a multiple of the mesh size with zero-weight rows
(padding is free because the mask is fused into the kernel).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ..schema import FeatureSchema
from ..backend import resolve_kernel
from ..ring.sum import DEFAULT_ROW_CHUNK, aggregate_sigma, masked_sigma
from ..ring.triple import NBAgg, Triple, triple_from_sigma
from .mesh import DATA_AXIS, make_mesh


def _pad_to(arr, mult, axis=-1):
    n = arr.shape[axis]
    pad = (-n) % mult
    if pad == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(np.asarray(arr), widths)


@functools.partial(jax.jit,
                   static_argnames=("schema", "mesh", "row_chunk", "axis",
                                    "kernel"))
def _sharded_sigma(x_num, codes, weights, *, schema: FeatureSchema, mesh,
                   row_chunk: int, axis: str, kernel: str):
    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(None, axis), P(None, axis), P(axis)),
        out_specs=P(),
        # pallas_call outputs carry no varying-mesh-axes annotation, so the
        # vma check rejects the Gram kernel inside shard_map
        check_vma=False,
    )
    def local(xn, cd, w):
        sigma = aggregate_sigma(xn, cd, w, schema=schema, kernel=kernel,
                                row_chunk=row_chunk)
        return jax.lax.psum(sigma, axis)          # the combine step

    return local(x_num, codes, weights)


def sum_to_triple_sharded(x_num=None, codes=None, weights=None, *,
                          schema: FeatureSchema, mesh=None,
                          row_chunk: int = DEFAULT_ROW_CHUNK,
                          axis: str = DATA_AXIS) -> Triple:
    """Drop-in sharded `sum_to_triple`: rows sharded over `axis`, partial
    sigmas psum'd. Exactly equal to the single-device result up to f32
    reduction order (tested for exact equality on integer-valued sections).
    Each shard aggregates with the kernel `backend.resolve_kernel` picks."""
    mesh = mesh or make_mesh()
    nd = np.prod([mesh.shape[a] for a in mesh.axis_names])
    n = x_num.shape[-1] if x_num is not None else codes.shape[-1]
    if x_num is None:
        x_num = np.zeros((0, n), np.float32)
    if codes is None:
        codes = np.zeros((0, n), np.int32)
    if weights is None:
        weights = np.ones((n,), np.float32)
    x_num = jnp.asarray(_pad_to(np.asarray(x_num, np.float32), nd))
    codes = jnp.asarray(_pad_to(np.asarray(codes, np.int32), nd))
    weights = jnp.asarray(_pad_to(np.asarray(weights, np.float32), nd))
    sigma = _sharded_sigma(x_num, codes, weights, schema=schema, mesh=mesh,
                           row_chunk=row_chunk, axis=axis,
                           kernel=resolve_kernel("auto", schema.sigma_size))
    return triple_from_sigma(sigma, schema.num_cols)


@functools.partial(jax.jit,
                   static_argnames=("schema", "mesh", "num_groups",
                                    "row_chunk", "axis"))
def _sharded_grouped_sigma(x_num, codes, weights, group_ids, *,
                           schema: FeatureSchema, mesh, num_groups: int,
                           row_chunk: int, axis: str):
    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(None, axis), P(None, axis), P(axis), P(axis)),
        out_specs=P(),
    )
    def local(xn, cd, w, g):
        def one_group(gid):
            wg = w * (g == gid).astype(jnp.float32)
            return masked_sigma(xn, cd, wg, schema=schema,
                                row_chunk=row_chunk)
        sig = jax.vmap(one_group)(jnp.arange(num_groups))
        return jax.lax.psum(sig, axis)

    return local(x_num, codes, weights, group_ids)


def sum_to_triple_grouped_sharded(x_num, codes, group_ids, *,
                                  schema: FeatureSchema, num_groups: int,
                                  weights=None, mesh=None,
                                  row_chunk: int = DEFAULT_ROW_CHUNK,
                                  axis: str = DATA_AXIS) -> Triple:
    """Sharded GROUP BY aggregation: per-class triples via group masks on
    every shard + one psum of the [G, P, P] stack. Skewed classes (the
    BASELINE.json QDA config) cost nothing extra: every shard does identical
    dense work regardless of key distribution — the 'skew-aware
    redistribution' requirement is satisfied by construction."""
    mesh = mesh or make_mesh()
    nd = np.prod([mesh.shape[a] for a in mesh.axis_names])
    n = len(group_ids)
    if x_num is None:
        x_num = np.zeros((0, n), np.float32)
    if codes is None:
        codes = np.zeros((0, n), np.int32)
    if weights is None:
        weights = np.ones((n,), np.float32)
    x_num = jnp.asarray(_pad_to(np.asarray(x_num, np.float32), nd))
    codes = jnp.asarray(_pad_to(np.asarray(codes, np.int32), nd))
    weights = jnp.asarray(_pad_to(np.asarray(weights, np.float32), nd))
    # pad group ids with an out-of-range id so padded rows hit no group
    gpad = _pad_to(np.asarray(group_ids, np.int32), nd)
    if len(gpad) > n:
        gpad = gpad.copy()
        gpad[n:] = num_groups
    sigma = _sharded_grouped_sigma(
        x_num, codes, weights, jnp.asarray(gpad), schema=schema, mesh=mesh,
        num_groups=num_groups, row_chunk=row_chunk, axis=axis)
    return triple_from_sigma(sigma, schema.num_cols)


def build_vocab_sharded(cat_data, mesh=None) -> tuple[tuple[int, ...], ...]:
    """Distributed vocab build: per-shard sort-unique, host union — the
    analogue of build_list_of_uniq_categoricals (partition.cpp:722-747).
    On a single controller this is a host unique; across processes each
    host contributes its local uniques and the union is broadcast (tiny)."""
    cat_data = np.asarray(cat_data)
    return tuple(tuple(int(v) for v in np.unique(cat_data[j]))
                 for j in range(cat_data.shape[0]))


def factorized_join_sum_sharded(x1=None, codes1=None, keys1=None,
                                x2=None, codes2=None, keys2=None, *,
                                schema1: FeatureSchema,
                                schema2: FeatureSchema,
                                num_keys: int, weights1=None, weights2=None,
                                mesh=None,
                                row_chunk: int = DEFAULT_ROW_CHUNK,
                                axis: str = DATA_AXIS) -> Triple:
    """Sharded factorized join-aggregate: each side's rows are sharded over
    the mesh; per-key partial triples are built shard-locally and psum'd
    (one collective per side), then the product-sum over join keys runs as
    replicated contractions (ring.triple.factorized_join_sum) — the
    [G]-batched triples are tiny next to the row data, so the join itself
    costs no communication at all."""
    from ..ring.triple import factorized_join_sum
    mesh = mesh or make_mesh()
    t1 = sum_to_triple_grouped_sharded(
        x1, codes1, keys1, schema=schema1, num_groups=num_keys,
        weights=weights1, mesh=mesh, row_chunk=row_chunk, axis=axis)
    t2 = sum_to_triple_grouped_sharded(
        x2, codes2, keys2, schema=schema2, num_groups=num_keys,
        weights=weights2, mesh=mesh, row_chunk=row_chunk, axis=axis)
    return factorized_join_sum(t1, t2)
