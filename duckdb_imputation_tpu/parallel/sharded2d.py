"""2D-sharded cofactor aggregation: rows over 'data', sigma columns over
'model'.

For very wide one-hot expansions (large total vocab V), the P×P sigma
itself becomes big (P = 1+d+V; V=64k ⇒ 16GB f32). SURVEY.md §2 item 2: shard
the Gram output over a model axis. Each model shard owns a contiguous slice
of the vocab (and therefore of sigma's columns):

    S[:, cols_m] = Zᵀ · diag(w) · Z[:, cols_m]

Every (data, model) device builds the full-height Zᵀ for its row shard (the
one-hot build is compute, not memory — it never materializes beyond one
row chunk) but only the `cols_m` slice of the right operand; the psum over
'data' yields sigma column-sharded over 'model'. Communication: one psum of
P × (P/M) per shard — a reduce-scatter of the full sigma in effect.

The column slicing runs per-chunk inside the same streaming scan as the
1D path, so the overlap requirement (exchange of partial triples overlapped
with next-chunk compute, SURVEY §2 item 5) is handled by XLA's scheduler:
the per-chunk partial sums are independent of the collective until the final
psum, which overlaps with the epilogue of the scan automatically; for the
tiny 1D sigma the collective is 64KB and latency-hidden entirely.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..schema import FeatureSchema
from ..ring.sum import DEFAULT_ROW_CHUNK, _pad_cols, _zt_block
from ..ring.triple import Triple, triple_from_sigma


def make_mesh_2d(n_data: int, n_model: int,
                 axes=("data", "model")) -> Mesh:
    devs = np.asarray(jax.devices()[:n_data * n_model]).reshape(
        n_data, n_model)
    return Mesh(devs, axes)


@functools.partial(jax.jit, static_argnames=("schema", "mesh", "row_chunk"))
def _sigma_2d(x_num, codes, weights, *, schema: FeatureSchema, mesh,
              row_chunk: int):
    p = schema.sigma_size
    n_model = mesh.shape["model"]
    cols_per = -(-p // n_model)        # ceil; last shard zero-padded

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(None, "data"), P(None, "data"), P("data")),
        out_specs=P(None, "model"),
    )
    def local(xn, cd, w):
        m = jax.lax.axis_index("model")
        lo = m * cols_per
        zt = _zt_block(xn, cd, schema)                    # [P, n_local]
        zt_pad = jnp.pad(zt, ((0, cols_per * n_model - p), (0, 0)))
        cols = jax.lax.dynamic_slice_in_dim(zt_pad, lo, cols_per, axis=0)
        block = jax.lax.dot_general(
            zt * w[None, :], cols, (((1,), (1,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32)            # [P, cols_per]
        return jax.lax.psum(block, "data")

    return local(x_num, codes, weights)


def sum_to_triple_sharded2d(x_num=None, codes=None, weights=None, *,
                            schema: FeatureSchema, mesh: Mesh,
                            row_chunk: int = DEFAULT_ROW_CHUNK) -> Triple:
    """Aggregate with rows sharded over 'data' and sigma columns over
    'model', returned as a Triple view of the sharded sigma (the slice runs
    on-device — no host round trip). Production wide-V flows skip the
    Triple view and feed `parallel.wide.sigma_wide` straight into the
    column-sharded CG solver (`parallel.wide.cg_solve_wide`), which keeps
    per-device sigma memory at P × (P/M) through the entire solve."""
    from .wide import sigma_wide  # local import: wide.py builds on _sigma_2d
    sigma_cols = sigma_wide(x_num, codes, weights, schema=schema, mesh=mesh,
                            row_chunk=row_chunk)
    return triple_from_sigma(sigma_cols[:, :schema.sigma_size],
                             schema.num_cols)
