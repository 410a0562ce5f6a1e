"""Pipeline-overlapped aggregation: per-stripe collectives ride behind
the next stripe's compute.

SURVEY.md §2 (parallelism item 5) asks for the PP/overlap analogue of the
reference's thread combine: "exchange of partial triples overlapped with
next-chunk cofactor compute (double-buffered async collectives)".

For the plain triple the all-reduce payload is one (P, P) f32 — a few KB —
so overlap is irrelevant: XLA hides it entirely behind anything. Overlap
*matters* when the one-hot-expanded width is large (big vocabularies): the
sigma collective is then P×P at megabytes and serializing
[all compute] → [one giant psum] leaves the links idle during compute and
the compute units idle during exchange.

This module pipelines the two: sigma is computed in COLUMN STRIPES
(S[:, lo:lo+w] = Zᵀ diag(w) Z[:, lo:lo+w], exactly as ring/striped.py), and
each stripe is psum'd as soon as it is produced, inside a `lax.scan` within
`shard_map`. Stripe k's all-reduce has no data dependence on stripe k+1's
matmul — the structural property that lets XLA's scheduler issue the
collective asynchronously (all-reduce-start/-done pairs) behind the next
stripe's Gram, i.e. a software-pipelined reduce keeping both compute and
links busy in steady state.

Verification status: the compiled module is checked to carry the
per-stripe [P, P/n_stripes] all-reduce INSIDE the stripe loop rather than
one fused [P, P] collective after all compute
(tests/test_sharded.py::test_overlapped_hlo_has_per_stripe_collectives),
and stripe-k-independence holds by construction. The actual concurrent
issue is XLA scheduler behavior — design intent validated structurally,
not yet a wall-clock measurement across devices.

The result equals the unstriped sharded path up to f32 row-chunk
accumulation order (count-valued sections are exact): striping partitions
sigma's columns, and each column still reduces in the same mesh order.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ..ring.sum import DEFAULT_ROW_CHUNK, _zt_block
from ..ring.triple import Triple, triple_from_sigma
from ..schema import FeatureSchema
from .mesh import DATA_AXIS, make_mesh
from .sharded import _pad_to


@functools.partial(
    jax.jit,
    static_argnames=("schema", "mesh", "n_stripes", "row_chunk", "axis"))
def _sharded_sigma_overlapped(x_num, codes, weights, *,
                              schema: FeatureSchema, mesh, n_stripes: int,
                              row_chunk: int, axis: str):
    p = schema.sigma_size
    width = -(-p // n_stripes)          # ceil — stripes cover [0, p) padded
    p_pad = width * n_stripes

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(None, axis), P(None, axis), P(axis)),
        out_specs=P(),
    )
    def local(xn, cd, w):
        nloc = xn.shape[-1] if xn.shape[0] else cd.shape[-1]
        pad = (-nloc) % row_chunk
        if pad:
            xn = jnp.pad(xn, ((0, 0), (0, pad)))
            cd = jnp.pad(cd, ((0, 0), (0, pad)))
            w = jnp.pad(w, (0, pad))
        nc = (nloc + pad) // row_chunk
        xs = (xn.reshape(xn.shape[0], nc, row_chunk).swapaxes(0, 1)
              if xn.shape[0] else jnp.zeros((nc, 0, row_chunk), xn.dtype),
              cd.reshape(cd.shape[0], nc, row_chunk).swapaxes(0, 1)
              if cd.shape[0] else jnp.zeros((nc, 0, row_chunk), cd.dtype),
              w.reshape(nc, row_chunk))

        def one_stripe(carry, lo):
            def body(acc, chunk):
                xnc, cdc, wc = chunk
                zt = _zt_block(xnc, cdc, schema)                 # [p, rc]
                zt = jnp.pad(zt, ((0, p_pad - p), (0, 0)))
                cols = jax.lax.dynamic_slice_in_dim(zt, lo, width, axis=0)
                s = jax.lax.dot_general(
                    zt[:p] * wc[None, :], cols, (((1,), (1,)), ((), ())),
                    precision=jax.lax.Precision.HIGHEST,
                    preferred_element_type=jnp.float32)
                return acc + s, None

            acc0 = jax.lax.pcast(jnp.zeros((p, width), jnp.float32), (axis,),
                                 to="varying")
            s, _ = jax.lax.scan(body, acc0, xs)
            # the overlap point: this psum is independent of the NEXT
            # stripe's matmuls — XLA issues it asynchronously behind them
            return carry, jax.lax.psum(s, axis)

        los = jnp.arange(n_stripes, dtype=jnp.int32) * width
        _, stripes = jax.lax.scan(one_stripe, jnp.int32(0), los)
        # stripes: [n_stripes, p, width] → [p, n_stripes*width] → [:, :p]
        sigma = jnp.transpose(stripes, (1, 0, 2)).reshape(p, p_pad)
        return sigma[:, :p]

    return local(x_num, codes, weights)


def sum_to_triple_overlapped(x_num=None, codes=None, weights=None, *,
                             schema: FeatureSchema, mesh=None,
                             n_stripes: int = 4,
                             row_chunk: int = DEFAULT_ROW_CHUNK,
                             axis: str = DATA_AXIS) -> Triple:
    """Sharded `sum_to_triple` with the collective pipelined against
    compute in `n_stripes` column stripes. Same result as
    `sum_to_triple_sharded`; preferable when `schema.sigma_size` is large
    enough that the sigma all-reduce is no longer free (wide vocabularies).
    """
    mesh = mesh or make_mesh()
    nd = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
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
    sigma = _sharded_sigma_overlapped(
        x_num, codes, weights, schema=schema, mesh=mesh,
        n_stripes=n_stripes, row_chunk=row_chunk, axis=axis)
    return triple_from_sigma(sigma, schema.num_cols)
