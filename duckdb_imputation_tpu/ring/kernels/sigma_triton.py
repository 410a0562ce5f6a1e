"""Masked Gram aggregation S = Zᵀ·diag(w)·Z as one Pallas kernel (Triton
route), the GPU twin of `ring.sum.masked_sigma`.

The XLA path builds the one-hot Zᵀ block (P × chunk f32) in device memory
for every row chunk and contracts it there. This kernel moves only the
input columns: each program walks a strided set of row blocks, builds the
Zᵀ tile of a block in registers and accumulates Zw·Zᵀ into a P×P
register accumulator.

  * Grid: PROGRAMS programs (a few per SM). Program i takes row blocks
    i, i + PROGRAMS, i + 2·PROGRAMS, … in an in-kernel loop; blocks carry
    nothing between them.
  * Tile: rows of Zᵀ are [1 | x_0..x_{d-1} | one-hot(cat_0) | …], padded
    to PP = a power of two ≥ 16. A one-hot row is a compare of the codes
    with the row iota; codes outside [0, size) hit no row (the
    `find_in_array` miss convention of `onehot_block_t`).
  * Output: each program writes its partial P×P; one XLA sum in a fixed
    order combines them (no atomics, so results are deterministic and
    counts are exact integers below 2^24).
  * Precision: the product is a full-f32 dot (Triton's IEEE input
    precision, on FMA units), chosen for speed at the kernel's tiles: a
    TF32×3 split was slower in every H100 probe, and a single TF32 pass,
    though faster, misses the 1e-4 parity bound (its inputs keep 10
    mantissa bits, so a column near 1.0003 reads as 1.0).
  * Accumulation: each block's product starts from zero and joins the
    program's running sum through Kahan compensation. On an H100 a plain
    `acc + dot` behaved as one FMA chain of ~n / PROGRAMS terms per entry
    (the running sum folded into the dot's accumulator): at 100M rows its
    error reached 3.1e-5 of the Cauchy–Schwarz scale, and 1.4e-4 on a
    near-constant column at 10M, against ≤ 1.0e-7 compensated. The
    compensation costs ~4% of a MICE round.

Inputs are the per-column tuples the MICE loops carry, or stacked
features-first blocks (x f32[d, n], codes i32[c, n]); both are read in
place. Stacked blocks go through one flat ref per kind (column j at
offset j·n): slicing them into per-column arrays copies every column,
12-19% of the kernel's time at 100M rows on an H100. `interpret=True`
runs the kernel in the Pallas interpreter (CPU).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ...schema import FeatureSchema

# Rows per block by padded width: the Zᵀ tile (PP × block) and the PP×PP
# accumulator share a program's registers.
_BLOCK_ROWS = {16: 512, 32: 128, 64: 64}
# The widest sigma the kernel takes: its PP×PP f32 accumulator lives in
# the registers of a 4-warp program (32 per thread at 64×64, 128 at the
# next width, before the Zᵀ tile). Wider schemas go to XLA.
MAX_P = max(_BLOCK_ROWS)
# Programs in the grid: four per SM of an H100 (132 SMs).
PROGRAMS = 528


def padded_width(p: int) -> int:
    """PP: P rounded up to a power of two, at least 16 (the smallest dot
    operand dimension the Triton route takes)."""
    return max(16, 1 << (p - 1).bit_length())


def _gram_kernel(*refs, d, c, stacked, bases, sizes, pp, block, n,
                 programs):
    if stacked:
        # one flat ref per kind; column j starts at j·n (a 2-D ref indexed
        # [j, rows] measured ~3× slower on the H100)
        x_ref, c_ref, w_ref, o_ref = refs

        def x_col(j, start, mask):
            return plgpu.load(x_ref.at[pl.ds(j * n + start, block)],
                              mask=mask, other=0.0)

        def code_col(k, start, mask):
            return plgpu.load(c_ref.at[pl.ds(k * n + start, block)],
                              mask=mask, other=-1)
    else:
        x_refs, c_refs = refs[:d], refs[d:d + c]
        w_ref, o_ref = refs[d + c], refs[d + c + 1]

        def x_col(j, start, mask):
            return plgpu.load(x_refs[j].at[pl.ds(start, block)], mask=mask,
                              other=0.0)

        def code_col(k, start, mask):
            return plgpu.load(c_refs[k].at[pl.ds(start, block)], mask=mask,
                              other=-1)

    pid = pl.program_id(0)
    row = lax.broadcasted_iota(jnp.int32, (pp, block), 0)

    def body(i, carry):
        acc, comp = carry
        start = (pid + i * programs) * block
        mask = start + jnp.arange(block) < n
        w = plgpu.load(w_ref.at[pl.ds(start, block)], mask=mask, other=0.0)
        z = jnp.where(row == 0, 1.0, 0.0)
        for j in range(d):
            z = jnp.where(row == 1 + j, x_col(j, start, mask)[None, :], z)
        for k in range(c):
            code = code_col(k, start, mask)
            hit = jnp.where((code >= 0) & (code < sizes[k]),
                            code + bases[k], -1)
            z = jnp.where(row == hit[None, :], 1.0, z)
        y = pl.dot(z * w[None, :], z, trans_b=True,
                   allow_tf32=False) - comp
        total = acc + y
        return total, (total - acc) - y

    n_blocks = pl.cdiv(n, block)
    mine = (n_blocks - pid + programs - 1) // programs
    zeros = jnp.zeros((pp, pp), jnp.float32)
    o_ref[...] = lax.fori_loop(0, mine, body, (zeros, zeros))[0]


def sigma_triton(x_num, codes, weights, *, schema: FeatureSchema,
                 interpret: bool = False) -> jax.Array:
    """S = Zᵀ diag(w) Z, f32[P, P] — same contract as masked_sigma.

    x_num / codes: stacked features-first arrays (f32[d, n] / i32[c, n])
    or tuples of per-column [n] arrays; weights f32[n]. P ≤ MAX_P."""
    return _sigma_gram(x_num, codes, weights, schema=schema,
                       programs=PROGRAMS, interpret=interpret)


@functools.partial(jax.jit,
                   static_argnames=("schema", "programs", "interpret"))
def _sigma_gram(x_num, codes, weights, *, schema, programs, interpret):
    d, c = schema.num_cols, schema.cat_cols
    stacked = not isinstance(x_num, (tuple, list))
    if stacked and max(d, c) * weights.shape[-1] >= 2 ** 31:
        # flat int32 offsets would overflow: read per-column slices
        x_num, codes = tuple(x_num), tuple(codes)
        stacked = False
    if stacked:
        # flattened (a free reshape of the features-first blocks); an
        # empty block becomes a 1-element dummy the kernel never reads
        x_in = (jnp.asarray(x_num, jnp.float32).reshape(-1) if d
                else jnp.zeros((1,), jnp.float32),
                jnp.asarray(codes, jnp.int32).reshape(-1) if c
                else jnp.zeros((1,), jnp.int32))
    else:
        x_in = (tuple(jnp.asarray(a, jnp.float32) for a in x_num)
                + tuple(jnp.asarray(a, jnp.int32) for a in codes))
    weights = jnp.asarray(weights, jnp.float32)
    n = weights.shape[-1]
    p = schema.sigma_size
    pp = padded_width(p)
    block = _BLOCK_ROWS[pp]
    programs = max(1, min(programs, pl.cdiv(n, block)))
    kernel = functools.partial(
        _gram_kernel, d=d, c=c, stacked=stacked,
        bases=tuple(1 + d + o for o in schema.offsets[:-1]),
        sizes=schema.cat_sizes, pp=pp, block=block, n=n, programs=programs)
    partials = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((programs, pp, pp), jnp.float32),
        grid=(programs,),
        out_specs=pl.BlockSpec((None, pp, pp), lambda i: (i, 0, 0)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="sigma_gram",
    )(*x_in, weights)
    return jnp.sum(partials, axis=0)[:p, :p]
