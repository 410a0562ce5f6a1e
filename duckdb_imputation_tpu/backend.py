"""The one backend dispatch: which implementation an `'auto'` choice gets.

Every entry point that takes `kernel=` / `backend=` consults this module
instead of testing `jax.default_backend()` itself. Two aggregation
implementations exist:

  'xla'    — `ring.sum.masked_sigma`, plain jax.numpy; correct on every
             backend and the reference every kernel is checked against;
  'triton' — `ring.kernels.sigma_triton`, the Pallas Gram kernel for the
             GPU (Triton route). It runs on the CPU only under
             `interpret=True`.

`'auto'` resolves to 'triton' on a GPU when the schema's Gram width fits
the kernel's register accumulator (`GRAM_MAX_P`), and to 'xla' otherwise.

The entry points that consult it are the ungrouped aggregations:
`sum_to_triple`, `sum_to_triple_sharded`, the MICE loops (single-device,
delta, sharded, out-of-core) and `mice_column_step_device`. The grouped
aggregations (`sum_to_triple_grouped`, `sum_to_nb_agg_grouped`, their
sharded twins) and the star-join fact aggregation run on XLA only: the
Gram kernel produces one aggregate per call, and a one-pass grouped
kernel for the GPU is not written yet (ROADMAP).
"""
from __future__ import annotations

import jax

from .ring.kernels.sigma_triton import MAX_P as GRAM_MAX_P

AGG_KERNELS = ("auto", "xla", "triton")


def resolve_kernel(kernel: str, sigma_size: int, *,
                   interpret: bool = False,
                   platform: str | None = None) -> str:
    """'auto' | 'xla' | 'triton' -> the concrete kernel for this call.

    sigma_size: P of the aggregate. platform: defaults to
    jax.default_backend(). An explicit 'triton' off the GPU raises unless
    `interpret=True` asks for the Pallas interpreter."""
    if kernel not in AGG_KERNELS:
        raise ValueError(f"unknown aggregation kernel {kernel!r}; valid "
                         f"choices are {', '.join(map(repr, AGG_KERNELS))}")
    platform = platform or jax.default_backend()
    if kernel == "auto":
        return ("triton" if platform == "gpu" and sigma_size <= GRAM_MAX_P
                else "xla")
    if kernel == "triton":
        if sigma_size > GRAM_MAX_P:
            raise ValueError(f"the triton Gram kernel takes P <= "
                             f"{GRAM_MAX_P}; this schema has P = "
                             f"{sigma_size} (use kernel='xla' or 'auto')")
        if platform != "gpu" and not interpret:
            raise ValueError(f"kernel='triton' needs a GPU (backend is "
                             f"{platform!r}); pass interpret=True to run "
                             f"it in the Pallas interpreter")
    return kernel
