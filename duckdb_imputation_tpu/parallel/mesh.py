"""Device-mesh helpers.

The reference's only parallelism is DuckDB's intra-process morsel-driven
aggregation (per-thread SumStates merged by SumStateCombine,
sum_state.cpp:10-114); there is no distributed backend at all (SURVEY.md §2).
The equivalent here: a 1-D jax.sharding.Mesh over the devices; rows are
sharded over the 'data' axis, partial triples are psum'd across devices —
the combine step becomes an XLA collective.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


DATA_AXIS = "data"


def make_mesh(n_devices: int | None = None, axis: str = DATA_AXIS) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def row_sharding(mesh: Mesh, axis: str = DATA_AXIS) -> NamedSharding:
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
