"""Multi-host orchestration.

The reference is single-process (SURVEY.md §2: no MPI/NCCL/RPC anywhere).
The multi-host story is JAX's multi-controller runtime: every host runs the
same program, `jax.distributed.initialize` wires the processes, and the
mesh spans hosts × devices. Everything else in this framework is already
multi-host-shaped:

  * the aggregation kernels run under shard_map with a 'data' axis — the
    psum spans every process's devices with no code change;
  * per-host rows enter through `host_local_table` (each host loads its own
    CSV shard via the native loader; `make_global_arrays` assembles the
    jax.Array view);
  * the vocabulary union is the only host-level exchange (tiny:
    per-column sorted uniques), done via process_allgather;
  * model params are a small float vector — replicated by construction
    (the solve happens identically on every host from the psum'd sigma).

MICE's per-column sequential dependency makes the loop latency-bound at
scale (SURVEY §7 hard part 5); the fused device loop (mice/device_round.py)
keeps the whole round on-device so the only host sync is the final fetch.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Wire the multi-controller runtime (no-op on a single process). On
    hosts with no cluster environment pass coordinator_address
    ('host:port'), num_processes and process_id explicitly."""
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)


def global_mesh(axis: str = "data") -> Mesh:
    """1-D mesh over every chip of every host."""
    return Mesh(np.asarray(jax.devices()), (axis,))


def union_vocab(local_keys: tuple[tuple[int, ...], ...]):
    """Union per-column vocabularies across processes — the distributed
    `build_list_of_uniq_categoricals`. Uses process_allgather of the (tiny)
    per-host unique arrays; single-process this is the identity.

    Keys are i32 (the framework's category-code dtype). Per-process lengths
    are gathered explicitly and each process's prefix sliced out — a pad
    SENTINEL would be unsafe: under x32 process_allgather truncates int64,
    so INT64_MIN silently becomes 0 and leaks a phantom category (found by
    tests/test_multihost.py on the first real 2-process run)."""
    if jax.process_count() == 1:
        return local_keys
    from jax.experimental import multihost_utils

    nproc = jax.process_count()
    out = []
    for keys in local_keys:
        arr = np.asarray(keys, np.int32)
        ns = np.asarray(multihost_utils.process_allgather(
            np.asarray([len(arr)], np.int32))).reshape(nproc)
        max_n = max(int(ns.max()), 1)
        pad = np.zeros(max_n, np.int32)
        pad[:len(arr)] = arr
        gathered = np.asarray(
            multihost_utils.process_allgather(pad)).reshape(nproc, max_n)
        vals = np.unique(np.concatenate(
            [gathered[p, :int(ns[p])] for p in range(nproc)]))
        out.append(tuple(int(v) for v in vals))
    return tuple(out)


def make_global_arrays(mesh: Mesh, x_local, codes_local, weights_local,
                       axis: str = "data"):
    """Assemble per-host row shards into global jax.Arrays sharded over the
    mesh data axis (features-first: sharding on the trailing axis)."""
    from jax.experimental import multihost_utils

    col_sh = NamedSharding(mesh, P(None, axis))
    row_sh = NamedSharding(mesh, P(axis))
    if jax.process_count() == 1:
        return (jax.device_put(x_local, col_sh),
                jax.device_put(codes_local, col_sh),
                jax.device_put(weights_local, row_sh))
    return (multihost_utils.host_local_array_to_global_array(
                x_local, mesh, P(None, axis)),
            multihost_utils.host_local_array_to_global_array(
                codes_local, mesh, P(None, axis)),
            multihost_utils.host_local_array_to_global_array(
                weights_local, mesh, P(axis)))
