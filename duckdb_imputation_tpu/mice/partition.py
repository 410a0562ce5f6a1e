"""MICE partitioning & initialization — masks instead of physical tables.

The reference materializes physical partition tables:
  - `init_baseline` (partition.cpp:671-719): one `t_complete` table with
    mean/mode-filled nulls + `<col>_IS_NULL` flag columns.
  - `partition` (partition.cpp:77-237): splits by per-row null count into
    t_complete_0 (0 nulls), t_complete_<col> (exactly 1, in col),
    t_complete_2 (2..k-1), t_complete_3 (all null).
  - `partition_inverse` (partition.cpp:295-549): the mirror for the
    high-missing regime keyed on n_not_nulls.

Here the table is a pytree of device arrays, so partitions are mask
predicates fused into the aggregation kernel; nothing is copied. For the
delta aggregates (low/high regimes) we additionally precompute per-column
dirty-row GATHERS (host, once — null positions never change) so a delta
scan costs O(dirty rows), matching the reference's point of running the
delta over small partitions only.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..table.table import Table


def init_fill(t: Table) -> Table:
    """Mean-fill numeric nulls, mode-fill categorical nulls
    (AVG/MODE fill of partition.cpp:42-57, init_baseline :671-719)."""
    num = np.asarray(t.num_data, np.float64)
    nmask = np.asarray(t.num_null)
    for j in range(num.shape[0]):
        obs = num[j, ~nmask[j]]
        mean = float(obs.mean()) if len(obs) else 0.0
        num[j, nmask[j]] = mean
    codes = np.asarray(t.cat_codes).copy()
    cmask = np.asarray(t.cat_null)
    for j in range(codes.shape[0]):
        obs = codes[j, ~cmask[j]]
        if len(obs):
            mode = int(np.bincount(obs).argmax())
        else:
            mode = 0
        codes[j, cmask[j]] = mode
    return dataclasses.replace(
        t,
        num_data=jnp.asarray(num, jnp.float32),
        cat_codes=jnp.asarray(codes, jnp.int32))


@dataclasses.dataclass(frozen=True)
class Partitions:
    """Precomputed partition structure (host indices, static per table)."""
    null_counts: np.ndarray            # i32[n] per-row null count
    num_dirty_idx: tuple[np.ndarray, ...]  # rows where num col j is null
    cat_dirty_idx: tuple[np.ndarray, ...]
    complete_idx: np.ndarray           # rows with 0 nulls (t_complete_0)
    all_null_idx: np.ndarray           # rows with every nullable col null


def build_partitions(t: Table) -> Partitions:
    nmask = np.asarray(t.num_null)
    cmask = np.asarray(t.cat_null)
    counts = nmask.sum(0) + cmask.sum(0)
    total_cols = nmask.shape[0] + cmask.shape[0]
    return Partitions(
        null_counts=counts.astype(np.int32),
        num_dirty_idx=tuple(np.nonzero(nmask[j])[0]
                            for j in range(nmask.shape[0])),
        cat_dirty_idx=tuple(np.nonzero(cmask[j])[0]
                            for j in range(cmask.shape[0])),
        complete_idx=np.nonzero(counts == 0)[0],
        all_null_idx=np.nonzero(counts == total_cols)[0],
    )


def observed_weights(t: Table, kind: str, j: int) -> jax.Array:
    """w[n] = 1 where column j (numeric if kind=='num') is observed — the
    `WHERE <col>_IS_NULL IS FALSE` predicate (imputation_base.cpp:29,100)."""
    mask = t.num_null[j] if kind == "num" else t.cat_null[j]
    return 1.0 - mask.astype(jnp.float32)


def gather_rows(t: Table, idx: np.ndarray) -> tuple[jax.Array, jax.Array]:
    """Gather (num_data, cat_codes) for a dirty-row subset."""
    idx = jnp.asarray(idx)
    return t.num_data[:, idx], t.cat_codes[:, idx]
