"""Production MICE — the multi-device path with crash recovery.

Drives `run_mice_sharded`: every device aggregates its row shard of a
`jax.sharding.Mesh` data axis and one psum combines the partial sigmas
before the replicated solve (the analogue of the reference's per-thread
SumState merge, sum_state.cpp:10-114, with the all-reduce as the
combine). Round-boundary checkpointing makes a killed run resume onto the
identical trajectory (noise keys fold global rounds). kernel='auto'
picks the Gram kernel on a GPU and the XLA aggregation elsewhere.

    python examples/production_mice.py [--rows 200000] [--iters 5]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np

from duckdb_imputation_tpu.mice.sharded_round import run_mice_sharded
from duckdb_imputation_tpu.parallel import make_mesh
from duckdb_imputation_tpu.table import from_numpy


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=200_000)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--noise", action="store_true",
                    help="stochastic-regression imputation")
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    n = args.rows
    z = rng.normal(size=(n, 2))
    num = np.stack([z[:, 0], 2 * z[:, 0] + z[:, 1], z[:, 1] - z[:, 0],
                    rng.normal(size=n)], 1).astype(np.float32)
    cat = ((z[:, 0] > 0).astype(int) * 3 + 4)[:, None]
    nn = np.zeros_like(num, bool)
    cn = np.zeros_like(cat, bool)
    nn[rng.choice(n, n // 5, False), 1] = True
    cn[rng.choice(n, n // 5, False), 0] = True

    mesh = make_mesh()
    print(f"devices: {len(jax.devices())} ({jax.default_backend()}), "
          f"mesh {dict(zip(mesh.axis_names, mesh.devices.shape))}")

    ckpt = os.path.join(tempfile.gettempdir(), "production_mice.ckpt")
    if os.path.exists(ckpt):
        os.remove(ckpt)
    out = run_mice_sharded(
        from_numpy(num, cat, nn, cn), iters=args.iters, mesh=mesh,
        noise=args.noise, checkpoint_path=ckpt)

    xs = np.asarray(out.num_data)
    truth = num[nn[:, 1], 1]
    rmse = float(np.sqrt(np.mean((xs[1, nn[:, 1]] - truth) ** 2)))
    acc = float((np.asarray(out.cat_codes)[0, cn[:, 0]]
                 == (z[cn[:, 0], 0] > 0).astype(int)).mean())
    print(f"imputed rmse (x1 | exact relation): {rmse:.2e}")
    print(f"imputed categorical accuracy: {acc:.3f}")

    # the checkpoint now holds the finished run: calling again returns
    # instantly from the final snapshot (crash-recovery demonstration)
    out2 = run_mice_sharded(
        from_numpy(num, cat, nn, cn), iters=args.iters, mesh=mesh,
        noise=args.noise, checkpoint_path=ckpt)
    assert np.array_equal(np.asarray(out2.num_data), xs)
    print("resume-from-checkpoint: identical result")
    os.remove(ckpt)


if __name__ == "__main__":
    main()
