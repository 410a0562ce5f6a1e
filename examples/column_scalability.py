"""Column-scalability experiment — the analogue of the reference's paper
driver `scalability_col_exp` (imputation/include/column_scalability.h; its
.cpp is not in the reference repo — SURVEY.md §2 'dead headers'): measure
MICE round time as the number of columns grows, at fixed row count.

The cost model is explicit: the masked-Gram aggregation is O(n·P²) with
P = 1 + d_num + Σ|vocab|, and each null column adds one aggregation +
train + predict per round.

    python examples/column_scalability.py [--rows 1000000] \
        [--cols 2 4 8 16] [--iters 2]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from duckdb_imputation_tpu.mice.device_round import run_mice_device
from duckdb_imputation_tpu.table import from_numpy


def one_config(n_rows: int, n_cols: int, iters: int, rng) -> float:
    z = rng.normal(size=(n_rows, n_cols)).astype(np.float32)
    # make column 1 predictable from the others
    z[:, 1] = z[:, 0] * 2 + (z[:, 2] if n_cols > 2 else 0.0)
    nn = np.zeros((n_rows, n_cols), bool)
    nn[rng.choice(n_rows, n_rows // 5, False), 1] = True
    t = from_numpy(z, None, nn, None)

    t0 = time.perf_counter()
    out = run_mice_device(t, iters=iters, gd_iters=200, noise=False)
    np.asarray(out.num_data)  # force
    wall = time.perf_counter() - t0
    truth = z[nn[:, 1], 1]
    got = np.asarray(out.num_data)[1, nn[:, 1]]
    rmse = float(np.sqrt(np.mean((got - truth) ** 2)))
    return wall, rmse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--cols", type=int, nargs="+", default=[2, 4, 8, 16])
    ap.add_argument("--iters", type=int, default=2)
    args = ap.parse_args()
    rng = np.random.default_rng(0)

    print(f"{'cols':>6} {'wall_s (incl. compile)':>24} {'rmse':>10}")
    for d in args.cols:
        wall, rmse = one_config(args.rows, d, args.iters, rng)
        print(f"{d:>6} {wall:>24.2f} {rmse:>10.4f}")


if __name__ == "__main__":
    main()
