"""Factorized imputation over a star schema — the flight/retailer-style
experiment the reference declares drivers for
(imputation/include/factorized_imputation_flight.h / retailer.h; the .cpp
bodies are absent upstream — SURVEY.md §2 L4).

A fact table (flights) references a dimension table (airports). The fact
column to impute depends on dimension attributes, so good imputation
requires training over the JOIN — which factorized MICE does without ever
materializing it: the dimension side is ring-aggregated once per key, each
round's training triple is (grouped fact aggregate) x (dim aggregate)
contracted over the key axis as matrix products.

    python examples/factorized_imputation.py [--rows 1000000] [--keys 512]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from duckdb_imputation_tpu.table import from_numpy
from duckdb_imputation_tpu.mice import init_fill, run_mice_factorized


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--keys", type=int, default=512)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()
    rng = np.random.default_rng(0)

    # dimension: airports(key) -> elevation (num), region (cat)
    elev = (rng.normal(size=args.keys) * 3.0).astype(np.float32)
    region = rng.integers(0, 8, args.keys).astype(np.int64)
    dim = from_numpy(elev[:, None], region[:, None],
                     num_names=("elevation",), cat_names=("region",))

    # fact: flights(airport_key, delay, distance, carrier)
    n = args.rows
    fk = rng.integers(0, args.keys, n)
    distance = rng.normal(size=n).astype(np.float32)
    carrier = rng.integers(0, 5, n).astype(np.int64)
    delay = (2.0 * elev[fk] + 0.3 * distance
             + rng.normal(size=n).astype(np.float32) * 0.1).astype(np.float32)

    num_null = np.zeros((n, 2), bool)
    miss = rng.choice(n, n // 5, replace=False)
    num_null[miss, 0] = True   # 20% of delays missing
    fact = from_numpy(np.stack([delay, distance], 1), carrier[:, None],
                      num_null, np.zeros((n, 1), bool),
                      num_names=("delay", "distance"),
                      cat_names=("carrier",))

    t0 = time.perf_counter()
    out = run_mice_factorized(fact, fk, dim, iters=args.iters,
                              linreg_iters=500, noise=False)
    np.asarray(out.num_data)  # force
    t1 = time.perf_counter()

    filled = init_fill(fact)
    def rmse(t):
        return float(np.sqrt(np.mean(
            (np.asarray(t.num_data)[0, miss] - delay[miss]) ** 2)))
    print(f"rows={n:,} keys={args.keys} iters={args.iters}  "
          f"wall={t1 - t0:.2f}s")
    print(f"RMSE mean-fill: {rmse(filled):.4f}")
    print(f"RMSE factorized MICE: {rmse(out):.4f} "
          f"(join never materialized; logical join rows = fact rows)")


if __name__ == "__main__":
    main()
