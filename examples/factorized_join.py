"""Factorized learning over a join — the reference README's headline
example (README.md:160-176): per-join-key triples are aggregated on each
side, multiplied along the join, and ring-summed; a model then trains on
the joined data WITHOUT ever materializing the join.

Shown both ways:
  * through the SQL front-end, with the README query verbatim;
  * through the direct API (sum_to_triple(group_by) → multiply → sum),
    checked against the materialized join.

    python examples/factorized_join.py [--rows 100000] [--keys 64]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from duckdb_imputation_tpu import api, sql


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=100_000)
    ap.add_argument("--keys", type=int, default=64)
    args = ap.parse_args()
    rng = np.random.default_rng(0)

    # two tables sharing a join key `gb`
    n1, n2 = args.rows, args.rows // 2
    gb1 = rng.integers(0, args.keys, n1).astype(np.int64)
    b = rng.normal(size=n1).astype(np.float32)
    c1 = rng.normal(size=n1).astype(np.float32)
    d = rng.integers(0, 4, n1).astype(np.int64) * 2
    gb2 = rng.integers(0, args.keys, n2).astype(np.int64)
    a = rng.normal(size=n2).astype(np.float32)
    c2 = rng.normal(size=n2).astype(np.float32)
    f = rng.integers(0, 3, n2).astype(np.int64) * 5

    # ---- SQL: the README query shape -------------------------------------
    con = sql.connect()
    con.register("test1", {"gb": gb1, "b": b, "c": c1, "d": d})
    con.register("test2", {"gb": gb2, "a": a, "c": c2, "f": f})
    res = con.execute(
        "select sum_triple(multiply_triple(A,B)) FROM "
        "(SELECT gb as gb, sum_to_triple_2_1(b,c,d) AS A "
        " FROM test1 GROUP BY gb) as t1 "
        "INNER JOIN "
        "(SELECT gb as gb, sum_to_triple_2_1(a,c,f) AS B "
        " FROM test2 GROUP BY gb) as t2 "
        "on t1.gb = t2.gb").fetchone()[0]
    print(f"SQL factorized join triple: N={res['N']} "
          f"lin={['%.1f' % v for v in res['lin_agg']]}")

    # ---- direct API: grouped triples → fused contraction over keys -------
    # factorized_sum ≡ sum_triple(multiply_triple(A, B)) over all keys, as a
    # handful of matmuls — no per-key products ever materialize.
    t1 = api.sum_to_triple(b, c1, d, group_by=gb1, num_groups=args.keys)
    t2 = api.sum_to_triple(a, c2, f, group_by=gb2, num_groups=args.keys)
    total = api.factorized_sum(t1, t2)
    print(f"API factorized join triple:  N={float(np.asarray(total.triple.n)):.0f}")

    # sanity: N equals the materialized join's row count
    counts1 = np.bincount(gb1, minlength=args.keys)
    counts2 = np.bincount(gb2, minlength=args.keys)
    n_join = int((counts1 * counts2).sum())
    assert res["N"] == n_join, (res["N"], n_join)
    assert int(np.asarray(total.triple.n)) == n_join
    print(f"matches materialized join row count: {n_join}")


if __name__ == "__main__":
    main()
