"""On-chip check of the imputation engine on NVIDIA GPUs, in one process.

    python chip_smoke.py             # one GPU: every phase below
    python chip_smoke.py --chips 4   # four GPUs: only the sharded phase

Phases on one GPU (any failure raises, so the exit code is non-zero):

  0. devices: the card's name and power limit (nvidia-smi) and
     jax.devices(); anything but a GPU exits non-zero before any phase;
  1. aggregation parity at 10M rows against float64 numpy for the 4_2,
     4_0, cat-only, shared-bins, out-of-vocab / -1 code, non-binary weight,
     widest (P = 64) and near-constant-column schemas, through
     sum_to_triple (auto) and both aggregations explicitly (the Gram
     kernel and XLA's masked_sigma);
  2. Gram kernel vs XLA timing: standalone sum_to_triple and the MICE
     round (full and delta loops) at 10M and 100M rows, plus a profiler
     trace of one round per aggregation;
  3. the main path at 100M rows: run_mice_device (auto) for 3 rounds;
  4. run_mice_device_delta at 10M rows / 1% dirty vs run_mice_device;
  5. run_mice_device vs the host-f64 run_mice_low at 1M rows;
  6. QDA / NB device train + predict at 10M rows vs the host path;
  7. out-of-core impute_csv_stream(engine='device') on a 10M-row CSV vs
     in-core run_mice_device on the same file;
  8. the CLI (`impute --mode device`) through cli.main, in-process.

The last stdout line is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.

Tolerances (each with its reason):
  * counts (N, one-hot and cat×cat sections, binary weights): exact — sums
    of 0/1 in f32 are exact below 2^24, and every count here is below it;
  * other sigma entries: |S − R| ≤ 1e-4·sqrt(R_ii·R_jj) against the
    float64 reference R — the Cauchy–Schwarz scale of the entry, since an
    off-diagonal sum of random products can sit near 0 while its terms do
    not. Measured at 10M rows on an H100: ≤ 1.0e-7 for the Gram kernel,
    ≤ 3.6e-7 for XLA on random columns and 2.4e-5 on the near-constant
    one;
  * MICE on the exact relation x1 = 3·x0 + x2 (noise=False): rmse < 0.05;
  * device (f32, direct solve) vs host (f64, GD) MICE at 1M rows: imputed
    codes agree on ≥ 99.9% of null rows, imputed numerics within 5e-3
    absolute (both solve the same well-conditioned normal equations; the
    f32 sigma carries ≤ 1e-7 relative error);
  * full vs delta, in-core vs out-of-core, single vs sharded: codes agree
    on ≥ 99.9% of null rows, numerics within 1e-3 absolute. Measured on
    H100s: 5.0e-5 (delta, 10M rows), 1.5e-5 (out-of-core, 10M) and 4.4e-5
    (four cards vs one, 100M). The bound keeps ≥ 20× headroom and still
    catches the 5.3e-3 that an uncompensated f32 accumulation in the Gram
    kernel produced at 100M rows (each program's sum was one FMA chain of
    ~190k terms).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CARD = ""                # "name, power limit" from nvidia-smi


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

def sigma64(x, codes, w, sizes, chunk=1 << 20):
    """Float64 S = Zᵀ diag(w) Z on the host, in row chunks."""
    d, n = x.shape
    p = 1 + d + sum(sizes)
    acc = np.zeros((p, p))
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        rows = [np.ones((1, hi - lo)), x[:, lo:hi].astype(np.float64)]
        for j, s in enumerate(sizes):
            rows.append((codes[j, lo:hi][None, :]
                         == np.arange(s)[:, None]).astype(np.float64))
        z = np.concatenate(rows)
        acc += (z * w[lo:hi].astype(np.float64)) @ z.T
    return acc


def mice_table(n, miss, seed, *, jitter=0.0):
    """4 numeric + 2 categorical (vocab 8) columns on the device, `miss`
    nulls in x1 and cat0. x1 = 3·x0 + x2 (+ jitter·noise); cat0 = the
    octile of x0 (jitter=0) or of x3; cat1 is noise."""
    import jax
    import jax.numpy as jnp

    from duckdb_imputation_tpu import FeatureSchema
    from duckdb_imputation_tpu.table.table import Table

    @jax.jit
    def gen(key):
        k = jax.random.split(key, 7)
        x0 = jax.random.normal(k[0], (n,))
        x2 = jax.random.normal(k[1], (n,))
        x3 = jax.random.normal(k[2], (n,))
        x1 = 3.0 * x0 + x2 + jitter * jax.random.normal(k[3], (n,))
        cuts = jnp.asarray([-1.1503, -0.6745, -0.3186, 0.0, 0.3186, 0.6745,
                            1.1503])
        src = x3 if jitter else x0
        c0 = jnp.searchsorted(cuts, src).astype(jnp.int32)
        c1 = jax.random.randint(k[4], (n,), 0, 8, jnp.int32)
        nn = jnp.zeros((4, n), bool).at[1].set(
            jax.random.uniform(k[5], (n,)) < miss)
        cn = jnp.zeros((2, n), bool).at[0].set(
            jax.random.uniform(k[6], (n,)) < miss)
        return jnp.stack([x0, x1, x2, x3]), jnp.stack([c0, c1]), nn, cn

    x, c, nn, cn = gen(jax.random.PRNGKey(seed))
    schema = FeatureSchema(num_cols=4, cat_keys=(tuple(range(8)),) * 2)
    t = Table(num_data=x, cat_codes=c, num_null=nn, cat_null=cn,
              schema=schema)
    return t, x, c


def compare_imputations(a, b, nn, cn, tol, what):
    """Codes agree on ≥ 99.9% of cat0's null rows; x1's imputed values
    within `tol` absolute."""
    import jax.numpy as jnp

    dx = float(jnp.max(jnp.where(nn[1], jnp.abs(a.num_data[1]
                                                - b.num_data[1]), 0.0)))
    agree = float(jnp.sum((a.cat_codes[0] == b.cat_codes[0]) & cn[0])
                  / jnp.maximum(jnp.sum(cn[0]), 1))
    log(f"  {what}: max |Δx1| = {dx:.3e} (tol {tol}), cat0 agreement "
        f"{agree:.5f}")
    check(dx <= tol, f"{what}: numerics differ by {dx}")
    check(agree >= 0.999, f"{what}: codes agree on {agree}")


def rmse_x1(t, x_true, nn):
    import jax.numpy as jnp
    err = jnp.where(nn[1], t.num_data[1] - x_true[1], 0.0)
    return float(jnp.sqrt(jnp.sum(err * err) / jnp.sum(nn[1])))


def timed(fn, reps=5):
    """Median wall time (s) of fn() to completion, after one warm-up."""
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

PARITY = {
    # name: (d, cat sizes, weights, code range)
    "4_2": (4, (8, 8), "binary", (0, 8)),
    "4_0": (4, (), "binary", None),
    "cat_only": (0, (8, 8), "binary", (0, 8)),
    "shared_bins": (1, (3, 3, 4), "binary", (0, 3)),
    "oov_codes": (4, (8, 8), "binary", (-1, 10)),
    "weighted": (4, (8, 8), "real", (0, 8)),
    "widest_p64": (8, (20, 20, 15), "binary", (0, 20)),
    # x0 concentrated near 1.0003. Random columns barely tell TF32-rounded
    # inputs from full f32 (1.1e-4 at 10M rows), this one by 6×: TF32
    # reads every x0 as 1.0. It also exposes a biased f32 accumulation
    # (an uncompensated Gram kernel reached 1.4e-4)
    "near_const": (4, (8, 8), "binary", (0, 8)),
}


def phase_parity(n=10_000_000):
    import jax

    from duckdb_imputation_tpu import FeatureSchema
    from duckdb_imputation_tpu.ring.kernels.sigma_triton import sigma_triton
    from duckdb_imputation_tpu.ring.sum import masked_sigma, sum_to_triple
    from duckdb_imputation_tpu.ring.triple import sigma_from_triple

    log(f"[1] aggregation parity at {n} rows vs float64")
    rng = np.random.default_rng(11)
    for name, (d, sizes, wkind, crange) in PARITY.items():
        x = rng.normal(size=(d, n)).astype(np.float32)
        if name == "near_const":
            x[0] = (1.0003 + 1e-5 * rng.normal(size=n)).astype(np.float32)
        codes = (rng.integers(*crange, size=(len(sizes), n)).astype(np.int32)
                 if sizes else np.zeros((0, n), np.int32))
        w = ((rng.random(n) > 0.2).astype(np.float32) if wkind == "binary"
             else (rng.random(n) * 3.0).astype(np.float32))
        schema = FeatureSchema(num_cols=d,
                               cat_keys=tuple(tuple(range(s))
                                              for s in sizes))
        ref = sigma64(x, codes, w, sizes)
        xd, cd, wd = (jax.device_put(a) for a in (x, codes, w))
        got = {
            "auto": sigma_from_triple(sum_to_triple(xd, cd, wd,
                                                    schema=schema)),
            "triton": sigma_triton(xd, cd, wd, schema=schema),
            "triton_cols": sigma_triton(tuple(xd), tuple(cd), wd,
                                        schema=schema),
            "xla": masked_sigma(xd, cd, wd, schema=schema),
        }
        p = schema.sigma_size
        cnt = np.zeros(p, bool)
        cnt[0] = True
        cnt[1 + d:] = True
        cb = np.ix_(cnt, cnt)
        diag = np.sqrt(np.maximum(np.diag(ref), 1e-30))
        scale = np.outer(diag, diag)
        for how, s in got.items():
            s = np.asarray(s, np.float64)
            check(s.shape == (p, p), f"{name}/{how}: shape {s.shape}")
            check(np.isfinite(s).all(), f"{name}/{how}: non-finite sigma")
            rel = float(np.max(np.abs(s - ref) / scale))
            exact = (wkind != "binary"
                     or bool(np.array_equal(s[cb], ref[cb])))
            log(f"  {name:<11} P={p:<3} {how:<11} max rel err {rel:.2e} "
                f"counts exact {exact}")
            check(exact, f"{name}/{how}: counts differ from float64")
            check(rel <= 1e-4, f"{name}/{how}: relative error {rel}")


def _device_tables(n):
    """Stacked 4_2 and 4_0 inputs generated on the device."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def gen(key):
        k = jax.random.split(key, 3)
        return (jax.random.normal(k[0], (4, n), jnp.float32),
                jax.random.randint(k[1], (2, n), 0, 8, jnp.int32),
                (jax.random.uniform(k[2], (n,)) > 0.2).astype(jnp.float32))
    return gen(jax.random.PRNGKey(n % 9973))


def _round_seconds(loop, args, kw, k_lo=1, k_hi=5, reps=3):
    """Per-round device time of a jitted MICE loop: the median of
    (T(k_hi rounds) − T(k_lo rounds)) / (k_hi − k_lo); the loop donates
    its table, so every call gets fresh copies."""
    import jax
    import jax.numpy as jnp

    x, c, *rest = args

    def run(k):
        out = loop(x + 0.0, c + 0, *rest, iters=jnp.int32(k), **kw)
        jax.block_until_ready(out)

    run(k_lo)
    run(k_hi)
    per = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run(k_hi)
        t_hi = time.perf_counter() - t0
        t0 = time.perf_counter()
        run(k_lo)
        t_lo = time.perf_counter() - t0
        per.append((t_hi - t_lo) / (k_hi - k_lo))
    return float(np.median(per))


def phase_timing(out_dir, sizes=(10_000_000, 100_000_000),
                 trace_rows=10_000_000):
    import jax
    import jax.numpy as jnp

    from duckdb_imputation_tpu import FeatureSchema
    from duckdb_imputation_tpu.mice.device_round import (
        build_union_gather, mice_loop_device, mice_loop_device_delta)
    from duckdb_imputation_tpu.ring.sum import sum_to_triple
    from duckdb_imputation_tpu.utils.profiling import (device_op_times,
                                                       device_trace)

    log(f"[2] Gram kernel vs XLA timing on {CARD}")
    s42 = FeatureSchema(num_cols=4, cat_keys=(tuple(range(8)),) * 2)
    s40 = FeatureSchema(num_cols=4)
    results = {}
    for n in sizes:
        x, c, w = _device_tables(n)
        for sname, schema, cc in (("4_2", s42, c), ("4_0", s40, c[:0])):
            for kern in ("triton", "xla"):
                sec = timed(lambda: sum_to_triple(x, cc, w, schema=schema,
                                                  backend=kern))
                results[f"sum_to_triple_{sname}_{n}_{kern}_ms"] = sec * 1e3
                log(f"  sum_to_triple {sname} rows={n} {kern}: "
                    f"{sec * 1e3:.3f} ms  ({CARD})")
        del x, c, w

        t, _, _ = mice_table(n, 0.2, seed=3)
        key = jax.random.PRNGKey(0)
        args = (t.num_data, t.cat_codes, t.num_null, t.cat_null, key)
        for kern in ("triton", "xla"):
            kw = dict(schema=s42, num_cols_to_impute=(1,),
                      cat_cols_to_impute=(0,), kernel=kern)
            sec = _round_seconds(mice_loop_device, args, kw)
            results[f"mice_round_{n}_{kern}_ms"] = sec * 1e3
            log(f"  MICE round (run_mice_device loop, 1 num + 1 cat null "
                f"col) rows={n} {kern}: {sec * 1e3:.3f} ms  ({CARD})")
        # delta loop at 1% dirty
        t, _, _ = mice_table(n, 0.01, seed=4)
        idx = [np.nonzero(np.asarray(t.num_null[1]))[0],
               np.nonzero(np.asarray(t.cat_null[0]))[0]]
        ui, uv = build_union_gather(idx)
        args = (t.num_data, t.cat_codes, t.num_null, t.cat_null, key, ui, uv)
        for kern in ("triton", "xla"):
            kw = dict(schema=s42, num_cols_to_impute=(1,),
                      cat_cols_to_impute=(0,), kernel=kern)
            sec = _round_seconds(mice_loop_device_delta, args, kw)
            results[f"mice_delta_round_{n}_{kern}_ms"] = sec * 1e3
            log(f"  delta-MICE round (run_mice_device_delta loop, 1% "
                f"dirty) rows={n} {kern}: {sec * 1e3:.3f} ms  ({CARD})")
        del t, args

    # one traced window of 2 rounds per aggregation
    n = trace_rows
    t = mice_table(n, 0.2, seed=3)[0] if n else None
    for kern in ("triton", "xla") if n else ():
        kw = dict(schema=s42, num_cols_to_impute=(1,),
                  cat_cols_to_impute=(0,), kernel=kern)

        def two_rounds():
            return mice_loop_device(t.num_data + 0.0, t.cat_codes + 0,
                                    t.num_null, t.cat_null,
                                    jax.random.PRNGKey(0),
                                    iters=jnp.int32(2), **kw)
        jax.block_until_ready(two_rounds())
        tdir = os.path.join(out_dir, f"trace_round_{kern}")
        with device_trace(tdir):
            jax.block_until_ready(two_rounds())
        rep = device_op_times(tdir)
        top = sorted(rep["per_op_s"].items(), key=lambda kv: -kv[1])[:6]
        agg = sum(v for k, v in rep["per_op_s"].items()
                  if "sigma_gram" in k or "masked_sigma" in k
                  or "dot" in k.lower() or "gemm" in k.lower())
        floor = 2 * n * 28 / 3.35e12
        log(f"  trace 2 rounds {kern} rows={n}: window "
            f"{rep['window_s'] * 1e3:.3f} ms, busy "
            f"{rep['busy_s'] * 1e3:.3f} ms, aggregation ops "
            f"{agg * 1e3:.3f} ms (28 B/row floor for 4 aggregations "
            f"{2 * floor * 1e3:.3f} ms)  ({CARD})")
        for k, v in top:
            log(f"    {v * 1e3:9.3f} ms  {k[:90]}")
    with open(os.path.join(out_dir, "timing.json"), "w") as f:
        json.dump({"card": CARD, **results}, f, indent=1)


def phase_main_path(n=100_000_000):
    from duckdb_imputation_tpu.mice.device_round import run_mice_device

    log(f"[3] run_mice_device (auto) at {n} rows, 3 rounds")
    t, x, c = mice_table(n, 0.2, seed=5)
    t0 = time.perf_counter()
    out = run_mice_device(t, iters=3, noise=False)
    out.num_data.block_until_ready()
    sec = time.perf_counter() - t0
    rmse = rmse_x1(out, x, t.num_null)
    acc = float(((out.cat_codes[0] == c[0]) & t.cat_null[0]).sum()
                / t.cat_null[0].sum())
    log(f"  {sec:.2f} s end to end incl. host init fill; x1 rmse "
        f"{rmse:.3e}; cat0 accuracy {acc:.4f}")
    check(rmse < 0.05, f"100M-row MICE rmse {rmse}")
    check(acc > 0.7, f"100M-row MICE cat accuracy {acc}")


def phase_delta(n=10_000_000):
    from duckdb_imputation_tpu.mice.device_round import (
        run_mice_device, run_mice_device_delta)

    log(f"[4] run_mice_device_delta vs run_mice_device at {n} rows, "
        f"1% dirty")
    t, x, _ = mice_table(n, 0.01, seed=6)
    full = run_mice_device(t, iters=3, noise=False)
    delta = run_mice_device_delta(t, iters=3, noise=False)
    log(f"  rmse full {rmse_x1(full, x, t.num_null):.3e}, delta "
        f"{rmse_x1(delta, x, t.num_null):.3e}")
    compare_imputations(delta, full, t.num_null, t.cat_null, 1e-3,
                        "delta vs full")
    check(rmse_x1(delta, x, t.num_null) < 0.05, "delta rmse")


def phase_host_parity(n=1_000_000):
    from duckdb_imputation_tpu.mice import run_mice_low
    from duckdb_imputation_tpu.mice.device_round import run_mice_device

    log(f"[5] run_mice_device vs host-f64 run_mice_low at {n} rows")
    t, _, _ = mice_table(n, 0.2, seed=7, jitter=0.3)
    dev = run_mice_device(t, iters=2, noise=False)
    host = run_mice_low(t, iters=2, noise=False)
    compare_imputations(dev, host, t.num_null, t.cat_null, 5e-3,
                        "device vs host")


def phase_models(n=10_000_000):
    import jax.numpy as jnp

    from duckdb_imputation_tpu import FeatureSchema
    from duckdb_imputation_tpu.models import (nb_predict, nb_train,
                                              qda_predict, qda_train)
    from duckdb_imputation_tpu.models.device import (
        nb_predict_device, nb_train_device, qda_predict_device,
        qda_train_device)
    from duckdb_imputation_tpu.ring import (sum_to_nb_agg_grouped,
                                            sum_to_triple_grouped)
    from duckdb_imputation_tpu.ring.triple import sigma_from_triple

    log(f"[6] QDA / NB device train + predict at {n} rows vs host")
    rng = np.random.default_rng(8)
    g = rng.integers(0, 5, size=n).astype(np.int32)
    scale = 0.6 + 0.2 * np.arange(5)
    num = (rng.normal(size=(4, n)) * scale[g] + g).astype(np.float32)
    codes = ((g + rng.integers(0, 3, size=n)) % 8)[None].astype(np.int32)
    labels = list(range(5))

    s_num = FeatureSchema(num_cols=4)
    triples = sum_to_triple_grouped(num, None, g, schema=s_num, num_groups=5)
    want = np.asarray(qda_predict(qda_train(triples, s_num, labels), num,
                                  None))
    quad, lin, b = qda_train_device(jnp.asarray(sigma_from_triple(triples)),
                                    jnp.asarray(float(n)), 1)
    got = np.asarray(qda_predict_device(quad, lin, b, jnp.asarray(num),
                                        jnp.zeros((0, n), jnp.int32),
                                        schema=s_num))
    agree = float((got == want).mean())
    log(f"  QDA device vs host agreement {agree:.5f}, accuracy "
        f"{float((got == g).mean()):.4f}")
    check(agree >= 0.999, f"QDA agreement {agree}")

    s_nb = FeatureSchema(num_cols=4, cat_keys=(tuple(range(8)),))
    aggs = sum_to_nb_agg_grouped(num, codes, g, schema=s_nb, num_groups=5)
    want = np.asarray(nb_predict(nb_train(aggs, s_nb, labels), num, codes))
    pri, mean, var, freqs = nb_train_device(aggs.n, aggs.lin,
                                            aggs.quad_diag, aggs.lin_cat)
    got = np.asarray(labels)[np.asarray(nb_predict_device(
        pri, mean, var, freqs, jnp.asarray(num), jnp.asarray(codes),
        schema=s_nb))]
    agree = float((got == want).mean())
    log(f"  NB device vs host agreement {agree:.5f}")
    check(agree >= 0.999, f"NB agreement {agree}")


def _write_csv(path, n, miss, seed, block=1 << 21):
    from duckdb_imputation_tpu.table.native import format_csv_block

    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        f.write(b"x0,x1,x2,x3,c0,c1\n")
        for lo in range(0, n, block):
            m = min(block, n - lo)
            x0 = rng.normal(size=m).astype(np.float32)
            x2 = rng.normal(size=m).astype(np.float32)
            x1 = 3 * x0 + x2
            x1[rng.random(m) < miss] = np.nan
            c0 = ((x0 > 0) * 3 + 4).astype(np.float64)
            c0[rng.random(m) < miss] = np.nan
            cols = [x0, x1, x2, rng.normal(size=m).astype(np.float32), c0,
                    (rng.integers(0, 8, m) * 2).astype(np.float64)]
            f.write(format_csv_block(cols, [0, 0, 0, 0, 1, 1]))


def phase_out_of_core(work, n=10_000_000):
    import jax.numpy as jnp

    from duckdb_imputation_tpu.mice.device_round import run_mice_device
    from duckdb_imputation_tpu.mice.streaming import impute_csv_stream
    from duckdb_imputation_tpu.table.native import read_csv
    from duckdb_imputation_tpu.utils.profiling import PhaseTimer

    log(f"[7] impute_csv_stream(engine='device') vs in-core at {n} rows")
    src = os.path.join(work, "in.csv")
    dst = os.path.join(work, "out.csv")
    t0 = time.perf_counter()
    _write_csv(src, n, 0.02, seed=9)
    log(f"  wrote {os.path.getsize(src) / 1e9:.2f} GB CSV in "
        f"{time.perf_counter() - t0:.1f} s (native library built/loaded)")
    timer = PhaseTimer()
    t0 = time.perf_counter()
    res = impute_csv_stream(src, dst, iters=3, noise=False, engine="device",
                            block_bytes=128 << 20, timer=timer)
    log(f"  streamed in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k}={v:.2f}s" for k, v in sorted(
            timer.summary().items())))
    with open(dst, "rb") as f:
        lines = sum(1 for _ in f)
    check(lines == n + 1, f"output CSV has {lines} lines")

    t = read_csv(src)
    inc = run_mice_device(t, iters=3, noise=False)
    idx = jnp.asarray(res.idx)
    nn = t.num_null[:, idx]
    cn = t.cat_null[:, idx]
    dx = float(jnp.max(jnp.where(nn[1], jnp.abs(
        res.dirty.num_data[1] - inc.num_data[1][idx]), 0.0)))
    agree = float(jnp.sum((res.dirty.cat_codes[0] == inc.cat_codes[0][idx])
                          & cn[0]) / jnp.maximum(jnp.sum(cn[0]), 1))
    log(f"  streamed vs in-core: max |Δx1| {dx:.3e} (tol 0.001), cat0 "
        f"agreement {agree:.5f} over {len(res.idx)} dirty rows")
    check(dx <= 1e-3, f"out-of-core numerics differ by {dx}")
    check(agree >= 0.999, f"out-of-core codes agree on {agree}")


def phase_cli(work, n=200_000):
    from duckdb_imputation_tpu import cli

    log(f"[8] CLI impute --mode device at {n} rows (in-process)")
    src = os.path.join(work, "cli_in.csv")
    dst = os.path.join(work, "cli_out.csv")
    _write_csv(src, n, 0.2, seed=10)
    cli.main(["impute", src, "--out", dst, "--mode", "device",
              "--iters", "2", "--no-noise"])
    with open(src) as f:
        f.readline()
        truth_rows = [ln.rstrip("\n").split(",") for ln in f]
    with open(dst) as f:
        header = f.readline().strip().split(",")
        out_rows = [ln.rstrip("\n").split(",") for ln in f]
    check(len(out_rows) == n, f"CLI wrote {len(out_rows)} rows")
    j1 = header.index("x1")
    x0 = np.asarray([float(r[0]) for r in truth_rows])
    x2 = np.asarray([float(r[2]) for r in truth_rows])
    null = np.asarray([r[1] == "" for r in truth_rows])
    got = np.asarray([float(r[j1]) for r in out_rows])
    rmse = float(np.sqrt(np.mean((got[null] - (3 * x0 + x2)[null]) ** 2)))
    log(f"  x1 rmse on {int(null.sum())} imputed cells: {rmse:.3e}")
    check(rmse < 0.05, f"CLI rmse {rmse}")


def phase_sharded(n=100_000_000):
    import jax
    import jax.numpy as jnp

    from duckdb_imputation_tpu.mice.device_round import (
        run_mice_device, run_mice_device_delta)
    from duckdb_imputation_tpu.mice.sharded_round import (
        run_mice_sharded, run_mice_sharded_delta)
    from duckdb_imputation_tpu.parallel.mesh import make_mesh
    from duckdb_imputation_tpu.parallel.sharded import sum_to_triple_sharded
    from duckdb_imputation_tpu.ring.sum import sum_to_triple

    ndev = len(jax.devices())
    mesh = make_mesh(ndev)
    log(f"[S] sharded loops on a 1-D mesh of {ndev} devices, {n} rows "
        f"({n // ndev} per device)  ({CARD})")

    t, x, _ = mice_table(n, 0.2, seed=12)
    t0 = time.perf_counter()
    sh = run_mice_sharded(t, iters=2, noise=False, mesh=mesh)
    sh.num_data.block_until_ready()
    log(f"  run_mice_sharded: {time.perf_counter() - t0:.2f} s end to end")
    single = run_mice_device(t, iters=2, noise=False)
    compare_imputations(jax.device_put(sh, jax.devices()[0]), single,
                        t.num_null, t.cat_null, 1e-3,
                        "sharded vs single card")
    check(rmse_x1(single, x, t.num_null) < 0.05, "single-card rmse")
    check(rmse_x1(sh, x, t.num_null) < 0.05, "sharded rmse")

    t, x, _ = mice_table(n, 0.01, seed=13)
    sd = run_mice_sharded_delta(t, iters=2, noise=False, mesh=mesh)
    single = run_mice_device_delta(t, iters=2, noise=False)
    compare_imputations(jax.device_put(sd, jax.devices()[0]), single,
                        t.num_null, t.cat_null, 1e-3,
                        "sharded delta vs single card")
    check(rmse_x1(sd, x, t.num_null) < 0.05, "sharded delta rmse")

    # 2^24 rows: every count stays exactly representable in f32, so the
    # counts must be identical whatever the reduction order
    m = 1 << 24
    s = t.schema
    x, c = t.num_data[:, :m], t.cat_codes[:, :m]
    w = 1.0 - t.num_null[1, :m].astype(jnp.float32)
    a = sum_to_triple_sharded(x, c, w, schema=s, mesh=mesh)
    b = sum_to_triple(x, c, w, schema=s)
    check(float(a.n) == float(b.n), "sharded N differs")
    check(np.array_equal(np.asarray(a.cat_cat), np.asarray(b.cat_cat)),
          "sharded cat_cat counts differ")
    rel = float(np.max(np.abs(np.asarray(a.quad) - np.asarray(b.quad))
                       / np.abs(np.asarray(b.quad)).max()))
    log(f"  sum_to_triple_sharded vs single at {m} rows: counts identical, "
        f"quad rel diff {rel:.2e}")
    check(rel <= 1e-4, f"sharded quad differs by {rel}")


# --------------------------------------------------------------------------

def main(argv=None):
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1,
                    help="4: run only the sharded phase on four GPUs")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devs[0].platform})",
              file=sys.stderr)
        return 2
    if len(devs) < args.chips:
        print(f"chip_smoke: --chips {args.chips} but {len(devs)} GPUs",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "duckdb_imputation_tpu")):
        print("chip_smoke: the duckdb_imputation_tpu package is not beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)

    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[0] card: {CARD}")
    log(f"    jax {jax.__version__} devices: {devs}")

    from duckdb_imputation_tpu.config import enable_compilation_cache
    log(f"    compile cache: {enable_compilation_cache()}")

    # traces and timing.json; scratch CSVs go to a temporary directory
    out_dir = os.path.join(HERE, ".work", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    t_start = time.perf_counter()
    if args.chips > 1:
        phase_sharded()
    else:
        phase_parity()
        phase_timing(out_dir)
        phase_main_path()
        phase_delta()
        phase_host_parity()
        phase_models()
        with tempfile.TemporaryDirectory(
                dir=os.path.join(HERE, ".work")) as work:
            phase_out_of_core(work)
            phase_cli(work)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
