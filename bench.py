"""Headline benchmark: cofactor aggregation rows/s on one device (BASELINE.json
config `sum_to_triple_4_2` — 4 numeric + 2 categorical columns,
WHERE-masked), plus the other BASELINE configs, all through the public
entry points with kernel='auto'.

Timing: wall clock around calls that end in `block_until_ready`, the
median of several calls after one warm-up call (compilation is set-up,
not measured). Per-round MICE times are (T(k_hi rounds) − T(k_lo
rounds)) / (k_hi − k_lo) of the public wrappers, which cancels their
fixed host work (init fill, transfers).

Baseline (`vs_baseline`): the reference publishes no numbers and cannot be
built here (DuckDB 0.9.2 must be cloned from the network — BASELINE.md).
Two buildable stand-ins are measured and the FASTER one (most favorable
to the reference) is the denominator:
  * the FAITHFUL per-core loop — a C++ -O3 reimplementation of the
    reference's aggregation algorithm class (scalar packed-triangle FMA +
    ordered-map upserts per row, sum_no_lift.cpp:128-214) in
    native/columnar.cpp `dbi_ref_agg_seconds`;
  * the dense masked-Gram as CPU BLAS sgemm via numpy, per-core
    normalized.

Prints exactly ONE JSON line on stdout (with the device it ran on);
detail goes to stderr. DBI_BENCH_FAST=1 runs only the headline.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N_ROWS = 10_000_000


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def timed(fn, reps=5):
    """Median wall seconds of fn() to completion, after one warm-up."""
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def per_round(run, k_lo=1, k_hi=5, reps=3):
    """Per-round seconds of run(iters) (which blocks until done)."""
    run(k_lo)
    run(k_hi)
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run(k_hi)
        t_hi = time.perf_counter() - t0
        t0 = time.perf_counter()
        run(k_lo)
        out.append((t_hi - (time.perf_counter() - t0)) / (k_hi - k_lo))
    return float(np.median(out))


def bench_headline(schema, n=N_ROWS):
    import jax
    import jax.numpy as jnp

    from duckdb_imputation_tpu.ring.sum import sum_to_triple

    @jax.jit
    def gen(key):
        kx, kc, kw = jax.random.split(key, 3)
        x = jax.random.normal(kx, (4, n), jnp.float32)
        c = jax.random.randint(kc, (2, n), 0, 8, jnp.int32)
        w = (jax.random.uniform(kw, (n,)) > 0.2).astype(jnp.float32)
        return x, c, w

    x, c, w = gen(jax.random.PRNGKey(0))
    sec = timed(lambda: sum_to_triple(x, c, w, schema=schema))
    log(f"sum_to_triple 4_2 masked @{n}: {sec * 1e3:.3f} ms "
        f"-> {n / sec / 1e9:.2f}G rows/s, "
        f"{n * 28 / sec / 1e9:.0f} GB/s of input")
    return n / sec


def bench_cpu_baseline(schema, n=1_000_000, iters=3):
    """Single-core-normalized numpy sgemm of the same computation."""
    rng = np.random.default_rng(0)
    num = rng.normal(size=(n, 4)).astype(np.float32)
    codes = rng.integers(0, 8, size=(n, 2)).astype(np.int32)
    weights = (rng.random(n) > 0.2).astype(np.float32)
    v = schema.vocab_size
    offs = schema.offsets
    t0 = time.perf_counter()
    for _ in range(iters):
        b = np.zeros((n, v), np.float32)
        for j in range(schema.cat_cols):
            b[np.arange(n), codes[:, j] + offs[j]] = 1.0
        z = np.concatenate([np.ones((n, 1), np.float32), num, b], axis=1)
        zw = z * weights[:, None]
        z.T @ zw
    dt = (time.perf_counter() - t0) / iters
    ncores = os.cpu_count() or 1
    per_core = n / (dt * ncores)
    log(f"cpu sgemm stand-in: {dt * 1e3:.1f} ms on {ncores} cores "
        f"-> {per_core / 1e6:.2f}M rows/s/core")
    return per_core


def bench_cpu_ref_loop(n=1_000_000, d=4, c=2, iters=3):
    """Faithful single-core reimplementation of the reference's fused
    aggregation loop (native C++, see module docstring). Same data
    distribution as the device config: 8-key vocabs, 80% binary mask."""
    import ctypes

    from duckdb_imputation_tpu.table.native import load_library

    lib = load_library()
    lib.dbi_ref_agg_seconds.restype = ctypes.c_double
    lib.dbi_ref_agg_seconds.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    rng = np.random.default_rng(0)
    x = np.ascontiguousarray(rng.normal(size=(d, n)), np.float32)
    codes = np.ascontiguousarray(rng.integers(0, 8, size=(c, n)), np.int32)
    w = np.ascontiguousarray((rng.random(n) > 0.2), np.float32)
    sec = lib.dbi_ref_agg_seconds(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, d, c, iters)
    log(f"cpu FAITHFUL ref loop (scalar FMA + map upserts): "
        f"{sec * 1e3:.1f} ms @{n} -> {n / sec / 1e6:.2f}M rows/s/core")
    return n / sec


def bench_numeric_4_0(n=1_000_000):
    """BASELINE config 1: pure-numeric `sum_to_triple_4_0` over ~1M rows."""
    import jax

    from duckdb_imputation_tpu import FeatureSchema
    from duckdb_imputation_tpu.ring.sum import sum_to_triple

    schema = FeatureSchema(num_cols=4)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, n))
    sec = timed(lambda: sum_to_triple(x, None, None, schema=schema))
    log(f"sum_to_triple_4_0 @{n}: {sec * 1e6:.0f} us "
        f"-> {n / sec / 1e9:.2f}G rows/s")
    return n / sec


def bench_nb_grouped(n=N_ROWS, groups=5):
    """BASELINE config 3: `sum_to_nb_agg_8_4` GROUP BY label."""
    import jax
    import jax.numpy as jnp

    from duckdb_imputation_tpu import FeatureSchema
    from duckdb_imputation_tpu.ring.sum import sum_to_nb_agg_grouped

    schema = FeatureSchema(num_cols=8,
                           cat_keys=tuple(tuple(range(8)) for _ in range(4)))

    @jax.jit
    def gen(key):
        ks = jax.random.split(key, 3)
        return (jax.random.normal(ks[0], (8, n), jnp.float32),
                jax.random.randint(ks[1], (4, n), 0, 8, jnp.int32),
                jax.random.randint(ks[2], (n,), 0, groups, jnp.int32))

    x, c, g = gen(jax.random.PRNGKey(2))
    sec = timed(lambda: sum_to_nb_agg_grouped(x, c, g, schema=schema,
                                              num_groups=groups))
    log(f"sum_to_nb_agg_8_4 GROUP BY ({groups} labels) @{n}: "
        f"{sec * 1e3:.2f} ms -> {n / sec / 1e9:.2f}G rows/s")
    return n / sec


def _skewed_groups(schema, n, groups):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def gen(key):
        ks = jax.random.split(key, 4)
        x = jax.random.normal(ks[0], (schema.num_cols, n), jnp.float32)
        c = jax.random.randint(ks[1], (schema.cat_cols, n), 0, 8, jnp.int32)
        # 90% of rows in class 0, rest uniform, unsorted
        hot = jax.random.uniform(ks[2], (n,)) < 0.9
        g = jnp.where(hot, 0, jax.random.randint(ks[3], (n,), 1, groups))
        return x, c, g.astype(jnp.int32)

    return gen(jax.random.PRNGKey(3))


def bench_qda_grouped_skewed(schema, n=N_ROWS, groups=8):
    """BASELINE config 4: per-class triples with a 90%-skewed unsorted
    label through `sum_to_triple_grouped` (method='auto')."""
    from duckdb_imputation_tpu.ring.sum import sum_to_triple_grouped

    x, c, g = _skewed_groups(schema, n, groups)
    sec = timed(lambda: sum_to_triple_grouped(
        x, c, g, schema=schema, num_groups=groups).quad, reps=3)
    log(f"QDA grouped skewed ({groups} classes, 90% hot) @{n}: "
        f"{sec * 1e3:.2f} ms -> {n / sec / 1e9:.2f}G rows/s")
    return n / sec


def _mice_table(n, miss, seed=0):
    """The verify-skill table: x1 = 3·x0 + x2 exactly, cat0 = sign of x0,
    `miss` nulls in x1 and cat0."""
    import jax
    import jax.numpy as jnp

    from duckdb_imputation_tpu import FeatureSchema
    from duckdb_imputation_tpu.table.table import Table

    @jax.jit
    def gen(key):
        ks = jax.random.split(key, 6)
        z0 = jax.random.normal(ks[0], (n,))
        z1 = jax.random.normal(ks[1], (n,))
        x = jnp.stack([z0, 2 * z0 + z1, z1 - z0,
                       jax.random.normal(ks[2], (n,))])
        c = jnp.stack([(z0 > 0).astype(jnp.int32) * 7,
                       jax.random.randint(ks[3], (n,), 0, 8, jnp.int32)])
        nn = jnp.zeros((4, n), bool).at[1].set(
            jax.random.uniform(ks[4], (n,)) < miss)
        cn = jnp.zeros((2, n), bool).at[0].set(
            jax.random.uniform(ks[5], (n,)) < miss)
        return x, c, nn, cn

    x, c, nn, cn = gen(jax.random.PRNGKey(seed))
    schema = FeatureSchema(num_cols=4, cat_keys=(tuple(range(8)),) * 2)
    return Table(num_data=x, cat_codes=c, num_null=nn, cat_null=cn,
                 schema=schema)


def bench_mice_round(n=N_ROWS):
    """Full MICE round (BASELINE config 5, one device): masked aggregate +
    train + predict + write-back for 1 continuous and 1 categorical null
    column, through run_mice_device (the whole loop is one dispatch)."""
    from duckdb_imputation_tpu.mice.device_round import run_mice_device

    t = _mice_table(n, 0.2)
    sec = per_round(lambda k: run_mice_device(
        t, iters=k, noise=False).num_data.block_until_ready())
    log(f"MICE round @{n} rows (1 num + 1 cat null col): "
        f"{sec * 1e3:.2f} ms/round")
    return sec


def bench_mice_delta(n=N_ROWS, fracs=(0.01, 0.05, 0.20)):
    """Delta-MICE per-round time vs dirty fraction through
    run_mice_device_delta (imputation_low.cpp:85-110's train = full −
    delta over the dirty rows only). Returns {frac: seconds}."""
    from duckdb_imputation_tpu.mice.device_round import run_mice_device_delta

    out = {}
    for frac in fracs:
        t = _mice_table(n, frac, seed=1)
        out[frac] = per_round(lambda k: run_mice_device_delta(
            t, iters=k, noise=False).num_data.block_until_ready())
        log(f"delta-MICE round @{n} rows, {frac:.0%} dirty: "
            f"{out[frac] * 1e3:.2f} ms/round")
    return out


def bench_qda_pipeline(schema, n=N_ROWS, groups=8):
    """BASELINE config 4 end to end: skewed grouped aggregation →
    qda_train_device → qda_predict_device. Returns seconds per pass."""
    import jax.numpy as jnp

    from duckdb_imputation_tpu.models.device import (
        qda_predict_device,
        qda_train_device,
    )
    from duckdb_imputation_tpu.ring.sum import sum_to_triple_grouped
    from duckdb_imputation_tpu.ring.triple import sigma_from_triple

    x, c, g = _skewed_groups(schema, n, groups)

    def pipeline():
        sigmas = sigma_from_triple(sum_to_triple_grouped(
            x, c, g, schema=schema, num_groups=groups))
        quad, lin, b = qda_train_device(
            sigmas, jnp.asarray(float(n), jnp.float32), 1)
        return qda_predict_device(quad, lin, b, x, c, schema=schema)

    sec = timed(pipeline, reps=3)
    log(f"QDA pipeline (grouped agg + train + batched predict) @{n}: "
        f"{sec * 1e3:.1f} ms -> {n / sec / 1e9:.2f}G rows/s end-to-end")
    return sec


def bench_wide_v(vocab_totals=(8192, 16384), n=262_144):
    """Wide-V: the striped sigma at V = 8k / 16k (dense sigma 0.27 /
    1.07 GB; per-row cost dominated by the dense one-hot Gram). Reference
    bound being escaped: ML/utils.cpp:176-310's single dense sigma
    malloc. Returns seconds per full striped sigma."""
    import jax
    import jax.numpy as jnp

    from duckdb_imputation_tpu import FeatureSchema
    from duckdb_imputation_tpu.ring.striped import sigma_striped

    out = {}
    for v_total in vocab_totals:
        vocab = v_total // 2
        schema = FeatureSchema(num_cols=2,
                               cat_keys=(tuple(range(vocab)),
                                         tuple(range(vocab))))
        p = schema.sigma_size

        @jax.jit
        def gen(key, vocab=vocab):
            ks = jax.random.split(key, 3)
            x = jax.random.normal(ks[0], (2, n), jnp.float32)
            c = jax.random.randint(ks[1], (2, n), 0, vocab, jnp.int32)
            w = (jax.random.uniform(ks[2], (n,)) > 0.2).astype(jnp.float32)
            return x, c, w

        x, c, w = gen(jax.random.PRNGKey(4))
        sec = timed(lambda: [s for _, s in sigma_striped(
            x, c, w, schema=schema, stripe=2048, row_chunk=2048)], reps=3)
        log(f"wide-V striped sigma V={v_total} (P={p}, "
            f"{p * p * 4 / 1e9:.2f} GB sigma) @{n} rows: {sec:.3f}s "
            f"-> {n / sec / 1e6:.2f}M rows/s")
        out[f"wide_v_striped_sigma_s_V{v_total}"] = sec
    return out


def bench_streaming(n_rows=None, block_rows=2_097_152, miss=0.01):
    """Out-of-core MICE: write a many-million-row CSV, then time (a) the
    pure parse pass, (b) `impute_csv_stream` end to end — two streaming
    read passes (vocab/dirty scan + the extended-Gram device fold), the
    device delta rounds over the dirty cache, and the native streaming
    write-out — with the per-phase split, and (c) the disk-spill path
    (dirty_budget_rows) at 10M rows. Default 25M rows;
    DBI_BENCH_STREAM_ROWS overrides. Files live in a scratch directory
    inside the checkout and are removed at the end. Returns seconds."""
    import shutil
    import tempfile

    from duckdb_imputation_tpu.mice.streaming import (impute_csv_stream,
                                                      run_mice_stream)
    from duckdb_imputation_tpu.table.native import (csv_chunk_source,
                                                    format_csv_block)
    from duckdb_imputation_tpu.utils.profiling import PhaseTimer

    if n_rows is None:
        n_rows = int(os.environ.get("DBI_BENCH_STREAM_ROWS", 25_000_000))
    os.makedirs(os.path.join(HERE, ".work"), exist_ok=True)
    workdir = tempfile.mkdtemp(dir=os.path.join(HERE, ".work"))
    path = os.path.join(workdir, "in.csv")
    out_path = os.path.join(workdir, "out.csv")
    reps = -(-n_rows // block_rows)
    n_rows = reps * block_rows

    # --- synthesize: ONE native-formatted block, repeated (identical
    # blocks are fine for timing; the parser/device see fresh bytes) ---
    rng = np.random.default_rng(0)
    m = block_rows
    x0 = rng.normal(size=m).astype(np.float32)
    z = rng.normal(size=m).astype(np.float32)
    x1 = 2 * x0 + 0.1 * z
    x1[rng.random(m) < miss] = np.nan              # null numeric cells
    c0 = ((x0 > 0) * 3 + 4).astype(np.float64)
    c0[rng.random(m) < miss] = np.nan              # null categorical cells
    cols = [x0, x1, z, rng.normal(size=m).astype(np.float32),
            c0, (rng.integers(0, 8, m) * 2).astype(np.float64)]
    block = bytes(format_csv_block(cols, [0, 0, 0, 0, 1, 1]))
    with open(path, "wb") as f:
        f.write(b"x0,x1,x2,x3,c0,c1\n")
        for _ in range(reps):
            f.write(block)
    fsize = os.path.getsize(path)

    # --- (a) parse-only pass: the IO + native-parse floor ---
    t0 = time.perf_counter()
    rows = 0
    for num, cat, nn, cn in csv_chunk_source(path, True, 128 << 20)():
        rows += num.shape[-1]
    io_s = time.perf_counter() - t0
    assert rows == n_rows, (rows, n_rows)
    log(f"parse-only pass: {io_s:.1f}s = {n_rows / io_s / 1e6:.1f}M rows/s "
        f"({fsize / io_s / 1e6:.0f} MB/s)")

    # --- (b) end-to-end out-of-core MICE ---
    timer = PhaseTimer()
    t0 = time.perf_counter()
    impute_csv_stream(path, out_path, iters=3, noise=False,
                      block_bytes=128 << 20, timer=timer, engine="device")
    e2e_s = time.perf_counter() - t0
    ph = timer.summary()
    log(f"impute_csv_stream @{n_rows}: {e2e_s:.1f}s end-to-end "
        f"({n_rows / e2e_s / 1e6:.1f}M rows/s); phases: "
        + ", ".join(f"{k}={v:.1f}s" for k, v in sorted(ph.items())))

    # --- (c) the disk-spill path at 10M rows ---
    small = os.path.join(workdir, "small.csv")
    reps_small = max(10_000_000 // block_rows, 1)
    with open(small, "wb") as f:
        f.write(b"x0,x1,x2,x3,c0,c1\n")
        for _ in range(reps_small):
            f.write(block)
    n_small = reps_small * block_rows
    spill = {}
    for mode, budget in (("incore", None),
                         ("spill", int(n_small * miss * 0.6))):
        tmr = PhaseTimer()
        res = run_mice_stream(csv_chunk_source(small, True, 128 << 20),
                              iters=3, noise=False, linreg_iters=1000,
                              timer=tmr, dirty_budget_rows=budget)
        spill[mode] = sum(tmr.summary().get(k, 0.0) for k in
                          ("cofactor_delta", "train", "impute",
                           "cofactor_readd")) / 3.0
        assert (res.spill is not None) == (mode == "spill"), mode
        log(f"10M {mode}: {spill[mode]:.2f}s/round")

    shutil.rmtree(workdir, ignore_errors=True)
    return {
        "stream_rows": n_rows,
        "stream_parse_rows_per_s": n_rows / io_s,
        "stream_e2e_s": e2e_s,
        "stream_e2e_rows_per_s": n_rows / e2e_s,
        "stream_phase_split_s": ph,
        "stream_spill_round_s_10M": spill["spill"],
        "stream_incore_round_s_10M": spill["incore"],
    }


def main():
    import jax

    from duckdb_imputation_tpu import FeatureSchema
    from duckdb_imputation_tpu.config import enable_compilation_cache

    enable_compilation_cache()
    dev = jax.devices()[0]
    schema = FeatureSchema(
        num_cols=4, cat_keys=(tuple(range(8)), tuple(range(8))))
    rows_per_s = bench_headline(schema)
    base_sgemm = bench_cpu_baseline(schema)
    base_ref = bench_cpu_ref_loop()
    # denominator = the FASTER per-core stand-in (favors the reference)
    base = max(base_sgemm, base_ref)
    extras = {"cpu_ref_loop_rows_per_s_core": base_ref,
              "cpu_sgemm_rows_per_s_core": base_sgemm}
    if os.environ.get("DBI_BENCH_FAST") != "1":
        extras["numeric_4_0_rows_per_s"] = bench_numeric_4_0()
        extras["nb_grouped_8_4_rows_per_s"] = bench_nb_grouped()
        extras["qda_grouped_skewed_rows_per_s"] = (
            bench_qda_grouped_skewed(schema))
        extras["mice_round_ms_10M_rows"] = bench_mice_round() * 1e3
        extras["mice_round_ms_100M_rows"] = (
            bench_mice_round(n=100_000_000) * 1e3)
        for frac, sec in bench_mice_delta().items():
            extras[f"mice_delta_round_ms_10M_{int(frac * 100)}pct_dirty"] = (
                sec * 1e3)
        extras["qda_pipeline_ms_10M"] = bench_qda_pipeline(schema) * 1e3
        extras.update(bench_wide_v())
        extras.update(bench_streaming())
    print(json.dumps({
        "metric": "cofactor_agg_rows_per_s (sum_to_triple_4_2 masked)",
        "value": rows_per_s,
        "unit": "rows/s",
        "vs_baseline": rows_per_s / base,
        **extras,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
