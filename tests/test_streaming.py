"""Out-of-core streaming aggregation + MICE (ring/streaming.py,
mice/streaming.py, native chunked CSV reader).

The load-bearing identity: ONE extended-Gram pass over [Z₀ | null-flags]
must reconstruct the full triple over the mean/mode-FILLED table exactly
(the U fill algebra), so the streaming driver equals the resident
`run_mice_low` without ever holding the clean rows."""
import shutil

import numpy as np
import pytest

from duckdb_imputation_tpu.mice.low import run_mice_low
from duckdb_imputation_tpu.mice.partition import init_fill
from duckdb_imputation_tpu.mice.streaming import run_mice_stream
from duckdb_imputation_tpu.ring.streaming import (aggregate_stream,
                                                  chunks_from_arrays)
from duckdb_imputation_tpu.ring.sum import sum_to_triple
from duckdb_imputation_tpu.table.table import from_numpy


def _make_data(seed=0, n=4000, d=3, c=2, miss=0.08):
    rng = np.random.default_rng(seed)
    lat = rng.normal(size=n)
    num = np.stack([lat * 2 + rng.normal(size=n) * .3,
                    -lat + rng.normal(size=n) * .3,
                    rng.normal(size=n)][:d]).astype(np.float32)
    cat = np.stack([(lat > 0).astype(np.int64) * 7 + 2,
                    rng.integers(0, 3, size=n)][:c])
    num_null = rng.random((d, n)) < miss
    cat_null = rng.random((c, n)) < miss
    return (np.where(num_null, np.nan, num), np.where(cat_null, -1, cat),
            num, cat, num_null, cat_null)


def test_stream_triple_matches_filled_rescan():
    num_in, cat_in, _, _, _, _ = _make_data(seed=3)
    full, fills, ss, cache = aggregate_stream(
        chunks_from_arrays(num_in, cat_in, chunk_rows=700), chunk_rows=512)

    t = init_fill(from_numpy(num_data=num_in, cat_data=cat_in,
                             rows_first=False))
    assert ss.schema == t.schema
    ref = sum_to_triple(t.num_data, t.cat_codes, None, schema=t.schema)
    for name in ("n", "lin", "quad", "lin_cat", "num_cat", "cat_cat"):
        a = np.asarray(getattr(full, name), np.float64)
        b = np.asarray(getattr(ref, name), np.float64)
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-3)
    # integer sections are exact (counts in float clothing)
    np.testing.assert_array_equal(np.asarray(full.lin_cat),
                                  np.asarray(ref.lin_cat))
    np.testing.assert_array_equal(np.asarray(full.cat_cat),
                                  np.asarray(ref.cat_cat))
    # fills == init_fill's means/modes
    numd = np.asarray(t.num_data)
    for j, mean in enumerate(fills.num_means):
        assert abs(mean - float(numd[j].mean())) < 1e-3
    assert cache.idx.size == int(
        (np.isnan(num_in).any(0) | (cat_in < 0).any(0)).sum())


def test_stream_dirty_cache_positions():
    num_in, cat_in, _, _, num_null, cat_null = _make_data(seed=4, n=1777)
    _, _, _, cache = aggregate_stream(
        chunks_from_arrays(num_in, cat_in, chunk_rows=400), chunk_rows=256)
    dirty = num_null.any(0) | cat_null.any(0)
    np.testing.assert_array_equal(cache.idx, np.nonzero(dirty)[0])
    np.testing.assert_array_equal(cache.num_null, num_null[:, dirty])


def test_stream_mice_matches_low():
    num_in, cat_in, _, _, num_null, cat_null = _make_data(seed=1)
    res = run_mice_stream(
        chunks_from_arrays(num_in, cat_in, chunk_rows=640),
        iters=3, noise=False, chunk_rows=512)
    t0 = from_numpy(num_data=num_in, cat_data=cat_in, rows_first=False)
    ref = run_mice_low(t0, iters=3, noise=False)

    idx = res.idx
    num_ref = np.asarray(ref.num_data)
    num_str = np.asarray(res.dirty.num_data)
    for j in range(num_in.shape[0]):
        m = num_null[j, idx]
        scale = np.abs(num_ref[j]).max() + 1
        np.testing.assert_allclose(num_str[j][m], num_ref[j, idx][m],
                                   atol=5e-3 * scale)
    cat_ref = ref.cat_values()
    cat_str = res.dirty.cat_values()
    for j in range(cat_in.shape[0]):
        m = cat_null[j, idx]
        agree = (cat_str[j][m] == cat_ref[j, idx][m]).mean() if m.any() else 1
        assert agree > 0.98, agree


def test_stream_impute_chunks_substitutes_only_nulls():
    num_in, cat_in, num, cat, num_null, cat_null = _make_data(seed=2)
    src = chunks_from_arrays(num_in, cat_in, chunk_rows=550)
    res = run_mice_stream(src, iters=2, noise=False, chunk_rows=512)
    out = list(res.impute_chunks(src))
    out_num = np.concatenate([a for a, _ in out], axis=1)
    out_cat = np.concatenate([b for _, b in out], axis=1)
    assert out_num.shape == num.shape
    assert not np.isnan(out_num).any()
    assert (out_cat >= 0).all()
    np.testing.assert_array_equal(out_num[~num_null], num[~num_null])
    np.testing.assert_array_equal(out_cat[~cat_null], cat[~cat_null])


def test_stream_spill_matches_incore_at_high_missing():
    """50% missing rate with a dirty budget far below the dirty count: the
    cache spills to disk, the rounds run windowed, and the result matches
    the unbounded in-core streaming path (ring sums make the windowed delta
    algebra exact up to f32 fold order). Also pins the memory contract: the
    spill store is memmap-backed, not ndarray-resident."""
    num_in, cat_in, num, cat, num_null, cat_null = _make_data(
        seed=9, n=3000, miss=0.5)
    src = chunks_from_arrays(num_in, cat_in, chunk_rows=640)
    budget = 256
    res_sp = run_mice_stream(src, iters=2, noise=False, chunk_rows=512,
                             dirty_budget_rows=budget)
    assert res_sp.spill is not None and res_sp.dirty is None
    assert res_sp.spill.n > budget        # really exceeded the cap
    assert isinstance(res_sp.spill.num, np.memmap)

    res_in = run_mice_stream(src, iters=2, noise=False, chunk_rows=512)
    idx = res_in.idx
    np.testing.assert_array_equal(np.asarray(res_sp.idx), idx)
    num_sp, cat_sp = res_sp._dirty_slice(0, res_sp.spill.n)
    num_ic = np.asarray(res_in.dirty.num_data)
    cat_ic = res_in.dirty.cat_values()
    for j in range(num.shape[0]):
        m = num_null[j, idx]
        scale = np.abs(num_ic[j]).max() + 1
        np.testing.assert_allclose(num_sp[j][m], num_ic[j][m],
                                   atol=5e-3 * scale)
    for j in range(cat.shape[0]):
        m = cat_null[j, idx]
        agree = (cat_sp[j][m] == cat_ic[j][m]).mean() if m.any() else 1.0
        assert agree > 0.98, agree

    # the write-out path reads from the spill
    out = list(res_sp.impute_chunks(src))
    out_num = np.concatenate([a for a, _ in out], axis=1)
    assert not np.isnan(out_num).any()
    np.testing.assert_array_equal(out_num[~num_null], num[~num_null])
    res_sp.spill.cleanup()


def test_stream_all_observed_is_noop():
    rng = np.random.default_rng(5)
    num = rng.normal(size=(2, 300)).astype(np.float32)
    cat = rng.integers(0, 3, size=(1, 300))
    res = run_mice_stream(chunks_from_arrays(num, cat, chunk_rows=128),
                          iters=2, chunk_rows=128)
    assert res.idx.size == 0
    out = list(res.impute_chunks(chunks_from_arrays(num, cat,
                                                    chunk_rows=128)))
    np.testing.assert_array_equal(
        np.concatenate([a for a, _ in out], axis=1), num)


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
def test_csv_stream_matches_full_load(tmp_path):
    from duckdb_imputation_tpu.table.native import (csv_chunk_source,
                                                    load_csv)
    rng = np.random.default_rng(6)
    n = 3000
    a = rng.normal(size=n)
    g = rng.integers(0, 4, size=n)
    na = rng.random(n) < 0.1
    lines = ["a,g"]
    for i in range(n):
        lines.append(("%s,%d" % ("" if na[i] else "%.6f" % a[i], g[i])))
    p = tmp_path / "s.csv"
    p.write_text("\n".join(lines) + "\n")

    # tiny blocks force many ragged chunks
    chunks = list(csv_chunk_source(str(p), block_bytes=1 << 10)())
    num = np.concatenate([c[0] for c in chunks], axis=1)
    cat = np.concatenate([c[1] for c in chunks], axis=1)
    nnull = np.concatenate([c[2] for c in chunks], axis=1)

    full = load_csv(str(p))
    np.testing.assert_array_equal(num[0], full.col_f32(0))
    np.testing.assert_array_equal(cat[0], full.col_i64(1))
    np.testing.assert_array_equal(nnull[0], full.col_null(0))


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
def test_impute_csv_stream_end_to_end(tmp_path):
    from duckdb_imputation_tpu.mice.streaming import impute_csv_stream
    rng = np.random.default_rng(7)
    n = 6000
    lat = rng.normal(size=n)
    a = (lat * 2 + rng.normal(size=n) * .3).astype(np.float32)
    b = (-lat + rng.normal(size=n) * .3).astype(np.float32)
    g = (lat > 0).astype(np.int64) * 5 + 1
    na = rng.random(n) < 0.1
    ng = rng.random(n) < 0.1
    lines = ["a,b,g"]
    for i in range(n):
        lines.append("%s,%.6f,%s" % ("" if na[i] else "%.6f" % a[i], b[i],
                                     "" if ng[i] else str(g[i])))
    src = tmp_path / "in.csv"
    dst = tmp_path / "out.csv"
    src.write_text("\n".join(lines) + "\n")

    impute_csv_stream(str(src), str(dst), iters=3, block_bytes=1 << 13,
                      noise=False)
    out = np.genfromtxt(str(dst), delimiter=",", names=True)
    assert len(out) == n
    assert not np.isnan(out["a"]).any()
    np.testing.assert_allclose(out["a"][~na], a[~na], atol=2e-6)
    np.testing.assert_array_equal(out["g"][~ng].astype(int), g[~ng])
    assert np.corrcoef(out["a"][na], a[na])[0, 1] > 0.85
    assert (out["g"][ng].astype(int) == g[ng]).mean() > 0.85


def test_stream_gram_sharded_matches_single():
    """Out-of-core × multi-chip: the streaming Gram fold with each chunk
    row-sharded over the 8-device mesh (GSPMD psum combine) must equal the
    single-device fold exactly — the SumStateCombine contract as a psum
    while data streams from beyond HBM."""
    import jax
    from duckdb_imputation_tpu.parallel.mesh import make_mesh
    from duckdb_imputation_tpu.ring.streaming import scan_gram, scan_schema

    num_in, cat_in, _, _, _, _ = _make_data(seed=8, n=3100)
    src = chunks_from_arrays(num_in, cat_in, chunk_rows=900)
    ss, _ = scan_schema(src)
    g1 = scan_gram(src, ss, chunk_rows=512)
    mesh = make_mesh(8)
    g8 = scan_gram(src, ss, chunk_rows=512, mesh=mesh)
    # f32 accumulation order differs across shards — same error class as
    # the reference's own parallel thread-merge
    np.testing.assert_allclose(g8, g1, rtol=1e-4, atol=1e-3)
    # counts in the Gram are exactly equal (integer sums)
    assert g8[0, 0] == g1[0, 0]


def test_stream_mice_sharded_matches_single():
    from duckdb_imputation_tpu.parallel.mesh import make_mesh

    num_in, cat_in, _, _, num_null, _ = _make_data(seed=9, n=2048)
    src = chunks_from_arrays(num_in, cat_in, chunk_rows=512)
    r1 = run_mice_stream(src, iters=2, noise=False, chunk_rows=256)
    r8 = run_mice_stream(src, iters=2, noise=False, chunk_rows=256,
                         mesh=make_mesh(8))
    np.testing.assert_allclose(np.asarray(r8.dirty.num_data),
                               np.asarray(r1.dirty.num_data),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(r8.dirty.cat_codes),
                                  np.asarray(r1.dirty.cat_codes))


def test_stream_device_engine_matches_host():
    """engine='device' (the compact-union device delta loop fed the
    STREAMED full sigma) reproduces the host-engine rounds' imputations
    within f32-solve tolerance — the production out-of-core path."""
    from duckdb_imputation_tpu.mice.streaming import run_mice_stream
    from duckdb_imputation_tpu.ring.streaming import chunks_from_arrays

    rng = np.random.default_rng(9)
    n = 4000
    z0 = rng.normal(size=n).astype(np.float32)
    z1 = rng.normal(size=n).astype(np.float32)
    num = np.stack([z0, 2 * z0 + z1, rng.normal(size=n).astype(np.float32)])
    cat = ((z0 > 0).astype(np.int64) * 3 + 4)[None, :]
    nn = np.zeros((3, n), bool)
    cn = np.zeros((1, n), bool)
    nn[1, rng.random(n) < 0.1] = True
    cn[0, rng.random(n) < 0.1] = True
    raw = num.copy()
    raw[nn] = np.nan
    src = chunks_from_arrays(raw, cat, nn, cn, chunk_rows=512)

    host = run_mice_stream(src, iters=3, noise=False, linreg_iters=3000,
                           chunk_rows=512, engine="host")
    dev = run_mice_stream(src, iters=3, noise=False, chunk_rows=512,
                          engine="device")
    np.testing.assert_array_equal(np.asarray(dev.dirty.cat_codes),
                                  np.asarray(host.dirty.cat_codes))
    np.testing.assert_allclose(np.asarray(dev.dirty.num_data),
                               np.asarray(host.dirty.num_data),
                               rtol=5e-3, atol=5e-3)
    # and checkpoint resume on the device engine lands on the same values
    import tempfile, os
    path = os.path.join(tempfile.mkdtemp(), "dev.ckpt")
    run_mice_stream(src, iters=1, noise=False, chunk_rows=512,
                    engine="device", checkpoint_path=path)
    resumed = run_mice_stream(src, iters=3, noise=False, chunk_rows=512,
                              engine="device", checkpoint_path=path)
    np.testing.assert_allclose(np.asarray(resumed.dirty.num_data),
                               np.asarray(dev.dirty.num_data),
                               rtol=5e-3, atol=5e-3)
