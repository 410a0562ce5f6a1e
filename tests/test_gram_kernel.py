"""The Gram kernel (ring/kernels/sigma_triton.py) in the Pallas interpreter,
and the one backend dispatch (backend.py) that chooses it.

The kernel's compiled GPU form is checked against the same references by
chip_smoke.py; here it runs with interpret=True on the CPU."""
import jax
import numpy as np
import pytest

from duckdb_imputation_tpu import FeatureSchema
from duckdb_imputation_tpu.backend import GRAM_MAX_P, resolve_kernel
from duckdb_imputation_tpu.ring.kernels.sigma_triton import (
    padded_width,
    sigma_triton,
)
from duckdb_imputation_tpu.ring.sum import masked_sigma, sum_to_triple

# name: (d, cat sizes, rows, weights, code range [lo, hi))
SCHEMAS = {
    "4_2": (4, (8, 8), 5_003, "binary", (0, 8)),
    "4_0": (4, (), 4_097, "binary", None),
    "cat_only": (0, (8, 8), 3_001, "binary", (0, 8)),
    "shared_bins": (1, (3, 3, 4), 2_049, "binary", (0, 3)),
    "oov_codes": (4, (8, 8), 3_333, "binary", (-1, 10)),
    "weighted": (4, (8, 8), 2_500, "real", (0, 8)),
    "widest": (8, (20, 20, 15), 1_500, "binary", (0, 20)),
    # x0 concentrated near 1.0003: TF32-rounded inputs would all read 1.0
    "near_const": (4, (8, 8), 2_777, "binary", (0, 8)),
}


def _case(name, seed=0):
    d, sizes, n, wkind, crange = SCHEMAS[name]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(d, n)).astype(np.float32)
    if name == "near_const":
        x[0] = (1.0003 + 1e-5 * rng.normal(size=n)).astype(np.float32)
    codes = (rng.integers(*crange, size=(len(sizes), n)).astype(np.int32)
             if sizes else np.zeros((0, n), np.int32))
    w = ((rng.random(n) > 0.2).astype(np.float32) if wkind == "binary"
         else (rng.random(n) * 3.0).astype(np.float32))
    schema = FeatureSchema(num_cols=d,
                           cat_keys=tuple(tuple(range(s)) for s in sizes))
    return x, codes, w, schema


def _sigma64(x, codes, w, schema):
    """Float64 numpy S = Zᵀ diag(w) Z; codes outside [0, size) hit no
    one-hot row."""
    n = w.shape[0]
    rows = [np.ones((1, n)), x.astype(np.float64)]
    for j, size in enumerate(schema.cat_sizes):
        rows.append((codes[j][None, :] == np.arange(size)[:, None])
                    .astype(np.float64))
    z = np.concatenate(rows, axis=0)
    return (z * w.astype(np.float64)) @ z.T


def _count_block(schema):
    """Index mask of the sections that are sums of weights only (N, the
    one-hot rows and the cat×cat block)."""
    p, d = schema.sigma_size, schema.num_cols
    cnt = np.zeros(p, bool)
    cnt[0] = True
    cnt[1 + d:] = True
    return np.ix_(cnt, cnt)


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_gram_kernel_matches_float64(name):
    """Counts exact (binary weights); every section within f32
    accumulation error of the float64 reference."""
    x, codes, w, schema = _case(name)
    got = np.asarray(sigma_triton(x, codes, w, schema=schema,
                                  interpret=True))
    ref = _sigma64(x, codes, w, schema)
    assert got.shape == (schema.sigma_size,) * 2
    cb = _count_block(schema)
    if SCHEMAS[name][3] == "binary":
        np.testing.assert_array_equal(got[cb], ref[cb])
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * scale)


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_gram_kernel_cols_match_masked_sigma(name, monkeypatch):
    """The per-column-tuple input (the MICE loops' carry) against the XLA
    aggregation on the stacked block, with a grid of 3 programs so each
    program walks several strided blocks."""
    from duckdb_imputation_tpu.ring.kernels import sigma_triton as kmod

    monkeypatch.setattr(kmod, "PROGRAMS", 3)
    x, codes, w, schema = _case(name, seed=1)
    got = np.asarray(sigma_triton(tuple(x), tuple(codes), w, schema=schema,
                                  interpret=True))
    ref = np.asarray(masked_sigma(x, codes, w, schema=schema))
    if SCHEMAS[name][3] == "binary":
        cb = _count_block(schema)
        np.testing.assert_array_equal(got[cb], ref[cb])
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())


def test_gram_kernel_stacked_equals_cols():
    x, codes, w, schema = _case("4_2", seed=2)
    a = sigma_triton(x, codes, w, schema=schema, interpret=True)
    b = sigma_triton(tuple(x), tuple(codes), w, schema=schema,
                     interpret=True)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_sum_to_triple_triton_interpret():
    x, codes, w, schema = _case("4_2", seed=3)
    got = sum_to_triple(x, codes, w, schema=schema, backend="triton",
                        interpret=True)
    ref = sum_to_triple(x, codes, w, schema=schema, backend="xla")
    assert float(got.n) == float(ref.n)
    np.testing.assert_array_equal(np.asarray(got.cat_cat),
                                  np.asarray(ref.cat_cat))
    np.testing.assert_allclose(np.asarray(got.quad), np.asarray(ref.quad),
                               rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("p, pp", [(2, 16), (16, 16), (17, 32), (21, 32),
                                   (64, 64)])
def test_padded_width(p, pp):
    assert padded_width(p) == pp


# --- the dispatch --------------------------------------------------------

def test_auto_is_xla_on_cpu():
    assert resolve_kernel("auto", 21, platform="cpu") == "xla"
    assert resolve_kernel("auto", 21) == "xla"      # this suite's backend


def test_auto_is_kernel_on_gpu_up_to_limit():
    assert resolve_kernel("auto", 21, platform="gpu") == "triton"
    assert resolve_kernel("auto", GRAM_MAX_P, platform="gpu") == "triton"
    assert resolve_kernel("auto", GRAM_MAX_P + 1, platform="gpu") == "xla"


def test_explicit_kernel_above_limit_raises():
    with pytest.raises(ValueError, match="P <= 64"):
        resolve_kernel("triton", GRAM_MAX_P + 1, platform="gpu")


def test_kernel_off_gpu_needs_interpret():
    with pytest.raises(ValueError, match="interpret=True"):
        resolve_kernel("triton", 21, platform="cpu")
    assert resolve_kernel("triton", 21, platform="cpu",
                          interpret=True) == "triton"
    x, codes, w, schema = _case("4_0")
    with pytest.raises(ValueError, match="needs a GPU"):
        sum_to_triple(x, codes, w, schema=schema, backend="triton")


@pytest.mark.parametrize("name", ["pallas", "pallas_fast", "pallas_fused",
                                  "fused"])
def test_retired_kernel_names_raise(name):
    """Retired names get a ValueError naming the valid choices, never a
    silent substitute — on every entry point that takes a kernel."""
    from duckdb_imputation_tpu.mice.device_round import run_mice_device
    from duckdb_imputation_tpu.ring.sum import (sum_to_nb_agg,
                                                sum_to_triple_grouped)
    from duckdb_imputation_tpu.table import from_numpy

    x, codes, w, schema = _case("4_2")
    with pytest.raises(ValueError, match="'auto', 'xla', 'triton'"):
        sum_to_triple(x, codes, w, schema=schema, backend=name)
    with pytest.raises(ValueError, match="'auto', 'masked', 'sorted'"):
        sum_to_triple_grouped(x, codes, np.zeros(w.shape, np.int32),
                              schema=schema, num_groups=2, method=name)
    with pytest.raises(ValueError, match="'auto', 'xla'"):
        sum_to_nb_agg(x, codes, w, schema=schema, backend=name)
    t = from_numpy(x.T[:64], codes.T[:64], np.zeros((64, 4), bool),
                   np.zeros((64, 2), bool))
    with pytest.raises(ValueError, match="valid choices"):
        run_mice_device(t, iters=1, kernel=name)


def test_qda_predict_method_validated():
    import jax.numpy as jnp

    from duckdb_imputation_tpu.models.device import qda_predict_device

    schema = FeatureSchema(num_cols=2)
    quad = -jnp.eye(2)[None]
    with pytest.raises(ValueError, match="'auto', 'xla'"):
        qda_predict_device(quad, jnp.zeros((1, 2)), jnp.zeros((1,)),
                           jnp.zeros((2, 8)), jnp.zeros((0, 8), jnp.int32),
                           schema=schema, method="pallas")


# --- the MICE loops with the interpreted kernel ---------------------------

def _mice_table(n=3_001, seed=4):
    from duckdb_imputation_tpu.table import from_numpy

    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, 2))
    num = np.stack([z[:, 0], 2 * z[:, 0] + z[:, 1], z[:, 1] - z[:, 0],
                    rng.normal(size=n)], 1).astype(np.float32)
    cat = np.stack([(z[:, 0] > 0).astype(int) * 3 + 4,
                    rng.integers(0, 5, n)], 1)
    nn = np.zeros_like(num, bool)
    cn = np.zeros_like(cat, bool)
    nn[rng.choice(n, n // 5, False), 1] = True
    cn[rng.choice(n, n // 5, False), 0] = True
    return lambda: from_numpy(num, cat, nn, cn), nn, cn


def _assert_same_imputation(a, b, nn, cn):
    xa, xb = np.asarray(a.num_data), np.asarray(b.num_data)
    np.testing.assert_allclose(xa, xb, rtol=1e-4, atol=1e-4)
    ca, cb = np.asarray(a.cat_codes), np.asarray(b.cat_codes)
    assert (ca[0, cn[:, 0]] == cb[0, cn[:, 0]]).mean() > 0.999


def test_run_mice_device_kernel_equals_xla():
    from duckdb_imputation_tpu.mice.device_round import run_mice_device

    make, nn, cn = _mice_table()
    kw = dict(iters=2, noise=False)
    a = run_mice_device(make(), kernel="triton", interpret=True, **kw)
    b = run_mice_device(make(), kernel="xla", **kw)
    _assert_same_imputation(a, b, nn, cn)


def test_run_mice_device_delta_kernel_equals_xla():
    from duckdb_imputation_tpu.mice.device_round import run_mice_device_delta

    make, nn, cn = _mice_table(seed=5)
    kw = dict(iters=2, noise=False)
    a = run_mice_device_delta(make(), kernel="triton", interpret=True, **kw)
    b = run_mice_device_delta(make(), kernel="xla", **kw)
    _assert_same_imputation(a, b, nn, cn)


def test_run_mice_sharded_kernel_equals_xla():
    """The kernel inside shard_map on the 8-device CPU mesh: each shard's
    partial sigma psum'd before the replicated solve."""
    from duckdb_imputation_tpu.mice.sharded_round import run_mice_sharded
    from duckdb_imputation_tpu.parallel import make_mesh

    assert len(jax.devices()) == 8
    make, nn, cn = _mice_table(seed=6)
    kw = dict(iters=2, noise=False, mesh=make_mesh())
    a = run_mice_sharded(make(), kernel="triton", interpret=True, **kw)
    b = run_mice_sharded(make(), kernel="xla", **kw)
    _assert_same_imputation(a, b, nn, cn)


def test_sum_to_triple_sharded_auto_takes_kernel_on_gpu(monkeypatch):
    """On a GPU backend sum_to_triple_sharded's shards aggregate with the
    Gram kernel (here interpreted on the 8 CPU devices, rows padded to a
    multiple of 8): counts identical to the single-device XLA triple."""
    from duckdb_imputation_tpu.parallel import make_mesh, sum_to_triple_sharded
    from duckdb_imputation_tpu.ring.kernels import sigma_triton as kmod

    calls = []

    def interpreted(*a, **k):
        calls.append(1)
        return sigma_triton(*a, **{**k, "interpret": True})

    x, codes, w, schema = _case("4_2", seed=8)
    ref = sum_to_triple(x, codes, w, schema=schema, backend="xla")
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(kmod, "sigma_triton", interpreted)
    got = sum_to_triple_sharded(x, codes, w, schema=schema, mesh=make_mesh())
    assert calls
    assert float(got.n) == float(ref.n)
    np.testing.assert_array_equal(np.asarray(got.cat_cat),
                                  np.asarray(ref.cat_cat))
    np.testing.assert_allclose(np.asarray(got.quad), np.asarray(ref.quad),
                               rtol=1e-5, atol=1e-2)


def test_run_mice_sharded_delta_kernel_equals_xla():
    from duckdb_imputation_tpu.mice.sharded_round import (
        run_mice_sharded_delta,
    )
    from duckdb_imputation_tpu.parallel import make_mesh

    make, nn, cn = _mice_table(seed=7)
    kw = dict(iters=2, noise=False, mesh=make_mesh())
    a = run_mice_sharded_delta(make(), kernel="triton", interpret=True, **kw)
    b = run_mice_sharded_delta(make(), kernel="xla", **kw)
    _assert_same_imputation(a, b, nn, cn)


# --- the compile cache directory rule -------------------------------------

def test_compile_cache_honours_env(monkeypatch, tmp_path):
    from duckdb_imputation_tpu import config

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert config.compilation_cache_dir() == str(tmp_path)


def test_compile_cache_defaults_inside_checkout(monkeypatch):
    import os

    from duckdb_imputation_tpu import config

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert config.compilation_cache_dir() == os.path.join(repo, ".jax_cache")
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
