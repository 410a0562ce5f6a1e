"""Multi-device tests on the virtual 8-device CPU mesh: the same triple must
come out of 1 chip and N shards (exact equality on count-valued sections,
tolerance on f32 sums) — the test class the reference lacks entirely
(SURVEY.md §4 implication d)."""
import jax
import numpy as np
import pytest

from duckdb_imputation_tpu import FeatureSchema
from duckdb_imputation_tpu.ring import (
    sum_to_triple,
    sum_to_triple_grouped,
    triple_to_dict,
)
from duckdb_imputation_tpu.parallel import (
    make_mesh,
    sum_to_triple_grouped_sharded,
    sum_to_triple_sharded,
)


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(3)
    n = 10_000
    num = rng.normal(size=(n, 4)).astype(np.float32)
    cat = rng.integers(0, 6, size=(n, 2)) * 3 + 1
    g = rng.integers(0, 5, size=n).astype(np.int32)
    w = rng.integers(0, 2, size=n).astype(np.float32)
    schema = FeatureSchema.infer(num, cat)
    return num, cat, g, w, schema


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_sharded_equals_single(table):
    num, cat, g, w, schema = table
    codes = schema.encode(cat).T
    single = sum_to_triple(num.T, codes, w, schema=schema)
    mesh = make_mesh()
    shard = sum_to_triple_sharded(num.T, codes, w, schema=schema, mesh=mesh)
    # integer-valued sections: exact
    np.testing.assert_array_equal(np.asarray(shard.n), np.asarray(single.n))
    np.testing.assert_array_equal(np.asarray(shard.lin_cat),
                                  np.asarray(single.lin_cat))
    np.testing.assert_array_equal(np.asarray(shard.cat_cat),
                                  np.asarray(single.cat_cat))
    # f32 sums: reduction-order tolerance
    np.testing.assert_allclose(np.asarray(shard.quad),
                               np.asarray(single.quad), rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(np.asarray(shard.lin),
                               np.asarray(single.lin), rtol=1e-6, atol=1e-3)


def test_sharded_uneven_rows(table):
    """Row counts not divisible by the mesh: zero-weight padding."""
    num, cat, g, w, schema = table
    codes = schema.encode(cat).T
    n = 8 * 1237 + 5
    single = sum_to_triple(num[:n].T, codes[:, :n], w[:n], schema=schema)
    shard = sum_to_triple_sharded(num[:n].T, codes[:, :n], w[:n],
                                  schema=schema)
    assert float(shard.n) == float(single.n)
    np.testing.assert_array_equal(np.asarray(shard.lin_cat),
                                  np.asarray(single.lin_cat))


def test_sharded_grouped_equals_single(table):
    num, cat, g, w, schema = table
    codes = schema.encode(cat).T
    single = sum_to_triple_grouped(num.T, codes, g, schema=schema,
                                   num_groups=5)
    shard = sum_to_triple_grouped_sharded(num.T, codes, g, schema=schema,
                                          num_groups=5)
    np.testing.assert_array_equal(np.asarray(shard.n), np.asarray(single.n))
    np.testing.assert_array_equal(np.asarray(shard.lin_cat),
                                  np.asarray(single.lin_cat))
    np.testing.assert_allclose(np.asarray(shard.quad),
                               np.asarray(single.quad), rtol=1e-6, atol=1e-3)


def test_sharded_skewed_groups(table):
    """Skewed class distribution (the BASELINE.json QDA config): 95% of rows
    in one class; sharded result still exact on counts."""
    num, cat, g, w, schema = table
    codes = schema.encode(cat).T
    g_skew = np.where(np.arange(len(g)) % 20 == 0, g, 0).astype(np.int32)
    single = sum_to_triple_grouped(num.T, codes, g_skew, schema=schema,
                                   num_groups=5)
    shard = sum_to_triple_grouped_sharded(num.T, codes, g_skew, schema=schema,
                                          num_groups=5)
    np.testing.assert_array_equal(np.asarray(shard.n), np.asarray(single.n))
    np.testing.assert_array_equal(np.asarray(shard.lin_cat),
                                  np.asarray(single.lin_cat))


def test_device_train_matches_host(table):
    """Device GD (lax.while_loop) ≈ host f64 GD on the same sigma."""
    from duckdb_imputation_tpu.models.device import linreg_train_device
    from duckdb_imputation_tpu.models import linreg_train, linreg_predict
    from duckdb_imputation_tpu.ring.triple import sigma_from_triple
    num, cat, g, w, schema = table
    codes = schema.encode(cat).T
    t = sum_to_triple(num.T, codes, None, schema=schema)
    sigma = sigma_from_triple(t)
    coeff = np.asarray(linreg_train_device(sigma, label=1, max_iters=500))
    params = linreg_train(t, schema, label=0, max_iters=500)
    # compare predictions rather than raw coeffs (different precisions)
    from duckdb_imputation_tpu.models.device import linreg_predict_device
    import jax.numpy as jnp
    from duckdb_imputation_tpu.ring.sum import _zt_block
    zt = _zt_block(jnp.asarray(num[:200].T), jnp.asarray(codes[:, :200]),
                   schema)
    pred_dev = np.asarray(linreg_predict_device(jnp.asarray(coeff), zt, 1))
    pred_host = np.asarray(linreg_predict(params, num[:200, 1:].T,
                                          codes[:, :200]))
    np.testing.assert_allclose(pred_dev, pred_host, rtol=1e-3, atol=1e-3)


def test_full_mice_column_step_shards(table):
    """The dryrun_multichip content: one on-device MICE column step jitted
    over the mesh (aggregate sharded, train replicated, predict sharded)."""
    from duckdb_imputation_tpu.models.device import mice_column_step_device
    num, cat, g, w, schema = table
    codes = schema.encode(cat).T
    import jax.numpy as jnp
    null_mask = jnp.asarray(w > 0.5)
    new_x, coeff = mice_column_step_device(
        jnp.asarray(num.T), jnp.asarray(codes), null_mask, schema=schema,
        label=0, max_iters=50)
    assert np.isfinite(np.asarray(new_x)).all()
    assert np.isfinite(np.asarray(coeff)).all()


def test_sharded_2d_equals_single(table):
    """Rows over 'data' x sigma columns over 'model' (4x2 mesh) == single
    device result."""
    from duckdb_imputation_tpu.parallel.sharded2d import (
        make_mesh_2d,
        sum_to_triple_sharded2d,
    )
    num, cat, g, w, schema = table
    codes = schema.encode(cat).T
    single = sum_to_triple(num.T, codes, w, schema=schema)
    mesh = make_mesh_2d(4, 2)
    shard = sum_to_triple_sharded2d(num.T, codes, w, schema=schema,
                                    mesh=mesh)
    np.testing.assert_array_equal(np.asarray(shard.n), np.asarray(single.n))
    np.testing.assert_array_equal(np.asarray(shard.lin_cat),
                                  np.asarray(single.lin_cat))
    np.testing.assert_allclose(np.asarray(shard.quad),
                               np.asarray(single.quad), rtol=1e-6, atol=1e-3)
    np.testing.assert_array_equal(np.asarray(shard.cat_cat),
                                  np.asarray(single.cat_cat))


def test_qda_nb_device_trainers(table):
    """Device QDA/NB trainers match the host f64 parity trainers'
    predictions."""
    import jax.numpy as jnp
    from duckdb_imputation_tpu.models.device import (
        nb_train_device,
        qda_train_device,
    )
    from duckdb_imputation_tpu.models import (
        NBParams, QDAParams, nb_train, qda_train,
    )
    from duckdb_imputation_tpu.ring import (
        sum_to_nb_agg_grouped,
        sum_to_triple_grouped,
    )
    from duckdb_imputation_tpu.ring.triple import sigma_from_triple
    from duckdb_imputation_tpu.models.sigma import build_sigma, select_vocab
    num, cat, g, w, schema = table
    labels = np.arange(5)
    g5 = (g % 5).astype(np.int32)

    # QDA: numeric-only per-class triples
    s_num = FeatureSchema(num_cols=4)
    triples = sum_to_triple_grouped(num.T, None, g5, schema=s_num,
                                    num_groups=5)
    host = QDAParams.decode(qda_train(triples, s_num, labels), 4, False)
    sigmas = sigma_from_triple(triples)
    quad, lin, b = qda_train_device(jnp.asarray(sigmas),
                                    jnp.asarray(float(len(g5))), 1)
    np.testing.assert_allclose(np.asarray(quad), host.quad, rtol=2e-2,
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(b), host.intercept, rtol=2e-2,
                               atol=1e-2)

    # NB
    aggs = sum_to_nb_agg_grouped(num.T, None, g5, schema=s_num, num_groups=5)
    hostn = NBParams.decode(nb_train(aggs, s_num, labels), 4)
    pri, mean, var, _ = nb_train_device(aggs.n, aggs.lin, aggs.quad_diag,
                                        aggs.lin_cat)
    np.testing.assert_allclose(np.asarray(pri), hostn.priors, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(mean), hostn.mean, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(var), hostn.var, rtol=1e-3,
                               atol=1e-3)


def test_overlapped_equals_sharded(table):
    """Pipeline-overlapped striped collective (parallel/overlap.py): exact
    on count-valued sections, f32 accumulation-order tolerance on sums."""
    from duckdb_imputation_tpu.parallel import sum_to_triple_overlapped

    num, cat, g, w, schema = table
    codes = schema.encode(cat).T
    mesh = make_mesh()
    plain = sum_to_triple_sharded(num.T, codes, w, schema=schema, mesh=mesh)
    # 5 stripes over sigma_size=41 -> width 9, padded tail stripe
    over = sum_to_triple_overlapped(num.T, codes, w, schema=schema,
                                    mesh=mesh, n_stripes=5, row_chunk=1024)
    np.testing.assert_array_equal(np.asarray(over.n), np.asarray(plain.n))
    np.testing.assert_array_equal(np.asarray(over.lin_cat),
                                  np.asarray(plain.lin_cat))
    np.testing.assert_array_equal(np.asarray(over.cat_cat),
                                  np.asarray(plain.cat_cat))
    np.testing.assert_allclose(np.asarray(over.quad),
                               np.asarray(plain.quad), rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(np.asarray(over.lin),
                               np.asarray(plain.lin), rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(np.asarray(over.num_cat),
                               np.asarray(plain.num_cat),
                               rtol=1e-6, atol=1e-3)


def test_overlapped_hlo_has_per_stripe_collectives():
    """The compiled striped program all-reduces per-stripe
    [P, P/n_stripes] payloads INSIDE the stripe loop — not one fused
    [P, P] collective after all compute. This is the structural property
    that lets the XLA scheduler issue stripe k's collective
    asynchronously behind stripe k+1's matmuls (the overlap design-intent;
    multi-chip wall-clock cannot be measured in this 1-chip environment)."""
    import functools
    import re

    import jax

    from duckdb_imputation_tpu.parallel.overlap import (
        _sharded_sigma_overlapped,
    )

    schema = FeatureSchema(num_cols=2,
                           cat_keys=(tuple(range(30)), tuple(range(30))))
    mesh = make_mesh(8)
    p = schema.sigma_size                      # 63
    n_stripes = 4
    width = -(-p // n_stripes)                 # 16
    n = 8 * 1024
    x = np.zeros((2, n), np.float32)
    c = np.zeros((2, n), np.int32)
    w = np.ones(n, np.float32)
    txt = jax.jit(functools.partial(
        _sharded_sigma_overlapped, schema=schema, mesh=mesh,
        n_stripes=n_stripes, row_chunk=512, axis="data",
    )).lower(x, c, w).compile().as_text()
    shapes = re.findall(r"f32\[(\d+),(\d+)\]\{[0-9,]*\} all-reduce", txt)
    assert shapes, "no all-reduce in compiled module"
    # every collective is a stripe-sized payload; no [P, P] monolith
    assert all((int(a), int(b)) == (p, width) for a, b in shapes), shapes


def test_overlapped_no_numeric_cols(table):
    from duckdb_imputation_tpu.parallel import sum_to_triple_overlapped

    num, cat, g, w, schema0 = table
    schema = FeatureSchema(num_cols=0, cat_keys=schema0.cat_keys)
    codes = schema.encode(cat).T
    mesh = make_mesh()
    single = sum_to_triple(None, codes, w, schema=schema)
    over = sum_to_triple_overlapped(None, codes, w, schema=schema,
                                    mesh=mesh, n_stripes=3)
    np.testing.assert_array_equal(np.asarray(over.lin_cat),
                                  np.asarray(single.lin_cat))
    np.testing.assert_array_equal(np.asarray(over.cat_cat),
                                  np.asarray(single.cat_cat))
    np.testing.assert_array_equal(np.asarray(over.n), np.asarray(single.n))


def test_mice_sharded_matches_device():
    """The full sharded MICE loop (mice/sharded_round.py — psum'd
    aggregation, replicated solve, shard-local write-back) recovers the
    same imputations as the single-device fused loop."""
    from duckdb_imputation_tpu.mice.device_round import run_mice_device
    from duckdb_imputation_tpu.mice.sharded_round import run_mice_sharded
    from duckdb_imputation_tpu.table import from_numpy

    rng = np.random.default_rng(11)
    n = 20_003  # deliberately not divisible by 8 (row padding path)
    z = rng.normal(size=(n, 2))
    num = np.stack([z[:, 0], 2 * z[:, 0] + z[:, 1], z[:, 1] - z[:, 0],
                    rng.normal(size=n)], 1).astype(np.float32)
    cat = ((z[:, 0] > 0).astype(int) * 3 + 4)[:, None]
    nn = np.zeros_like(num, bool)
    cn = np.zeros_like(cat, bool)
    nn[rng.choice(n, n // 5, False), 1] = True
    cn[rng.choice(n, n // 5, False), 0] = True

    t1 = from_numpy(num, cat, nn, cn)
    single = run_mice_device(t1, iters=2, gd_iters=300, noise=False,
                             kernel="xla")
    t2 = from_numpy(num, cat, nn, cn)
    sharded = run_mice_sharded(t2, iters=2, gd_iters=300, noise=False,
                               mesh=make_mesh())

    xs = np.asarray(sharded.num_data)
    xd = np.asarray(single.num_data)
    # same imputations up to psum reduction order feeding the GD train
    np.testing.assert_allclose(xs[1, nn[:, 1]], xd[1, nn[:, 1]], atol=1e-2)
    # categorical imputations: identical class picks
    assert (np.asarray(sharded.cat_codes)[0, cn[:, 0]]
            == np.asarray(single.cat_codes)[0, cn[:, 0]]).mean() > 0.999
    # and both recover the noiseless linear relation
    truth = num[nn[:, 1], 1]
    rmse = float(np.sqrt(np.mean((xs[1, nn[:, 1]] - truth) ** 2)))
    assert rmse < 0.05, rmse


def test_mice_sharded_with_noise_runs():
    from duckdb_imputation_tpu.mice.sharded_round import run_mice_sharded
    from duckdb_imputation_tpu.table import from_numpy

    rng = np.random.default_rng(12)
    n = 4096
    b = rng.normal(size=n).astype(np.float32)
    a = 3 * b
    nn = np.zeros((n, 2), bool)
    nn[rng.choice(n, n // 4, False), 0] = True
    t = from_numpy(np.stack([a, b], 1), None, nn, None)
    out = run_mice_sharded(t, iters=2, gd_iters=200, noise=True,
                           mesh=make_mesh())
    vals = np.asarray(out.num_data)[0]
    assert np.isfinite(vals).all()
    # noise actually varies across imputed rows
    imputed = vals[nn[:, 0]]
    resid = imputed - 3 * b[nn[:, 0]]
    assert np.unique(np.round(resid, 6)).size > 10


def test_mice_sharded_noise_mesh_invariant():
    """Stochastic MICE is reproducible ACROSS MESH SHAPES: noise is keyed
    by (round, column, global row index), so 2-device and 8-device runs —
    and the full-rescan and delta sharded loops' noise streams — do not
    depend on shard boundaries. (The reference's /dev/urandom stream is
    unreproducible even run-to-run, regression.cpp:377-395.)"""
    from duckdb_imputation_tpu.mice.sharded_round import (
        run_mice_sharded,
        run_mice_sharded_delta,
    )
    from duckdb_imputation_tpu.table import from_numpy

    rng = np.random.default_rng(21)
    n = 4096
    b = rng.normal(size=n).astype(np.float32)
    a = 3 * b + 0.1 * rng.normal(size=n).astype(np.float32)
    cat = ((b > 0).astype(np.int64) * 5 + 2)[:, None]
    nn = np.zeros((n, 2), bool)
    nn[rng.choice(n, n // 4, False), 0] = True
    cn = np.zeros((n, 1), bool)
    cn[rng.choice(n, n // 5, False), 0] = True

    def run(fn, ndev):
        t = from_numpy(np.stack([a, b], 1), cat.copy(), nn, cn)
        out = fn(t, iters=2, gd_iters=50, noise=True, seed=7,
                 mesh=make_mesh(ndev))
        return np.asarray(out.num_data), np.asarray(out.cat_codes)

    for fn in (run_mice_sharded, run_mice_sharded_delta):
        x2, c2 = run(fn, 2)
        x8, c8 = run(fn, 8)
        # the noise stream is bit-identical across meshes; the residual
        # ~3e-5 comes from f32 psum reduction order in the sigma (2 vs 8
        # partials) feeding the solve — orders below the 0.1 noise scale
        np.testing.assert_allclose(x2, x8, rtol=1e-4, atol=5e-4)
        np.testing.assert_array_equal(c2, c8)
        # and the noise is real: imputed values differ from the noiseless run
        t0 = from_numpy(np.stack([a, b], 1), cat.copy(), nn, cn)
        out0 = fn(t0, iters=2, gd_iters=50, noise=False, seed=7,
                  mesh=make_mesh(8))
        assert not np.allclose(np.asarray(out0.num_data)[0, nn[:, 0]],
                               x8[0, nn[:, 0]])


def test_factorized_join_sharded_equals_single(table):
    """Sharded factorized join-aggregate == single-device fused contraction
    (and therefore == the materialized join, pinned elsewhere)."""
    from duckdb_imputation_tpu.parallel import factorized_join_sum_sharded
    from duckdb_imputation_tpu.ring.triple import factorized_join_sum
    num, cat, g, w, schema = table
    rng = np.random.default_rng(9)
    keys = 16
    k1 = rng.integers(0, keys, num.shape[0]).astype(np.int32)
    n2 = 3000
    num2 = rng.normal(size=(n2, 2)).astype(np.float32)
    cat2 = rng.integers(0, 3, size=(n2, 1)) * 5
    k2 = rng.integers(0, keys, n2).astype(np.int32)
    s2 = FeatureSchema.infer(num2, cat2)

    x1, c1 = num.T, schema.encode(cat).T
    x2, c2 = num2.T, s2.encode(cat2).T
    single = factorized_join_sum(
        sum_to_triple_grouped(x1, c1, k1, schema=schema, num_groups=keys),
        sum_to_triple_grouped(x2, c2, k2, schema=s2, num_groups=keys))
    sharded = factorized_join_sum_sharded(
        x1, c1, k1, x2, c2, k2, schema1=schema, schema2=s2,
        num_keys=keys, mesh=make_mesh())
    np.testing.assert_allclose(np.asarray(sharded.n), np.asarray(single.n))
    for lhs, rhs in zip(jax.tree.leaves(sharded), jax.tree.leaves(single)):
        np.testing.assert_allclose(np.asarray(lhs), np.asarray(rhs),
                                   rtol=1e-4, atol=1e-2)


def test_mice_factorized_sharded_matches_plain():
    """Factorized MICE with the sharded grouped aggregate swapped in gives
    the same imputation as the single-device grouped aggregate."""
    from duckdb_imputation_tpu.table import from_numpy
    from duckdb_imputation_tpu.mice import run_mice_factorized
    from duckdb_imputation_tpu.parallel import sum_to_triple_grouped_sharded
    import functools

    rng = np.random.default_rng(5)
    keys, n = 8, 4000
    dz = (rng.normal(size=keys) * 2).astype(np.float32)
    dim = from_numpy(dz[:, None], rng.integers(0, 3, keys)[:, None])
    fk = rng.integers(0, keys, n)
    x2 = rng.normal(size=n).astype(np.float32)
    x1 = (1.5 * dz[fk] + 0.5 * x2).astype(np.float32)
    nn = np.zeros((n, 2), bool)
    nn[rng.choice(n, n // 4, replace=False), 0] = True
    fact = from_numpy(np.stack([x1, x2], 1), rng.integers(0, 2, n)[:, None],
                      nn, np.zeros((n, 1), bool))

    kw = dict(iters=2, linreg_iters=200, noise=False)
    plain = run_mice_factorized(fact, fk, dim, **kw)
    sharded = run_mice_factorized(
        fact, fk, dim,
        grouped_aggregate=functools.partial(
            sum_to_triple_grouped_sharded, mesh=make_mesh()), **kw)
    np.testing.assert_allclose(np.asarray(sharded.num_data),
                               np.asarray(plain.num_data),
                               rtol=1e-3, atol=1e-3)


def test_mice_sharded_delta_matches_device_delta():
    """Sharded delta-MICE (per-shard dirty gathers, psum'd P×P deltas,
    replicated full/train — imputation_low.cpp:42-110 over the mesh)
    recovers the single-device fused delta loop's imputations."""
    from duckdb_imputation_tpu.mice.device_round import run_mice_device_delta
    from duckdb_imputation_tpu.mice.sharded_round import (
        run_mice_sharded_delta,
    )
    from duckdb_imputation_tpu.table import from_numpy

    rng = np.random.default_rng(17)
    n = 20_011  # not divisible by 8: row-padding + shard-local gathers
    z = rng.normal(size=(n, 2))
    num = np.stack([z[:, 0], 2 * z[:, 0] + z[:, 1], z[:, 1] - z[:, 0],
                    rng.normal(size=n)], 1).astype(np.float32)
    cat = ((z[:, 0] > 0).astype(int) * 3 + 4)[:, None]
    nn = np.zeros_like(num, bool)
    cn = np.zeros_like(cat, bool)
    nn[rng.choice(n, n // 20, False), 1] = True   # low-missing regime
    cn[rng.choice(n, n // 20, False), 0] = True
    nn[0, 1] = True   # dirty row 0: exercises the scatter-ADD pad aliasing

    single = run_mice_device_delta(from_numpy(num, cat, nn, cn), iters=2,
                                   noise=False, kernel="xla")
    sharded = run_mice_sharded_delta(from_numpy(num, cat, nn, cn), iters=2,
                                     noise=False, mesh=make_mesh())

    xs, xd = np.asarray(sharded.num_data), np.asarray(single.num_data)
    np.testing.assert_allclose(xs[1, nn[:, 1]], xd[1, nn[:, 1]], atol=1e-2)
    assert (np.asarray(sharded.cat_codes)[0, cn[:, 0]]
            == np.asarray(single.cat_codes)[0, cn[:, 0]]).mean() > 0.999
    # untouched cells bitwise identical
    obs = ~nn[:, 1]
    np.testing.assert_array_equal(xs[1, obs], num[obs, 1])
    # and the noiseless linear relation is recovered
    truth = num[nn[:, 1], 1]
    rmse = float(np.sqrt(np.mean((xs[1, nn[:, 1]] - truth) ** 2)))
    assert rmse < 0.05, rmse


def test_qda_predict_device_matches_host(table):
    """Batched device QDA predict (Cholesky-factored scoring) agrees with
    the host f64 predict on the same per-class triples."""
    import jax.numpy as jnp
    from duckdb_imputation_tpu.models import qda_predict, qda_train
    from duckdb_imputation_tpu.models.device import (
        qda_predict_device,
        qda_train_device,
    )
    from duckdb_imputation_tpu.ring import sum_to_triple_grouped
    from duckdb_imputation_tpu.ring.triple import sigma_from_triple

    num, cat, g, w, schema = table
    g5 = (g % 5).astype(np.int32)
    s_num = FeatureSchema(num_cols=4)
    triples = sum_to_triple_grouped(num.T, None, g5, schema=s_num,
                                    num_groups=5)
    labels = list(range(5))
    params = qda_train(triples, s_num, labels)
    want = np.asarray(qda_predict(params, num.T, None))

    sigmas = sigma_from_triple(triples)
    quad, lin, b = qda_train_device(jnp.asarray(sigmas),
                                    jnp.asarray(float(len(g5))), 1)
    got = np.asarray(qda_predict_device(
        quad, lin, b, jnp.asarray(num.T),
        jnp.zeros((0, num.shape[0]), jnp.int32), schema=s_num))
    # host returns label VALUES (= indices here), device returns indices
    assert (got == want).mean() > 0.999, (got[:20], want[:20])


def test_nb_predict_device_matches_host(table):
    """Device NB predict (QDA-with-diagonal-quad through the shared
    batched scorer) agrees with the host probability-space predict on
    in-vocab data (incl. categorical features)."""
    import jax.numpy as jnp
    from duckdb_imputation_tpu.models import NBParams, nb_predict, nb_train
    from duckdb_imputation_tpu.models.device import (
        nb_predict_device,
        nb_train_device,
    )
    from duckdb_imputation_tpu.ring import sum_to_nb_agg_grouped

    num, cat, g, w, schema = table
    codes = schema.encode(cat).T
    g5 = (g % 5).astype(np.int32)
    labels = list(range(5))
    aggs = sum_to_nb_agg_grouped(num.T, codes, g5, schema=schema,
                                 num_groups=5)
    params = nb_train(aggs, schema, labels)
    want = np.asarray(nb_predict(params, num.T, codes))

    pri, mean, var, freqs = nb_train_device(aggs.n, aggs.lin,
                                            aggs.quad_diag, aggs.lin_cat)
    got_idx = np.asarray(nb_predict_device(pri, mean, var, freqs,
                                           jnp.asarray(num.T),
                                           jnp.asarray(codes),
                                           schema=schema))
    got = np.asarray(labels)[got_idx]
    assert (got == want).mean() > 0.999, (got[:20], want[:20])


@pytest.mark.parametrize("kernel, interpret", [("xla", False),
                                               ("triton", True)])
def test_mice_sharded_checkpoint_resume(tmp_path, kernel, interpret):
    """Round-boundary checkpointing of the sharded loop on a mixed
    3-numeric + 2-categorical table: a run killed after 1 of 3 rounds and
    resumed equals the uninterrupted run, with either aggregation."""
    from duckdb_imputation_tpu.mice.sharded_round import run_mice_sharded
    from duckdb_imputation_tpu.table import from_numpy

    rng = np.random.default_rng(33)
    n = 4_099
    cls = rng.integers(0, 3, size=n)
    z = rng.normal(size=n)
    num = np.stack([cls * 2.0 + 0.3 * z,
                    0.7 * cls + 0.2 * rng.normal(size=n),
                    rng.normal(size=n)], 1).astype(np.float32)
    cat = np.stack([cls, rng.integers(0, 5, size=n)], 1)
    nn = np.zeros_like(num, bool)
    cn = np.zeros_like(cat, bool)
    nn[rng.random(n) < 0.2, 1] = True
    cn[rng.random(n) < 0.2, 0] = True
    kw = dict(mesh=make_mesh(), kernel=kernel, interpret=interpret,
              trainer="solve", noise=True, seed=3)

    straight = run_mice_sharded(from_numpy(num, cat, nn, cn), iters=3, **kw)
    path = str(tmp_path / "sharded.ckpt")
    run_mice_sharded(from_numpy(num, cat, nn, cn), iters=1,
                     checkpoint_path=path, **kw)                # "killed"
    resumed = run_mice_sharded(from_numpy(num, cat, nn, cn), iters=3,
                               checkpoint_path=path, **kw)

    np.testing.assert_array_equal(np.asarray(resumed.cat_codes),
                                  np.asarray(straight.cat_codes))
    np.testing.assert_allclose(np.asarray(resumed.num_data),
                               np.asarray(straight.num_data),
                               rtol=1e-6, atol=1e-6)


def test_sharded_scan_path_equals_single(table):
    """Shards longer than row_chunk take masked_sigma's lax.scan path inside
    shard_map (the scan carry must vary over the mesh axis like the data);
    counts exact, both ungrouped and grouped."""
    from duckdb_imputation_tpu.parallel.sharded import (
        sum_to_triple_grouped_sharded,
    )

    num, cat, g, w, schema = table
    codes = schema.encode(cat).T
    mesh = make_mesh()
    single = sum_to_triple(num.T, codes, w, schema=schema)
    shard = sum_to_triple_sharded(num.T, codes, w, schema=schema, mesh=mesh,
                                  row_chunk=256)
    np.testing.assert_array_equal(np.asarray(shard.n), np.asarray(single.n))
    np.testing.assert_array_equal(np.asarray(shard.cat_cat),
                                  np.asarray(single.cat_cat))
    np.testing.assert_allclose(np.asarray(shard.quad),
                               np.asarray(single.quad), rtol=1e-5)
    grouped = sum_to_triple_grouped_sharded(num.T, codes, g, schema=schema,
                                            num_groups=5, mesh=mesh,
                                            row_chunk=256)
    want = np.bincount(g, minlength=5)
    np.testing.assert_array_equal(np.asarray(grouped.n), want)
