"""Sorted-segment grouped aggregation == masked grouped aggregation."""
import numpy as np

from duckdb_imputation_tpu import FeatureSchema
from duckdb_imputation_tpu.ring import sum_to_triple_grouped


def _data(n=20_000, seed=0, skew=False):
    rng = np.random.default_rng(seed)
    num = rng.normal(size=(3, n)).astype(np.float32)
    codes = rng.integers(0, 5, size=(2, n)).astype(np.int32)
    g = rng.integers(0, 7, size=n).astype(np.int32)
    if skew:
        g = np.where(np.arange(n) % 50 == 0, g, 2).astype(np.int32)
    schema = FeatureSchema(num_cols=3,
                           cat_keys=(tuple(range(5)), tuple(range(5))))
    return num, codes, g, schema


def _check(num, codes, g, schema, num_groups=7):
    a = sum_to_triple_grouped(num, codes, g, schema=schema,
                              num_groups=num_groups, method="masked")
    b = sum_to_triple_grouped(num, codes, g, schema=schema,
                              num_groups=num_groups, method="sorted")
    np.testing.assert_array_equal(np.asarray(a.n), np.asarray(b.n))
    np.testing.assert_array_equal(np.asarray(a.lin_cat),
                                  np.asarray(b.lin_cat))
    np.testing.assert_array_equal(np.asarray(a.cat_cat),
                                  np.asarray(b.cat_cat))
    np.testing.assert_allclose(np.asarray(a.quad), np.asarray(b.quad),
                               rtol=1e-5, atol=1e-2)


def test_sorted_equals_masked():
    _check(*_data())


def test_sorted_skewed():
    """95%+ of rows in one class — a hot key is just a longer contiguous
    range after the sort."""
    _check(*_data(skew=True))


def test_sorted_empty_groups():
    num, codes, g, schema = _data(n=500)
    g = np.where(g >= 3, 6, g).astype(np.int32)  # groups 3,4,5 empty
    _check(num, codes, g, schema)


def test_striped_sigma_equals_full():
    """Large-vocab striped evaluation reassembles to the full sigma."""
    import numpy as np
    from duckdb_imputation_tpu.ring.striped import sigma_striped
    from duckdb_imputation_tpu.ring.sum import masked_sigma
    from duckdb_imputation_tpu.ring.triple import sigma_from_triple

    rng = np.random.default_rng(1)
    n = 4000
    num = rng.normal(size=(2, n)).astype(np.float32)
    codes = rng.integers(0, 40, size=(2, n)).astype(np.int32)
    w = (rng.random(n) > 0.3).astype(np.float32)
    schema = FeatureSchema(num_cols=2,
                           cat_keys=(tuple(range(40)), tuple(range(40))))
    full = np.asarray(masked_sigma(num, codes, w, schema=schema))
    out = np.zeros_like(full)
    for lo, block in sigma_striped(num, codes, w, schema=schema, stripe=17):
        out[:, lo:lo + block.shape[1]] = np.asarray(block)
    np.testing.assert_allclose(out, full, rtol=1e-6, atol=1e-3)
