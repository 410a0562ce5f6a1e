"""Test configuration: run everything on a virtual 8-device CPU mesh so
multi-device sharding is exercised without accelerators (the reference has
no distributed tests at all; see SURVEY.md §4). The platform is forced
through jax.config as well as the env var, so the suite stays on the CPU
whatever the host provides."""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

assert jax.devices()[0].platform == "cpu", jax.devices()


@pytest.fixture
def ring_test_table():
    """The reference's 5-row ring-op test table
    (duckdb_extension/test/python/test_sum.py:15-16):
      gb, a, b, c FLOAT; d, e, f INTEGER."""
    gb = np.array([1, 1, 2, 2, 2], np.int32)
    num = np.array([
        [1, 2, 3],
        [5, 6, 7],
        [2, 1, 3],
        [5, 7, 6],
        [2, 1, 3],
    ], np.float32)
    cat = np.array([
        [4, 5, 6],
        [8, 9, 10],
        [4, 6, 8],
        [8, 10, 12],
        [4, 6, 8],
    ], np.int64)
    return gb, num, cat


@pytest.fixture
def lift_test_table():
    """test_lift.py:15-16 variant (row 4 has gb=1)."""
    gb = np.array([1, 1, 2, 1, 2], np.int32)
    num = np.array([
        [1, 2, 3],
        [5, 6, 7],
        [2, 1, 3],
        [5, 7, 6],
        [2, 1, 3],
    ], np.float32)
    cat = np.array([
        [4, 5, 6],
        [8, 9, 10],
        [4, 6, 8],
        [8, 10, 12],
        [4, 6, 8],
    ], np.int64)
    return gb, num, cat
