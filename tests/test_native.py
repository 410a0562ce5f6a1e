"""Native columnar store / CSV loader tests (C++ via ctypes)."""
import os
import shutil
import subprocess

import numpy as np
import pytest

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain")


@pytest.fixture(scope="module")
def csv_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("native") / "t.csv"
    rows = [
        "a,b,d,e",
        "1.5,2,4,5",
        "2.5,,8,9",          # null b
        "3.5,1,4,NULL",      # null e
        "NaN,7,12,5",        # null a
        "5.0,3,8,9",
    ]
    p.write_text("\n".join(rows) + "\n")
    return str(p)


def test_load_csv_types_and_values(csv_file):
    from duckdb_imputation_tpu.table.native import load_csv
    t = load_csv(csv_file)
    assert t.n_rows == 5
    assert t.n_cols == 4
    assert [t.col_name(c) for c in range(4)] == ["a", "b", "d", "e"]
    # dispatch rule: '1.5' etc -> numeric; pure ints -> categorical
    assert t.is_numeric(0) and not t.is_numeric(2)
    np.testing.assert_allclose(t.col_f32(0), [1.5, 2.5, 3.5, 0.0, 5.0])
    np.testing.assert_array_equal(t.col_null(0), [0, 0, 0, 1, 0])
    np.testing.assert_array_equal(t.col_i64(2), [4, 8, 4, 12, 8])
    # b: '2','1','7','3' + one null — ints but null makes it still int col
    assert not t.is_numeric(1)
    np.testing.assert_array_equal(t.col_null(1), [0, 1, 0, 0, 0])


def test_vocab_and_codes(csv_file):
    from duckdb_imputation_tpu.table.native import load_csv
    t = load_csv(csv_file)
    np.testing.assert_array_equal(t.col_vocab(2), [4, 8, 12])
    np.testing.assert_array_equal(t.col_codes(2), [0, 1, 0, 2, 1])
    # null rows get code -1
    assert t.col_codes(1)[1] == -1


def test_to_device_table(csv_file):
    from duckdb_imputation_tpu.table.native import read_csv
    tbl = read_csv(csv_file)
    assert tbl.schema.num_cols == 1
    assert tbl.schema.cat_cols == 3
    assert tbl.n_rows == 5
    assert bool(np.asarray(tbl.num_null)[0, 3])      # NaN a -> null
    assert tbl.schema.cat_keys[1] == (4, 8, 12)      # column d vocab


def test_column_swap(csv_file):
    from duckdb_imputation_tpu.table.native import load_csv
    t = load_csv(csv_file)
    new = np.arange(5, dtype=np.float32)
    t.swap_col_f32(0, new)
    np.testing.assert_array_equal(t.col_f32(0), new)


def test_parallel_parse_large(tmp_path):
    """Multithreaded parse produces identical results to numpy on a larger
    file (row-range partition boundaries exercised)."""
    rng = np.random.default_rng(0)
    n = 50_000
    a = rng.normal(size=n).astype(np.float32)
    b = rng.integers(0, 50, size=n)
    lines = ["a,b"] + [f"{float(a[i]):.7g},{b[i]}" for i in range(n)]
    p = tmp_path / "big.csv"
    p.write_text("\n".join(lines) + "\n")
    from duckdb_imputation_tpu.table.native import load_csv
    t = load_csv(str(p), n_threads=4)
    assert t.n_rows == n
    np.testing.assert_allclose(t.col_f32(0), a, rtol=1e-6)
    np.testing.assert_array_equal(t.col_i64(1), b)


def test_string_categorical_csv(tmp_path):
    """String columns dictionary-encode in the native parser: sorted
    labels, dense codes, nulls, and a numeric token in a string column
    canonicalizes to its "%g" label."""
    p = tmp_path / "s.csv"
    p.write_text("x,color,g\n"
                 "0.5,red,1\n"
                 "1.5,blue,2\n"
                 "2.5,,1\n"
                 "3.5,red,2\n"
                 "4.5,3,1\n")
    from duckdb_imputation_tpu.table.native import load_csv, read_csv
    t = load_csv(str(p))
    assert t.is_numeric(0) and not t.is_string(0)
    assert t.is_string(1) and not t.is_numeric(1)
    assert not t.is_string(2)                      # int stays int
    assert t.col_labels(1) == ("3", "blue", "red")  # sorted
    np.testing.assert_array_equal(t.col_i64(1), [2, 1, 0, 2, 0])
    np.testing.assert_array_equal(t.col_null(1),
                                  [False, False, True, False, False])

    tbl = read_csv(str(p))
    assert tbl.cat_names == ("color", "g")
    assert tbl.cat_labels == (("3", "blue", "red"), None)
    df = tbl.to_pandas(nulls_as_na=True)
    got = df["color"].tolist()
    assert got[0] == "red" and got[1] == "blue" and got[4] == "3"
    import pandas as pd
    assert pd.isna(got[2])


def test_string_mixed_whitespace_and_null_markers(tmp_path):
    """Trimming + extended null markers: ' red ' == 'red'; n/a and none
    are nulls, not categories; a stray string token flips an otherwise
    numeric column to string."""
    p = tmp_path / "w.csv"
    p.write_text("a,b\n red ,1\nn/a,2\nnone,3\nred,oops\n")
    from duckdb_imputation_tpu.table.native import load_csv
    t = load_csv(str(p))
    assert t.col_labels(0) == ("red",)
    np.testing.assert_array_equal(t.col_null(0),
                                  [False, True, True, False])
    assert t.is_string(1)                          # 'oops' flips column b
    assert t.col_labels(1) == ("1", "2", "3", "oops")


def test_streaming_reader_rejects_strings(tmp_path):
    p = tmp_path / "s.csv"
    p.write_text("a,c\n1.0,red\n2.0,blue\n")
    from duckdb_imputation_tpu.table.native import CsvStream
    import pytest
    s = CsvStream(str(p))
    with pytest.raises(RuntimeError, match="string categorical"):
        s.next_chunk()


def test_cli_impute_string_csv(tmp_path):
    """CLI end-to-end over a CSV with a string categorical: imputed output
    writes the labels back, not codes."""
    import subprocess
    import sys

    rng = np.random.default_rng(5)
    n = 300
    z = rng.normal(size=n)
    color = np.where(z > 0, "warm", "cool").astype(object)
    miss = rng.choice(n, n // 5, replace=False)
    lines = ["x,color"]
    for i in range(n):
        c = "" if i in set(miss.tolist()) else color[i]
        lines.append(f"{z[i] + 0.05 * rng.normal():.6g},{c}")
    src = tmp_path / "in.csv"
    src.write_text("\n".join(lines) + "\n")
    out = tmp_path / "out.csv"
    # --platform cpu: keep the subprocess on the CPU whatever the host has
    r = subprocess.run(
        [sys.executable, "-m", "duckdb_imputation_tpu.cli", "--platform",
         "cpu", "impute", str(src), "--out", str(out), "--iters", "2",
         "--no-noise", "--linreg-iters", "200"],
        capture_output=True, text=True, timeout=500)
    assert r.returncode == 0, r.stderr[-2000:]
    rows = out.read_text().strip().split("\n")[1:]
    got = np.array([ln.split(",")[1] for ln in rows], object)
    assert set(got) <= {"warm", "cool"}
    truth = np.where(z > 0, "warm", "cool")
    assert (got[miss] == truth[miss]).mean() > 0.85
