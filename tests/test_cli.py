"""CLI smoke: CSV in -> imputed CSV out (the reference main.cpp role)."""
import subprocess
import sys


def test_cli_impute_roundtrip(tmp_path):
    import numpy as np
    rng = np.random.default_rng(0)
    n = 400
    z = rng.normal(size=n)
    a = z.astype(np.float32)
    b = (2 * z + 0.01 * rng.normal(size=n)).astype(np.float32)
    c = (z > 0).astype(int)
    null = np.zeros(n, bool)
    null[rng.choice(n, n // 5, replace=False)] = True
    src = tmp_path / "in.csv"
    with open(src, "w") as f:
        f.write("a,b,c\n")
        for i in range(n):
            bv = "" if null[i] else f"{b[i]:.6g}"
            f.write(f"{a[i]:.6g},{bv},{c[i]}\n")
    out = tmp_path / "out.csv"
    # subprocess so the CLI's own platform/jit setup is exercised; forced
    # to the CPU like the rest of the suite — keep rows small
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax; jax.config.update('jax_platforms','cpu');"
         "import sys; from duckdb_imputation_tpu.cli import main;"
         f"sys.argv=['cli','impute',{str(src)!r},'--out',{str(out)!r},"
         "'--mode','baseline','--iters','2','--no-noise'];main()"],
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = open(out).read().strip().splitlines()
    assert lines[0].split(",")[:2] == ["a", "b"]
    assert len(lines) == n + 1
    got_b = np.asarray([float(l.split(",")[1]) for l in lines[1:]])
    rmse = float(np.sqrt(np.mean((got_b[null] - b[null]) ** 2)))
    assert rmse < 0.2, rmse


def test_cli_impute_device_mode(tmp_path):
    """--mode device: the whole MICE loop as one dispatch (kernel='auto'
    resolves to the XLA path on this CPU backend; the Gram kernel is
    covered by test_gram_kernel.py in interpret mode)."""
    import numpy as np
    rng = np.random.default_rng(1)
    n = 300
    z = rng.normal(size=n)
    a = z.astype(np.float32)
    b = (2 * z + 0.01 * rng.normal(size=n)).astype(np.float32)
    c = (z > 0).astype(int)
    null = np.zeros(n, bool)
    null[rng.choice(n, n // 5, replace=False)] = True
    src = tmp_path / "in.csv"
    with open(src, "w") as f:
        f.write("a,b,c\n")
        for i in range(n):
            bv = "" if null[i] else f"{b[i]:.6g}"
            f.write(f"{a[i]:.6g},{bv},{c[i]}\n")
    out = tmp_path / "out.csv"
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax; jax.config.update('jax_platforms','cpu');"
         "import sys; from duckdb_imputation_tpu.cli import main;"
         f"sys.argv=['cli','impute',{str(src)!r},'--out',{str(out)!r},"
         "'--mode','device','--iters','2','--no-noise'];main()"],
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = open(out).read().strip().splitlines()
    assert len(lines) == n + 1
    got_b = np.asarray([float(l.split(",")[1]) for l in lines[1:]])
    rmse = float(np.sqrt(np.mean((got_b[null] - b[null]) ** 2)))
    assert rmse < 0.2, rmse


def _train_predict(tmp_path, model, label, train_csv, test_csv, extra=(),
                   parse=float):
    bundle = tmp_path / f"{model}.npz"
    preds = tmp_path / f"{model}_pred.csv"
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "import sys; from duckdb_imputation_tpu.cli import main;"
        f"sys.argv=['cli','train',{str(train_csv)!r},'--model',{model!r},"
        f"'--label',{label!r},'--out',{str(bundle)!r}"
        + "".join(f",{a!r}" for a in extra) + "];main();"
        f"sys.argv=['cli','predict',{str(test_csv)!r},"
        f"'--params',{str(bundle)!r},'--out',{str(preds)!r}];main()")
    r = subprocess.run([sys.executable, "-c", code],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    import numpy as np
    lines = open(preds).read().strip().splitlines()
    assert lines[0] == f"{label}_pred"
    return np.asarray([parse(v) for v in lines[1:]])


def test_cli_train_predict_all_models(tmp_path):
    """Serving path: train on one CSV, predict another, all 4 model
    families through the persisted bundle (the reference keeps params only
    as a FLOAT[] value inside one connection)."""
    import numpy as np
    rng = np.random.default_rng(3)
    n = 600

    def write(path, n0):
        z = rng.normal(size=n0)
        x1 = z + 0.05 * rng.normal(size=n0)
        x2 = -z + 0.05 * rng.normal(size=n0)
        y = (2 * z + 0.01 * rng.normal(size=n0)).astype(np.float32)
        g = np.where(z > 0, 7, 3)        # separable classes, raw values
        with open(path, "w") as f:
            f.write("x1,x2,y,g\n")
            for i in range(n0):
                f.write(f"{x1[i]:.6g},{x2[i]:.6g},{y[i]:.6g},{g[i]}\n")
        return y, g, z

    train = tmp_path / "train.csv"
    test = tmp_path / "test.csv"
    write(train, n)
    y_te, g_te, _ = write(test, 200)

    pred = _train_predict(tmp_path, "linreg", "y", train, test)
    assert float(np.sqrt(np.mean((pred - y_te) ** 2))) < 0.2

    for model in ("lda", "qda", "nb"):
        pred = _train_predict(tmp_path, model, "g", train, test)
        acc = (pred.astype(int) == g_te).mean()
        assert acc > 0.95, (model, acc)


def test_cli_qda_with_cat_feature(tmp_path):
    """QDA predict must encode non-label categorical features against the
    DROP-FIRST vocab (qda_train hardwires drop_first, qda.cpp:47). With
    full-vocab encoding every first-category cell shifts one category over
    and the dominant-signal cat feature below would score near chance."""
    import numpy as np
    rng = np.random.default_rng(11)

    def write(path, n0):
        idx = rng.integers(0, 3, size=n0)
        g = (idx + 1) * 10
        # cat feature: matches the class 90% of the time (noisy so the
        # per-class one-hot covariance stays non-degenerate), {1,2,3}
        h = np.where(rng.random(n0) < 0.9, idx + 1,
                     rng.integers(1, 4, size=n0))
        x = idx - 1 + rng.normal(size=n0)         # weakly informative
        with open(path, "w") as f:
            f.write("x,h,g\n")
            for i in range(n0):
                f.write(f"{x[i]:.6g},{h[i]},{g[i]}\n")
        return g

    train = tmp_path / "train.csv"
    test = tmp_path / "test.csv"
    write(train, 900)
    g_te = write(test, 300)
    pred = _train_predict(tmp_path, "qda", "g", train, test)
    acc = (pred.astype(int) == g_te).mean()
    # the cat feature alone gives ~0.9; with the encoding bug its signal is
    # rotated one category over and accuracy craters to ~chance
    assert acc > 0.85, acc


def test_cli_string_categoricals_across_files(tmp_path):
    """String-categorical columns: raw codes are per-FILE sorted-label
    indices, so predict must remap the test file's labels through the
    persisted TRAINING dictionary (the test file lacks one color, shifting
    its local codes), and string label predictions must decode back to the
    label strings."""
    import numpy as np
    rng = np.random.default_rng(12)
    colors = ["apple", "banana", "cherry"]
    cls_of = {"apple": "one", "banana": "three", "cherry": "two"}

    def write(path, n0, allowed):
        cs = [allowed[i] for i in rng.integers(0, len(allowed), size=n0)]
        x = rng.normal(size=n0)
        with open(path, "w") as f:
            f.write("x,color,cls\n")
            for i in range(n0):
                f.write(f"{x[i]:.6g},{cs[i]},{cls_of[cs[i]]}\n")
        return np.asarray([cls_of[c] for c in cs])

    train = tmp_path / "train.csv"
    test = tmp_path / "test.csv"
    write(train, 600, colors)
    want = write(test, 200, colors[1:])   # no 'apple' -> shifted local codes
    pred = _train_predict(tmp_path, "nb", "cls", train, test, parse=str)
    assert set(pred) <= {"one", "two", "three"}
    assert (pred == want).mean() > 0.99

    pred = _train_predict(tmp_path, "lda", "cls", train, test, parse=str)
    assert (pred == want).mean() > 0.99
