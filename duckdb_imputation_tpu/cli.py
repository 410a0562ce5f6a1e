"""Command-line interface: CSV in → imputed CSV out, plus the benchmark
configs (the driver role of the reference's main.cpp / examples).

    python -m duckdb_imputation_tpu.cli impute data.csv --out imputed.csv \
        --mode low --iters 5
    python -m duckdb_imputation_tpu.cli bench --config sum_to_triple_4_0
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def cmd_impute(args):
    from .table.native import read_csv
    from .mice import run_mice_baseline, run_mice_high, run_mice_low
    from .utils.profiling import PhaseTimer

    if args.mode == "stream":
        from .mice.streaming import impute_csv_stream
        timer = PhaseTimer(verbose=args.verbose)
        res = impute_csv_stream(
            args.csv, args.out, iters=args.iters, noise=not args.no_noise,
            linreg_iters=args.linreg_iters, timer=timer,
            block_bytes=args.block_mb << 20,
            dirty_budget_rows=args.dirty_budget_rows,
            engine=args.engine)
        print(timer.report(), file=sys.stderr)
        print(f"wrote {args.out} ({res.ss.n_rows} rows, "
              f"{len(res.idx)} dirty)", file=sys.stderr)
        return

    t = read_csv(args.csv)
    timer = PhaseTimer(verbose=args.verbose)
    if args.mode in ("device", "delta"):
        # the single-dispatch on-device loop (whole MICE run = one XLA
        # program); 'delta' runs the compact-union O(dirty) rounds (the
        # reference's run_MICE_low strategy on device)
        from .mice.device_round import run_mice_device, run_mice_device_delta

        with timer.phase("mice_device"):
            if args.mode == "delta":
                out = run_mice_device_delta(
                    t, iters=args.iters, noise=not args.no_noise)
            else:
                out = run_mice_device(
                    t, iters=args.iters, noise=not args.no_noise)
    else:
        runner = {"baseline": run_mice_baseline, "low": run_mice_low,
                  "high": run_mice_high}[args.mode]
        out = runner(t, iters=args.iters, noise=not args.no_noise,
                     timer=timer, linreg_iters=args.linreg_iters)
    print(timer.report(), file=sys.stderr)

    num = np.asarray(out.num_data)
    cat = out.cat_values()
    labels = out.cat_labels or (None,) * cat.shape[0]
    names = list(out.num_names) + list(out.cat_names)
    with open(args.out, "w") as f:
        f.write(",".join(names) + "\n")
        for i in range(out.n_rows):
            row = [f"{num[j, i]:.7g}" for j in range(num.shape[0])]
            # string-categorical columns decode back to their labels
            row += [labels[j][int(cat[j, i])] if labels[j] is not None
                    else str(int(cat[j, i])) for j in range(cat.shape[0])]
            f.write(",".join(row) + "\n")
    print(f"wrote {args.out} ({out.n_rows} rows)", file=sys.stderr)


def cmd_train(args):
    """Train one model from a CSV and persist the flat parameter vector
    (the serving path the reference lacks — its models live only as FLOAT[]
    values inside one SQL connection, imputation_base.cpp:46-49).

    Training uses complete rows only: the aggregate rides a weight mask
    that zeroes any row with a null in ANY column — the
    `WHERE <col>_IS_NULL IS FALSE` predicate fused into the kernel."""
    from .table.native import read_csv
    from .ring.sum import (sum_to_nb_agg_grouped, sum_to_triple,
                           sum_to_triple_grouped)
    from .models import lda_train, linreg_train, nb_train, qda_train
    from .models.io import ModelBundle, save_model

    t = read_csv(args.csv)
    obs = ~(np.asarray(t.num_null).any(0) | np.asarray(t.cat_null).any(0))
    w = obs.astype(np.float32)
    label = args.label
    # per-file string dictionaries, persisted in the bundle so predict can
    # re-encode a DIFFERENT csv's labels through the training vocabulary
    file_labels = t.cat_labels or (None,) * len(t.cat_names)

    if args.model == "linreg":
        if label not in t.num_names:
            raise SystemExit(f"label {label!r} is not a numeric column "
                             f"(have {t.num_names})")
        j = t.num_names.index(label)
        triple = sum_to_triple(t.num_data, t.cat_codes, w, schema=t.schema)
        params = linreg_train(
            triple, t.schema, label=j, step_size=args.step_size,
            lam=args.lam, max_iters=args.max_iters,
            compute_variance=args.variance, normalize=args.normalize)
        bundle = ModelBundle("linreg", params, t.schema, t.num_names,
                             t.cat_names, label, "num", (),
                             args.normalize, args.variance,
                             cat_labels=file_labels)
    else:
        if label not in t.cat_names:
            raise SystemExit(f"label {label!r} is not a categorical column "
                             f"(have {t.cat_names})")
        j = t.cat_names.index(label)
        label_keys = t.schema.cat_keys[j]
        if args.model == "lda":
            triple = sum_to_triple(t.num_data, t.cat_codes, w,
                                   schema=t.schema)
            params = lda_train(triple, t.schema, label=j,
                               shrinkage=args.shrinkage,
                               normalize=args.normalize)
            bundle = ModelBundle("lda", params, t.schema, t.num_names,
                                 t.cat_names, label, "cat", label_keys,
                                 args.normalize, False,
                                 cat_labels=file_labels,
                                 label_labels=file_labels[j] or ())
        else:
            # QDA/NB: label column excluded from features; one triple per
            # class via the grouped kernel (GROUP BY label)
            fs = t.schema.without_cat(j)
            rows = [r for r in range(t.schema.cat_cols) if r != j]
            codes = (np.asarray(t.cat_codes)[rows] if rows
                     else np.zeros((0, t.n_rows), np.int32))
            g = np.where(obs, np.asarray(t.cat_codes)[j], -1).astype(np.int32)
            labels = list(label_keys)
            if args.model == "qda":
                triples = sum_to_triple_grouped(
                    t.num_data, codes, g, schema=fs, num_groups=len(labels))
                params = qda_train(triples, fs, labels=labels,
                                   normalize=args.normalize)
            else:
                aggs = sum_to_nb_agg_grouped(
                    t.num_data, codes, g, schema=fs, num_groups=len(labels))
                params = nb_train(aggs, fs, labels=labels)
            feat_cat_names = tuple(nm for k, nm in enumerate(t.cat_names)
                                   if k != j)
            bundle = ModelBundle(args.model, params, fs, t.num_names,
                                 feat_cat_names, label, "cat",
                                 label_keys, args.normalize, False,
                                 cat_labels=tuple(
                                     lb for k, lb in enumerate(file_labels)
                                     if k != j),
                                 label_labels=file_labels[j] or ())
    save_model(args.out, bundle)
    print(f"wrote {args.out} ({args.model}, label={label}, "
          f"{len(bundle.params)} params, {int(obs.sum())} training rows)",
          file=sys.stderr)


def cmd_predict(args):
    """Batch prediction from a saved bundle: featurize by column NAME,
    re-encode categoricals against the TRAINING vocab (unseen values hit
    the find_in_array miss convention: contribute 0 / probability 0).
    Rows with missing feature cells get placeholder-filled features —
    impute first for meaningful predictions on those rows."""
    from .table.native import read_csv
    from .models import (lda_predict, linreg_predict, nb_predict,
                         qda_predict)
    from .models.io import load_model
    import jax

    b = load_model(args.params)
    t = read_csv(args.csv)
    raw_cat = t.cat_values()
    test_labels = t.cat_labels or (None,) * len(t.cat_names)
    blabels = b.cat_labels or (None,) * len(b.cat_names)

    def num_block(names):
        missing = [nm for nm in names if nm not in t.num_names]
        if missing:
            raise SystemExit(f"CSV lacks numeric columns {missing}")
        return np.asarray(t.num_data)[[t.num_names.index(nm)
                                       for nm in names]]

    def cat_block(names, schema, train_labels):
        """Raw categorical columns re-encoded against the TRAINING vocab.

        String columns carry per-FILE sorted-label codes, so the test
        file's codes are remapped through the bundle's persisted training
        dictionary first (unseen labels -> miss code, i.e. contribute 0 /
        probability 0, matching find_in_array, ML/utils.cpp:152-162)."""
        missing = [nm for nm in names if nm not in t.cat_names]
        if missing:
            raise SystemExit(f"CSV lacks categorical columns {missing}")
        cols = []
        for nm, train_lb in zip(names, train_labels):
            jt = t.cat_names.index(nm)
            raw = raw_cat[jt]
            test_lb = test_labels[jt]
            if (train_lb is None) != (test_lb is None):
                raise SystemExit(
                    f"column {nm!r}: trained as "
                    f"{'string' if train_lb is not None else 'integer'}-"
                    f"categorical but the CSV parses it as the other kind")
            if train_lb is not None:
                to_train = {s: i for i, s in enumerate(train_lb)}
                remap = np.asarray([to_train.get(s, -1) for s in test_lb],
                                   np.int64)
                raw = remap[raw]
            cols.append(raw)
        return schema.encode(np.stack(cols, axis=1)).T.astype(np.int32)

    if b.model == "linreg":
        feat_names = [nm for nm in b.num_names if nm != b.label_name]
        x = num_block(feat_names)
        codes = (cat_block(b.cat_names, b.schema, blabels)
                 if b.cat_names else None)
        key = jax.random.PRNGKey(args.seed)
        pred = np.asarray(linreg_predict(
            b.params, x, codes, add_noise=args.noise,
            normalize=b.normalize, key=key))
    elif b.model == "lda":
        j = b.cat_names.index(b.label_name)
        x = num_block(b.num_names)
        other = [nm for k, nm in enumerate(b.cat_names) if k != j]
        codes = (cat_block(other, b.schema.without_cat(j),
                           [lb for k, lb in enumerate(blabels) if k != j])
                 if other else None)
        idx = np.asarray(lda_predict(b.params, x, codes,
                                     normalize=b.normalize))
        # the reference returns the 0-based class INDEX (lda.cpp:575);
        # the CLI maps it to the actual label value
        pred = np.asarray(b.label_keys, np.int64)[idx]
    elif b.model == "qda":
        x = num_block(b.num_names)
        # qda_train hardwires drop_first (qda.cpp:47): codes must address
        # the DROP-FIRST vocab, where the dropped first category maps to
        # the miss code and becomes the all-zero one-hot block
        codes = (cat_block(b.cat_names, b.schema.drop_first(), blabels)
                 if b.cat_names else None)
        pred = np.asarray(qda_predict(b.params, x, codes,
                                      normalize=b.normalize))
    else:
        x = num_block(b.num_names)
        codes = (cat_block(b.cat_names, b.schema, blabels)
                 if b.cat_names else None)
        pred = np.asarray(nb_predict(b.params, x, codes))

    col = f"{b.label_name}_pred"
    with open(args.out, "w") as f:
        f.write(col + "\n")
        if b.label_kind == "cat" or b.model in ("qda", "nb"):
            if b.label_labels:
                # string label column: predictions are training codes;
                # decode back to the label strings
                f.write("\n".join(b.label_labels[int(v)] for v in pred)
                        + "\n")
            else:
                f.write("\n".join(str(int(v)) for v in pred) + "\n")
        else:
            f.write("\n".join(f"{v:.7g}" for v in pred) + "\n")
    print(f"wrote {args.out} ({len(pred)} predictions)", file=sys.stderr)


def cmd_bench(args):
    """The BASELINE.json aggregation configs (BASELINE.md), through the
    public entry points: milliseconds per call (median of 10 calls after
    one warm-up call) and rows/s, with the device they ran on."""
    import time

    import jax

    from . import FeatureSchema
    from .ring.sum import sum_to_nb_agg_grouped, sum_to_triple

    rng = np.random.default_rng(0)
    configs = {
        # name: (rows, schema, with weights, groups)
        "sum_to_triple_4_0": (4 << 20, FeatureSchema(num_cols=4), False, 0),
        "sum_to_triple_4_2": (
            8 << 20, FeatureSchema(num_cols=4, cat_keys=(tuple(range(8)),) * 2),
            True, 0),
        "nb_grouped": (
            8 << 20, FeatureSchema(num_cols=8,
                                   cat_keys=(tuple(range(16)),) * 4),
            False, 8),
    }
    dev = jax.devices()[0]
    results = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                          "count": len(jax.devices())}}
    for name, (n, schema, weighted, groups) in configs.items():
        if args.config not in (name, "all"):
            continue
        x = jax.device_put(
            rng.normal(size=(schema.num_cols, n)).astype(np.float32))
        c = jax.device_put(rng.integers(
            0, max(schema.cat_sizes, default=1),
            size=(schema.cat_cols, n)).astype(np.int32))
        w = (jax.device_put((rng.random(n) > 0.2).astype(np.float32))
             if weighted else None)
        if groups:
            g = jax.device_put(rng.integers(0, groups, n).astype(np.int32))

            def call():
                return sum_to_nb_agg_grouped(x, c, g, schema=schema,
                                             num_groups=groups)
        else:
            def call():
                return sum_to_triple(x, c, w, schema=schema)
        jax.block_until_ready(call())
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            jax.block_until_ready(call())
            times.append(time.perf_counter() - t0)
        ms = float(np.median(times)) * 1e3
        results[name] = {"rows": n, "ms": ms, "rows_per_s": n / ms * 1e3}
    print(json.dumps(results, indent=2))


def main(argv=None):
    from .config import enable_compilation_cache
    enable_compilation_cache()
    ap = argparse.ArgumentParser(prog="duckdb_imputation_tpu")
    ap.add_argument("--platform", default=None,
                    help="force a jax platform (e.g. cpu, gpu) instead of "
                         "JAX's default choice")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("impute", help="MICE-impute a CSV")
    p.add_argument("csv")
    p.add_argument("--out", default="imputed.csv")
    p.add_argument("--mode",
                   choices=["baseline", "low", "high", "stream", "device",
                            "delta"],
                   default="low",
                   help="stream = out-of-core: chunked two-pass streaming "
                        "aggregation + delta rounds over the dirty cache; "
                        "the file is never resident. device = the whole "
                        "loop as ONE dispatch (single-device production "
                        "path); delta = single-dispatch compact-union "
                        "O(dirty) rounds (for low missing rates)")
    p.add_argument("--engine", choices=["host", "device"], default="host",
                   help="stream mode rounds: host = f64 GD parity path; "
                        "device = compact-union device delta loop (every "
                        "round one dispatch — the fast path)")
    p.add_argument("--block-mb", type=int, default=64,
                   help="streamed block size (stream mode)")
    p.add_argument("--dirty-budget-rows", type=int, default=None,
                   help="stream mode: spill the dirty-row cache to disk "
                        "beyond this many rows (bounded host memory at "
                        "high missing rates; rounds run windowed)")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--linreg-iters", type=int, default=10000)
    p.add_argument("--no-noise", action="store_true",
                   help="deterministic regression imputation")
    p.add_argument("--verbose", action="store_true")
    p.set_defaults(fn=cmd_impute)

    p = sub.add_parser("train", help="train a model from a CSV, save the "
                                     "flat parameter bundle (.npz)")
    p.add_argument("csv")
    p.add_argument("--model", required=True,
                   choices=["linreg", "lda", "qda", "nb"])
    p.add_argument("--label", required=True,
                   help="label column name (numeric for linreg, "
                        "categorical otherwise)")
    p.add_argument("--out", default="model.npz")
    p.add_argument("--normalize", action="store_true")
    p.add_argument("--shrinkage", type=float, default=0.001,
                   help="LDA covariance shrinkage")
    p.add_argument("--step-size", type=float, default=0.001)
    p.add_argument("--lam", type=float, default=0.0,
                   help="ridge lambda (linreg)")
    p.add_argument("--max-iters", type=int, default=10000)
    p.add_argument("--variance", action="store_true",
                   help="store the residual std for stochastic prediction")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("predict", help="batch-predict a CSV from a saved "
                                       "model bundle")
    p.add_argument("csv")
    p.add_argument("--params", required=True, help="bundle from `train`")
    p.add_argument("--out", default="predictions.csv")
    p.add_argument("--noise", action="store_true",
                   help="stochastic linreg prediction (needs --variance "
                        "at train time)")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_predict)

    p = sub.add_parser("bench", help="time the aggregation configs")
    p.add_argument("--config", default="all",
                   choices=["all", "sum_to_triple_4_0", "sum_to_triple_4_2",
                            "nb_grouped"])
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)
    args.fn(args)


if __name__ == "__main__":
    main()
