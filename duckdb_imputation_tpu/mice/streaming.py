"""Out-of-core MICE: the delta regime at datasets that don't fit in HBM.

The reference's low-missing insight (`run_MICE_low`,
/root/reference/imputation/algorithms/imputation_low.cpp:9-306) is that
after ONE full aggregate, every retrain touches only dirty rows:
train = full − delta. Taken to its limit, the clean rows never need to be
resident at all — so this driver:

  pass 0 (host):   vocab union + nullable detection + dirty-row cache
  pass 1 (device): ONE streaming scan folds the extended Gram; its blocks
                   assemble the mean/mode-FILLED full triple exactly
                   (ring/streaming.py — the init fill is recovered from the
                   Gram, no second pass)
  rounds:          the standard delta rounds (mice/low.py run_delta_rounds)
                   over the dirty cache only — O(dirty) per column per round
  write-out:       `impute_chunks` re-streams the source, substituting the
                   imputed values at the cached positions chunk by chunk.

Peak memory: O(chunk + dirty rows + (P+K)²), independent of n.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..ring.streaming import (Chunk, DirtyCache, DirtySpill, StreamFills,
                              StreamSchema, aggregate_stream,
                              _normalize_chunk)
from ..table.table import Table
from ..utils.profiling import PhaseTimer
from .low import run_delta_rounds
from .partition import build_partitions


def _dirty_table(cache: DirtyCache, ss: StreamSchema,
                 fills: StreamFills) -> Table:
    """Materialize the dirty-row cache as a Table, init-filled with the
    stream-recovered means/modes (≙ init_baseline over just these rows)."""
    schema = ss.schema
    num = np.asarray(cache.num, np.float64).copy()
    for j in range(schema.num_cols):
        num[j, cache.num_null[j]] = fills.num_means[j]
    if schema.cat_cols:
        codes = schema.encode(cache.cat.T).T.astype(np.int32)
        for j in range(schema.cat_cols):
            codes[j, cache.cat_null[j]] = fills.cat_modes[j]
    else:
        codes = np.zeros((0, cache.idx.shape[0]), np.int32)
    return Table(
        num_data=jnp.asarray(num, jnp.float32),
        cat_codes=jnp.asarray(codes, jnp.int32),
        num_null=jnp.asarray(cache.num_null),
        cat_null=jnp.asarray(cache.cat_null),
        schema=schema)


@dataclasses.dataclass
class StreamImputation:
    """Result of out-of-core MICE: everything needed to rewrite the source.

    dirty: the imputed dirty rows (Table over ss.schema), or None when the
           dirty set exceeded the budget and lives in `spill` instead.
    idx:   their global row indices (ascending).
    """
    dirty: Table | None
    idx: np.ndarray
    fills: StreamFills
    ss: StreamSchema
    spill: DirtySpill | None = None

    def _dirty_slice(self, lo: int, hi: int):
        """(num f32[d, m], cat RAW i64[c, m]) of dirty rows [lo, hi)."""
        if self.spill is not None:
            num, cat, _, _ = self.spill.window(lo, hi)
            return num, cat
        schema = self.ss.schema
        return (np.asarray(self.dirty.num_data)[:, lo:hi],
                self.dirty.cat_values()[:, lo:hi] if schema.cat_cols
                else None)

    def impute_chunks(self, chunk_source):
        """Re-stream the source, yielding (num f32[d, m], cat i64[c, m])
        chunks with every null cell replaced by its imputed value (numeric)
        / imputed RAW category value. Chunks must arrive in the same order
        as the aggregation passes saw them. Dirty values are sliced lazily
        (bounded memory with a spill-backed cache)."""
        schema = self.ss.schema
        pos = 0          # cursor into self.idx
        row0 = 0
        for raw in chunk_source():
            num, cat, num_null, cat_null = _normalize_chunk(raw)
            m = num.shape[-1] if num.shape[0] else cat.shape[-1]
            out_num = num.copy()
            out_cat = cat.copy()
            hi = pos
            while hi < len(self.idx) and self.idx[hi] < row0 + m:
                hi += 1
            if hi > pos:
                local = self.idx[pos:hi] - row0
                num_d, cat_d = self._dirty_slice(pos, hi)
                for j in range(schema.num_cols):
                    nm = num_null[j, local]
                    out_num[j, local[nm]] = num_d[j][nm]
                for j in range(schema.cat_cols):
                    cm = cat_null[j, local]
                    out_cat[j, local[cm]] = cat_d[j][cm]
            pos = hi
            row0 += m
            yield out_num, out_cat


def _spill_init_fill(spill: DirtySpill, ss: StreamSchema,
                     fills: StreamFills, window: int) -> None:
    """Write the AVG/MODE init fills (partition.cpp:42-57) into the spilled
    null cells, one bounded window at a time."""
    schema = ss.schema
    for lo in range(0, spill.n, window):
        hi = min(lo + window, spill.n)
        for j in range(schema.num_cols):
            mask = spill.num_null[lo:hi, j]
            if mask.any():
                spill.write_num(j, lo, np.full(hi - lo, fills.num_means[j],
                                               np.float32), mask)
        for j in range(schema.cat_cols):
            mask = spill.cat_null[lo:hi, j]
            if mask.any() and schema.cat_sizes[j]:
                raw_mode = int(schema.decode(
                    j, np.asarray([fills.cat_modes[j]]))[0])
                spill.write_cat(j, lo, np.full(hi - lo, raw_mode, np.int64),
                                mask)


def run_delta_rounds_spill(spill: DirtySpill, full, ss: StreamSchema, *,
                           iters: int = 5, window: int,
                           lda_shrinkage: float = 0.001,
                           linreg_step: float = 0.001,
                           linreg_lambda: float = 0.0,
                           linreg_iters: int = 10000, noise: bool = True,
                           seed: int = 0,
                           timer: PhaseTimer | None = None):
    """The delta rounds of run_MICE_low (imputation_low.cpp:85-194) against
    a DISK-backed dirty store: every delta triple is the SUM of per-window
    triples (the ring sum makes windowing exact), training consumes
    `full − Σ_w delta_w`, and predictions write back through the memmap one
    window at a time. Peak host memory is O(window + (P+K)²) regardless of
    the missing rate. With `noise`, draws are keyed per (round, column) but
    windowed shapes make them differ from the in-core path's draws —
    bit-parity with DirtyCache rounds holds for noise=False only."""
    import jax

    from ..models import lda_predict, lda_train, linreg_predict, linreg_train
    from ..ring.sum import sum_to_triple
    from ..ring.triple import Triple, triple_add, triple_sub

    timer = timer or PhaseTimer()
    schema = ss.schema
    key = jax.random.PRNGKey(seed)

    def windows():
        for lo in range(0, spill.n, window):
            yield lo, min(lo + window, spill.n)

    def encode(cat):
        return (schema.encode(cat.T).T.astype(np.int32) if schema.cat_cols
                else None)

    def delta_col(kind: str, col: int) -> Triple:
        total = None
        for lo, hi in windows():
            num, cat, nn, cn = spill.window(lo, hi)
            mask = nn[col] if kind == "num" else cn[col]
            if not mask.any():
                continue
            tr = sum_to_triple(num, encode(cat),
                               mask.astype(np.float32), schema=schema)
            total = tr if total is None else triple_add(total, tr)
        return total if total is not None else Triple.zeros(schema)

    for _ in range(iters):
        for col in ss.nullable_cat:
            with timer.phase("cofactor_delta"):
                train = triple_sub(full, delta_col("cat", col))
            with timer.phase("train"):
                params = lda_train(train, schema, label=col,
                                   shrinkage=lda_shrinkage)
            with timer.phase("impute"):
                other = [j for j in range(schema.cat_cols) if j != col]
                for lo, hi in windows():
                    num, cat, nn, cn = spill.window(lo, hi)
                    mask = cn[col]
                    if not mask.any():
                        continue
                    codes = encode(cat)
                    pred_idx = np.asarray(lda_predict(
                        params, num, codes[other] if other else None))
                    raw = schema.decode(col, pred_idx)
                    spill.write_cat(col, lo, raw, mask)
            with timer.phase("cofactor_readd"):
                full = triple_add(train, delta_col("cat", col))

        for col in ss.nullable_num:
            with timer.phase("cofactor_delta"):
                train = triple_sub(full, delta_col("num", col))
            with timer.phase("train"):
                params = linreg_train(train, schema, label=col,
                                      step_size=linreg_step,
                                      lam=linreg_lambda,
                                      max_iters=linreg_iters,
                                      compute_variance=noise)
            with timer.phase("impute"):
                keep = [j for j in range(schema.num_cols) if j != col]
                key, sub = jax.random.split(key)
                for w_i, (lo, hi) in enumerate(windows()):
                    num, cat, nn, cn = spill.window(lo, hi)
                    mask = nn[col]
                    if not mask.any():
                        continue
                    pred = np.asarray(linreg_predict(
                        params, num[keep], encode(cat), add_noise=noise,
                        key=jax.random.fold_in(sub, w_i)))
                    spill.write_num(col, lo, pred, mask)
            with timer.phase("cofactor_readd"):
                full = triple_add(train, delta_col("num", col))
    return full


def _run_delta_rounds_device(t: Table, full, ss: StreamSchema, *, iters,
                             lda_shrinkage, noise, seed, timer,
                             ckpt=None, idx=None, fills=None,
                             start_iter: int = 0):
    """The streaming delta rounds as ONE device dispatch (or one per
    checkpoint chunk): the dirty cache IS a compact union sub-table, so
    `mice_loop_device_delta` runs directly on it with the STREAMED full
    sigma injected (`full_sigma=` — the clean rows' mass enters only
    through it; imputation_low.cpp's algebra verbatim). Replaces the
    host-driven rounds' per-phase dispatches with one device program.
    f32 solve trainer; noise is the device counter stream (differs from
    the host engine's per-(round, column) fold — same distribution)."""
    import dataclasses

    import jax

    from ..backend import resolve_kernel
    from ..ring.triple import sigma_from_triple, triple_from_sigma
    from .device_round import build_union_gather, mice_loop_device_delta

    schema = ss.schema
    kernel = resolve_kernel("auto", schema.sigma_size)
    union_idx, union_valid = build_union_gather(
        [np.arange(t.n_rows, dtype=np.int64)])
    sigma_full0 = jnp.asarray(sigma_from_triple(full), jnp.float32)
    num_cols = tuple(ss.nullable_num)
    cat_cols = tuple(ss.nullable_cat)
    key = jax.random.PRNGKey(seed)

    def run_rounds(tc, sigma_full, r0, k_rounds):
        with timer.phase("delta_rounds_device"):
            x, c, _ = mice_loop_device_delta(
                tc.num_data, tc.cat_codes, tc.num_null, tc.cat_null, key,
                union_idx, union_valid, sigma_full, schema=schema,
                num_cols_to_impute=num_cols, cat_cols_to_impute=cat_cols,
                iters=k_rounds, lda_shrinkage=lda_shrinkage, noise=noise,
                kernel=kernel, trainer="solve", round_offset=r0)
        return dataclasses.replace(tc, num_data=x, cat_codes=c)

    if ckpt is None:
        return run_rounds(t, sigma_full0, start_iter, iters - start_iter)

    # checkpointed: per-chunk, the current full sigma is reconstructed
    # from the ring identity  full = full_init − σ(cache_init) + σ(cache);
    # the post-round cache sigma is computed ONCE and carried into the
    # next chunk as its pre-round sigma
    from ..ring.sum import aggregate_sigma
    w_rows = jnp.asarray(
        np.asarray(union_valid)[:t.n_rows].astype(np.float32))
    sig0_cache = aggregate_sigma(t.num_data, t.cat_codes, w_rows,
                                 schema=schema, kernel=kernel)
    cur = t
    sig_cur = sig0_cache
    for it in range(start_iter, iters):
        cur = run_rounds(cur, sigma_full0 - sig0_cache + sig_cur, it, 1)
        sig_cur = aggregate_sigma(cur.num_data, cur.cat_codes, w_rows,
                                  schema=schema, kernel=kernel)
        full_cur = triple_from_sigma(
            jnp.asarray(sigma_full0 - sig0_cache + sig_cur, jnp.float32),
            schema.num_cols)
        ckpt.save(cur, full_cur, idx, fills, ss, it + 1)
    return cur


def run_mice_stream(chunk_source, iters: int = 5, *,
                    chunk_rows: int | None = None,
                    lda_shrinkage: float = 0.001,
                    linreg_step: float = 0.001, linreg_lambda: float = 0.0,
                    linreg_iters: int = 10000, noise: bool = True,
                    seed: int = 0, timer: PhaseTimer | None = None,
                    mesh=None, dirty_budget_rows: int | None = None,
                    checkpoint_path: str | None = None,
                    engine: str = "host") -> StreamImputation:
    """MICE over a chunk stream (callable → iterator of ring.streaming.Chunk
    or (num, cat[, num_null, cat_null]) tuples). See module docstring.
    With `mesh`, the streaming Gram pass row-shards each chunk over the
    device mesh (psum combine); the delta rounds run on the dirty cache,
    which is small by the low-missing premise. At HIGH missing rates pass
    `dirty_budget_rows`: beyond that many dirty rows the cache spills to
    disk and the rounds run windowed (run_delta_rounds_spill) with peak
    host memory O(chunk + budget + (P+K)²) instead of O(dirty).

    checkpoint_path: persist (full triple, dirty cache, fills, round) after
    every delta round — O(dirty), never O(n) — and RESUME from it: a killed
    run skips both streaming read passes and continues the identical
    trajectory (noise keys fold global rounds). In-core cache only; the
    spill path's state already lives on disk.

    engine: 'host' (default) — the f64 host-driven rounds with the
    reference's GD trainer, the parity path; 'device' — the compact-union
    device delta loop on the dirty cache with the streamed full sigma
    injected: every round is on-device (one program instead of the host
    path's per-phase dispatches), f32 solve trainer, device noise
    stream."""
    timer = timer or PhaseTimer()
    ckpt = None
    if checkpoint_path is not None:
        from ..utils.checkpoint import StreamCheckpointer
        ckpt = StreamCheckpointer(checkpoint_path)
        resumed = ckpt.resume()
        if resumed is not None:
            t, full, idx, fills, ss, start_iter = resumed
            if engine == "device":
                t = _run_delta_rounds_device(
                    t, full, ss, iters=iters, lda_shrinkage=lda_shrinkage,
                    noise=noise, seed=seed, timer=timer, ckpt=ckpt,
                    idx=idx, fills=fills, start_iter=start_iter)
                return StreamImputation(dirty=t, idx=idx, fills=fills,
                                        ss=ss)
            with timer.phase("prepare"):
                parts = build_partitions(t)
            for it in range(start_iter, iters):
                t, full = run_delta_rounds(
                    t, full, parts, iters=it + 1, start_iter=it,
                    lda_shrinkage=lda_shrinkage, linreg_step=linreg_step,
                    linreg_lambda=linreg_lambda, linreg_iters=linreg_iters,
                    noise=noise, seed=seed, timer=timer)
                ckpt.save(t, full, idx, fills, ss, it + 1)
            return StreamImputation(dirty=t, idx=idx, fills=fills, ss=ss)
    kw = dict(chunk_rows=chunk_rows) if chunk_rows else {}
    with timer.phase("stream_aggregate"):
        full, fills, ss, cache = aggregate_stream(
            chunk_source, mesh=mesh, dirty_budget_rows=dirty_budget_rows,
            **kw)
    if isinstance(cache, DirtySpill):
        if engine == "device":
            import warnings
            warnings.warn(
                "the dirty cache spilled to disk; the device engine runs "
                "in-core only — falling back to the host windowed spill "
                "rounds (f64 GD trainer)", stacklevel=2)
        window = int(dirty_budget_rows)
        with timer.phase("prepare"):
            _spill_init_fill(cache, ss, fills, window)
        run_delta_rounds_spill(
            cache, full, ss, iters=iters, window=window,
            lda_shrinkage=lda_shrinkage, linreg_step=linreg_step,
            linreg_lambda=linreg_lambda, linreg_iters=linreg_iters,
            noise=noise, seed=seed, timer=timer)
        return StreamImputation(dirty=None, idx=np.asarray(cache.idx),
                                fills=fills, ss=ss, spill=cache)
    with timer.phase("prepare"):
        t = _dirty_table(cache, ss, fills)
    if engine == "device":
        t = _run_delta_rounds_device(
            t, full, ss, iters=iters, lda_shrinkage=lda_shrinkage,
            noise=noise, seed=seed, timer=timer, ckpt=ckpt,
            idx=cache.idx, fills=fills)
        return StreamImputation(dirty=t, idx=cache.idx, fills=fills, ss=ss)
    with timer.phase("prepare"):
        parts = build_partitions(t)
    if ckpt is None:
        t, _ = run_delta_rounds(
            t, full, parts, iters=iters, lda_shrinkage=lda_shrinkage,
            linreg_step=linreg_step, linreg_lambda=linreg_lambda,
            linreg_iters=linreg_iters, noise=noise, seed=seed, timer=timer)
    else:
        for it in range(iters):
            t, full = run_delta_rounds(
                t, full, parts, iters=it + 1, start_iter=it,
                lda_shrinkage=lda_shrinkage, linreg_step=linreg_step,
                linreg_lambda=linreg_lambda, linreg_iters=linreg_iters,
                noise=noise, seed=seed, timer=timer)
            ckpt.save(t, full, cache.idx, fills, ss, it + 1)
    return StreamImputation(dirty=t, idx=cache.idx, fills=fills, ss=ss)


def impute_csv_stream(in_path: str, out_path: str, iters: int = 5, *,
                      has_header: bool = True, block_bytes: int = 64 << 20,
                      noise: bool = True, seed: int = 0,
                      timer: PhaseTimer | None = None,
                      **mice_kw) -> StreamImputation:
    """Out-of-core CSV → CSV imputation: two streaming read passes through
    the native chunked parser (vocab/dirty scan, then the device Gram
    fold), delta MICE rounds over the dirty cache, and one streaming write
    pass. Peak host memory is O(block + dirty rows); the file is never
    resident. Int-typed columns keep %d formatting on the way out
    (values are exact up to 2^53)."""
    from ..table.native import CsvStream, csv_chunk_source

    timer = timer or PhaseTimer()
    source = csv_chunk_source(in_path, has_header, block_bytes)
    res = run_mice_stream(source, iters=iters, noise=noise, seed=seed,
                          timer=timer, **mice_kw)

    # column order/types of the file: probe with the SAME block size the
    # aggregation passes used — a stream fixes each column's type from its
    # first chunk, so a differently-sized probe could type a column int
    # where the data passes saw its first float later in a bigger block
    probe = CsvStream(in_path, has_header, block_bytes)
    names = probe.col_names
    nt = probe.next_chunk()
    kinds = [nt.is_numeric(c) for c in range(nt.n_cols)]
    del nt, probe

    from ..table.native import format_csv_block

    with timer.phase("write_out"), open(out_path, "wb") as f:
        f.write((",".join(names) + "\n").encode())
        is_int = [not k for k in kinds]
        for num, cat in res.impute_chunks(source):
            cols, ni, ci = [], 0, 0
            for k in kinds:
                if k:
                    cols.append(num[ni])
                    ni += 1
                else:
                    cols.append(cat[ci])
                    ci += 1
            # native multithreaded formatter — the savetxt python loop was
            # ~50x slower and dominated the whole out-of-core pipeline
            f.write(format_csv_block(cols, is_int))
    return res
