"""Phase timing — the structured replacement for the reference's
cout/clog chrono pairs around every MICE phase (imputation_base.cpp:8-12,
32-38,102-118,136-142). Accumulates per-phase wall-clock; integrates with
jax.profiler traces when requested."""
from __future__ import annotations

import collections
import contextlib
import time


class PhaseTimer:
    def __init__(self, verbose: bool = False):
        self.totals: dict[str, float] = collections.defaultdict(float)
        self.counts: dict[str, int] = collections.defaultdict(int)
        self.verbose = verbose

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            if self.verbose:
                print(f"[{name}] {dt * 1e3:.1f} ms")

    def summary(self) -> dict[str, float]:
        return dict(self.totals)

    def report(self) -> str:
        lines = [f"{k}: {v * 1e3:.1f} ms ({self.counts[k]}x)"
                 for k, v in sorted(self.totals.items())]
        return "\n".join(lines)

    def to_json(self) -> str:
        import json
        return json.dumps({k: {"total_s": v, "count": self.counts[k]}
                           for k, v in self.totals.items()})


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler trace (perfetto/tensorboard-compatible) of
    everything inside the context — the structured replacement for the
    reference's chrono-printf instrumentation."""
    import jax

    with jax.profiler.trace(log_dir):
        yield


def device_op_times(log_dir: str) -> dict:
    """Reduce a device_trace directory to device time: the window (first
    op start to last op end on the device planes), busy time (union of op
    intervals), and total duration per op name, all in seconds. Reads the
    newest `.xplane.pb` under `log_dir` with jax.profiler.ProfileData."""
    import glob
    import os

    from jax.profiler import ProfileData

    files = sorted(glob.glob(os.path.join(log_dir, "plugins", "profile",
                                          "*", "*.xplane.pb")),
                   key=os.path.getmtime)
    if not files:
        raise FileNotFoundError(f"no .xplane.pb under {log_dir}")
    spans, per_op = [], collections.defaultdict(float)
    for plane in ProfileData.from_file(files[-1]).planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            # stream lines carry the kernels; the 'XLA Modules'/'XLA Ops'
            # lines repeat them at a coarser grain
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                per_op[ev.name] += ev.duration_ns * 1e-9
    if not spans:
        raise ValueError(f"no device ops in the trace under {log_dir}")
    spans.sort()
    busy, cur_lo, cur_hi = 0.0, *spans[0]
    for lo, hi in spans[1:]:
        if lo > cur_hi:
            busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    busy += cur_hi - cur_lo
    return {"window_s": (max(hi for _, hi in spans) - spans[0][0]) * 1e-9,
            "busy_s": busy * 1e-9, "per_op_s": dict(per_op)}
