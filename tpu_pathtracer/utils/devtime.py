"""Device busy time and idle share from a jax.profiler trace.

`device_time(fn)` runs `fn` under `jax.profiler.trace`, inside a host
annotation that marks the window, and waits for its outputs.  The trace's
`.xplane.pb` is read with `jax.profiler.ProfileData` and reduced by
`reduce_events`:

  * device planes are the ones named ``/device:GPU:<n>``;
  * on them, only the lines named ``Stream ...`` hold the operations that
    ran (kernels, copies); the derived lines (``XLA Modules``,
    ``XLA Ops``, ...) span whole programs and are skipped;
  * busy time is the union of those operations' intervals, clipped to the
    window; idle share is 1 - busy / window, per device.

This is the counterpart of the reference's GPU timestamp queries
(reference: src/timing.ts:28-146).  On the CPU backend a trace has no
device plane, and the result says so with ``ok=False``.
"""

from __future__ import annotations

import glob
import os
import shutil
import tempfile
from typing import Callable, Iterable, NamedTuple

WINDOW = "devtime_window"


class Event(NamedTuple):
    plane: str
    line: str
    name: str
    start_ns: float
    dur_ns: float


def load_events(trace_dir: str) -> list:
    """Every event of the `.xplane.pb` files under `trace_dir`."""
    import jax

    events = []
    for path in glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                          recursive=True):
        data = jax.profiler.ProfileData.from_file(path)
        for plane in data.planes:
            for line in plane.lines:
                for e in line.events:
                    events.append(Event(plane.name, line.name, e.name,
                                        float(e.start_ns),
                                        float(e.duration_ns)))
    return events


def _is_device_op(e: Event) -> bool:
    return e.plane.startswith("/device:GPU") and e.line.startswith("Stream")


def _union_ns(intervals: Iterable[tuple], lo: float, hi: float) -> float:
    total = 0.0
    end = lo
    for s, t in sorted(intervals):
        s, t = max(s, end), min(t, hi)
        if t > s:
            total += t - s
            end = t
    return total


def reduce_events(events: list, window: tuple | None = None) -> dict:
    """Busy time, idle share and per-op totals of the device ops in
    `events` (see module docstring).

    `window`: (start_ns, end_ns); default: the span of the `WINDOW` host
    annotation, else the span of the device ops themselves.  Returns
    {"ok", "window_s", "busy_s" (mean over devices), "idle_share" (mean),
    "devices": {plane: busy_s}, "ops": {name: summed seconds}}."""
    ops = [e for e in events if _is_device_op(e)]
    if window is None:
        marks = [e for e in events if e.name == WINDOW]
        if marks:
            window = (marks[0].start_ns, marks[0].start_ns + marks[0].dur_ns)
        elif ops:
            window = (min(e.start_ns for e in ops),
                      max(e.start_ns + e.dur_ns for e in ops))
        else:
            window = (0.0, 0.0)
    lo, hi = window
    span = hi - lo
    planes = sorted({e.plane for e in ops})
    busy = {
        p: _union_ns(((e.start_ns, e.start_ns + e.dur_ns)
                      for e in ops if e.plane == p), lo, hi) / 1e9
        for p in planes
    }
    per_op: dict = {}
    for e in ops:
        per_op[e.name] = per_op.get(e.name, 0.0) + e.dur_ns / 1e9
    mean_busy = sum(busy.values()) / len(busy) if busy else 0.0
    return {
        "ok": bool(planes) and span > 0,
        "window_s": span / 1e9,
        "busy_s": mean_busy,
        "idle_share": 1.0 - mean_busy / (span / 1e9) if span > 0 else None,
        "devices": busy,
        "ops": per_op,
    }


def device_time(fn: Callable[[], object]) -> dict:
    """Run `fn` under the profiler, wait for its outputs, and reduce the
    trace (`reduce_events`).  The result also carries `out`, the value
    `fn` returned."""
    import jax

    trace_dir = tempfile.mkdtemp(prefix="devtime_")
    try:
        with jax.profiler.trace(trace_dir):
            with jax.profiler.TraceAnnotation(WINDOW):
                out = jax.block_until_ready(fn())
        res = reduce_events(load_events(trace_dir))
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    res["out"] = out
    return res
