"""The traced stretches: torch.profiler over a few pairs, reduced to
intervals.

A run with ``--trace 1`` profiles the device alone over ``trace_pairs``
pairs (busy and idle time, kernel times: recording no host operator, the
host's enqueue keeps its untraced speed), then device and host over a
few more (to name what the host did in each idle gap; the operators'
recording slows the host there, so those gaps run long). Each profiler's
chrome trace is read back, and kept as

* ``device``: (name, start, end) of every kernel, copy and fill on the
  card, in seconds on the trace's clock;
* ``spans``: (name, start, end) of the harness's own host spans
  (``record_function`` around dispatch, fetch and the waits);
* ``host_ops``: (name, start, end) of the host's operators, to name what
  the host was doing in a gap.

Busy time is the union of the device intervals, not their sum.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "portbench."


@dataclass
class Trace:
    device: list = field(default_factory=list)
    spans: list = field(default_factory=list)
    host_ops: list = field(default_factory=list)
    window: tuple = (0.0, 0.0)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def read_chrome_trace(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    trace = Trace()
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        start = float(e["ts"]) * 1e-6
        item = (e.get("name", ""), start, start + float(e["dur"]) * 1e-6)
        cat = e.get("cat", "")
        if cat in DEVICE_CATEGORIES:
            trace.device.append(item)
        elif cat == "user_annotation" and item[0].startswith(SPAN_PREFIX):
            trace.spans.append(item)
        elif cat == "cpu_op":
            trace.host_ops.append(item)
    timed = trace.spans or trace.device
    if timed:
        trace.window = (min(s[1] for s in timed), max(s[2] for s in timed))
    for items in (trace.device, trace.spans, trace.host_ops):
        items.sort(key=lambda item: item[1])
    return trace


def union(intervals, lo: float, hi: float) -> list:
    """Merged (start, end) intervals clipped to [lo, hi]."""
    merged = []
    for _, start, end in sorted(intervals, key=lambda item: item[1]):
        start, end = max(start, lo), min(end, hi)
        if end <= start:
            continue
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def busy_seconds(trace: Trace) -> float:
    lo, hi = trace.window
    return sum(end - start for start, end in union(trace.device, lo, hi))


def idle_gaps(trace: Trace) -> list:
    """(start, end) of each stretch of the window with no device work."""
    lo, hi = trace.window
    gaps, at = [], lo
    for start, end in union(trace.device, lo, hi):
        if start > at:
            gaps.append((at, start))
        at = max(at, end)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def _innermost(items, t: float) -> str | None:
    """The name of the latest-starting item that covers t."""
    best = None
    for name, start, end in items:
        if start > t:
            break
        if end >= t:
            best = name
    return best


def host_at(trace: Trace, t: float) -> str:
    """What the host was doing at t: the harness span, and the innermost
    operator inside it."""
    span = _innermost(trace.spans, t)
    op = _innermost(trace.host_ops, t)
    span = span[len(SPAN_PREFIX):] if span else "between spans"
    return f"{span} > {op}" if op else span


def breakdown(trace: Trace, host_trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time in ``trace``'s window,
    and the longest idle gaps of ``host_trace`` (which recorded the host's
    spans and operators) named by what the host was doing in their
    middle."""
    lo, hi = trace.window
    totals: dict = {}
    for name, start, end in trace.device:
        start, end = max(start, lo), min(end, hi)
        if end > start:
            totals[name] = totals.get(name, 0.0) + (end - start)
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(host_trace), key=lambda g: g[0] - g[1])[:top]
    return {
        "device_ops": [[name[:160], seconds] for name, seconds in ops],
        "idle_gaps": [[host_at(host_trace, (a + b) / 2), b - a]
                      for a, b in gaps],
    }


def kernel_times(trace: Trace, matches) -> list:
    """Durations in seconds of the device kernels whose name ``matches``."""
    return [end - start for name, start, end in trace.device
            if matches(name)]


class Profiler:
    """torch.profiler over a stretch, of the device (``cuda``) and of the
    host's operators and spans (``host``); ``stop()`` exports and reads the
    chrome trace (written to ``path``, then deleted). A trace without host
    records spans its device intervals."""

    def __init__(self, path: str, cuda: bool, host: bool):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] if host else []
        if cuda:
            activities.append(ProfilerActivity.CUDA)
        self.path = path
        self._profile = profile(activities=activities)

    def start(self) -> None:
        self._profile.start()

    def stop(self) -> Trace:
        self._profile.stop()
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._profile.export_chrome_trace(self.path)
        try:
            return read_chrome_trace(self.path)
        finally:
            os.unlink(self.path)
