"""The program's own spans (``mccnn_tpu_torch/utils/tracing.py``), as the
per-layer metrics of set-up, ``MatchPipeline`` and ``match_pair`` read them.

The program keeps its spans in memory: its set-up spans always, and the
spans of every pair dispatched while a profiler records, so a run with
``--trace 1`` holds those of both traced stretches. The stage metrics read
the pairs of the device-only stretch. The profiler there traces no host
operator, but the program's spans are on (a profiler records): each pair
enters fifteen ``record_function`` spans and records two CUDA events for
each. Measured with ``tracing.enable()`` against off over the same pairs
on an NVIDIA H100 80GB HBM3, that moved a half-size pair of 170 ms by less
than its noise (+2.0 and -1.2 ms) and a full-size pair of 924 ms by +8 ms,
so the stretch's host may run slower than an untraced one, and than an
older program's in the same stretch. Every function returns None where
the program has no tracer (an older program) or the run holds nothing to
read.

The program's host times are on ``time.perf_counter``, the clock the
harness times its requests on. A span's device time is its stretch between
its CUDA events on the stream. To place the program's spans on the
profiler trace's clock, ``align`` uses the harness's ``portbench.dispatch``
spans: both clocks hold them, and each encloses one ``dispatch`` span of
the program.
"""

from __future__ import annotations

import math
import statistics

from portbench.trace import idle_gaps, union

SETUP = "setup."
# match_pair's stage spans
STAGES = ("features", "cost_volume", "cbca", "sgm", "post")


def records() -> list | None:
    """The program's ended spans, or None where it has no tracer."""
    try:
        from mccnn_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.records()


def self_seconds(span, spans) -> float:
    """The span's time less the part of it its child spans cover."""
    inner = [(None, s.start, s.end) for s in spans if s.parent == span.id]
    return span.seconds - sum(
        end - start for start, end in union(inner, span.start, span.end))


def stretch_pairs(run, spans) -> dict | None:
    """{pair id: its spans} of the pairs the program dispatched in the
    device-only traced stretch (``run.stretch``)."""
    done = [r for r in run.stretch if not math.isnan(r.t_done)]
    if not done:
        return None
    lo = min(r.t_dispatch for r in done)
    hi = max(r.t_done for r in done)
    pairs = {s.pair: [] for s in spans
             if s.name == "dispatch" and s.pair is not None
             and lo <= s.start and s.end <= hi}
    for s in spans:
        if s.pair in pairs and not s.name.startswith(SETUP):
            pairs[s.pair].append(s)
    return pairs or None


def per_pair_ms(run, name: str, device: bool = False) -> float | None:
    """Mean over the device-only stretch's pairs of the ms a pair spends in
    the spans named ``name`` (summed: a stage runs once a side): their host
    self time, or with ``device`` their stretch on the device's stream."""
    spans = records()
    pairs = stretch_pairs(run, spans) if spans is not None else None
    if pairs is None:
        return None
    totals = []
    for group in pairs.values():
        chosen = [s for s in group if s.name == name]
        if not chosen:
            return None
        if device:
            if any(s.device_ms is None for s in chosen):
                return None
            totals.append(sum(s.device_ms for s in chosen))
        else:
            totals.append(1e3 * sum(self_seconds(s, group) for s in chosen))
    return statistics.fmean(totals)


def setup_program_s(run) -> float | None:
    """Seconds covered by the program's set-up spans that ended before the
    window: the package's import, the kernel library's build and load, the
    pipeline's construction, each bucket shape's first pair. Where one set-up
    span falls inside another (the library loaded in a first pair), its time
    counts once."""
    spans = records()
    if spans is None or math.isnan(run.setup_s):
        return None
    chosen = [(s.name, s.start, s.end) for s in spans
              if s.name.startswith(SETUP) and s.end <= run.window[0]]
    if not chosen:
        return None
    return sum(end - start for start, end in union(chosen, -math.inf,
                                                   math.inf))


def align(harness: list, program: list) -> tuple[float, float] | None:
    """(offset, error) that maps the program's clock onto the trace's:
    trace time = program time + offset. ``harness`` and ``program`` are
    (start, end) pairs of the same dispatches, each harness span enclosing
    its program span, so every pair bounds the offset from both sides; the
    offset is the middle of the bounds' intersection and the error half its
    width (negative where the bounds do not meet)."""
    if not program or len(harness) != len(program):
        return None
    lo = max(h0 - p0 for (h0, _), (p0, _) in zip(harness, program))
    hi = min(h1 - p1 for (_, h1), (_, p1) in zip(harness, program))
    return (lo + hi) / 2, (hi - lo) / 2


def host_stretch_alignment(run, spans):
    """(offset, error, pair ids) of the host-traced stretch, or None."""
    host = run.host_trace
    if host is None or run.trace is host or not run.stretch:
        return None
    after = max(r.t_done for r in run.stretch)
    dispatches = sorted((s for s in spans if s.name == "dispatch"
                         and s.pair is not None and s.start > after),
                        key=lambda s: s.start)
    harness = [(start, end) for name, start, end in host.spans
               if name == "portbench.dispatch"]
    found = align(harness, [(s.start, s.end) for s in dispatches])
    if found is None:
        return None
    return (*found, {s.pair for s in dispatches})


def device_ops_per_pair(run) -> float | None:
    """Kernels, copies and fills on the device in the device-only traced
    stretch, over the pairs the program dispatched there."""
    spans = records()
    trace = run.trace
    if spans is None or trace is None or not trace.device:
        return None
    pairs = stretch_pairs(run, spans)
    if pairs is None:
        return None
    lo, hi = trace.window
    ops = sum(1 for _, start, end in trace.device if lo <= start and end <= hi)
    return ops / len(pairs)


def idle_in_enqueue_pct(run) -> float | None:
    """Of the host-traced stretch's device idle time, the share, in %, in
    which the host was inside one of ``match_pair``'s stage spans."""
    spans = records()
    host = run.host_trace
    if spans is None or host is None or not host.device:
        return None
    found = host_stretch_alignment(run, spans)
    if found is None:
        return None
    offset, _, pairs = found
    lo, hi = host.window
    inside = union([(None, s.start + offset, s.end + offset) for s in spans
                    if s.pair in pairs and s.name in STAGES], lo, hi)
    gaps = idle_gaps(host)
    idle = sum(b - a for a, b in gaps)
    if idle <= 0:
        return None
    shared = sum(max(0.0, min(b, end) - max(a, start))
                 for a, b in gaps for start, end in inside)
    return 100.0 * shared / idle
