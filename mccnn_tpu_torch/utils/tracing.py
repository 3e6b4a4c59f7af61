"""Spans of the program's set-up, pairs and stages, kept in memory.

A span is one stretch of the program on the host's clock
(``time.perf_counter``): its name, start and end, the span it nests in and
the pair it belongs to. ``MatchPipeline.dispatch`` gives each pair an id,
carried in its handle to ``fetch``, and every span of that pair holds it:

    setup.import       the package's ``__init__``, once a process
    setup.library      ``kernels/build.py::build``: hashing the sources, the
                       build if the library is absent
    setup.load         ``kernels/build.py::library``: loading it
    setup.pipeline     ``MatchPipeline.__init__``: the weights to the device
    setup.first_pair   a pipeline's first pair of a bucket shape: its
                       dispatch and its fetch, one span each
    dispatch           > copy_in (pad, pinned staging, the copy's enqueue),
                       features, cost_volume, cbca, sgm, post (match_pair)
    copy_out           ``fetch``: the blocking copy of the map, the crop

Set-up spans are recorded always: there are a handful a process. The
others are recorded only while tracing is on, that is while a torch
profiler records or after ``enable()``. Then each span also enters
``torch.profiler.record_function("mccnn.<name>")``, so it shows in the
profiler's trace, and where the process uses a CUDA device records a
``torch.cuda.Event`` on the current stream at both ends. Events are read
only once the device has passed them (``Event.query``), at the end of each
``fetch`` and in ``records()``, so tracing adds no synchronization. With
tracing off a span costs one check: no clock read, no allocation.

``records()`` returns every span ended so far, in the order they ended;
``reset()`` forgets them. The module imports nothing but the standard
library; torch is looked up only once the program has loaded it.
"""

from __future__ import annotations

import itertools
import sys
import time
from contextlib import nullcontext

PREFIX = "mccnn."
SETUP = "setup."
_OFF = nullcontext()


class Span:
    """One ended span. ``device_ms`` is the time between its CUDA events on
    the device's stream (idle inside it included), None without events or
    before the device has passed them. A plain class: a dataclass would
    cost a millisecond at import."""

    __slots__ = ("name", "start", "end", "id", "parent", "pair", "device_ms")

    def __init__(self, name: str, start: float, end: float, id: int,
                 parent: int | None = None, pair: int | None = None,
                 device_ms: float | None = None):
        self.name, self.start, self.end, self.id = name, start, end, id
        self.parent, self.pair, self.device_ms = parent, pair, device_ms

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.start}, {self.end}, id={self.id},"
                f" parent={self.parent}, pair={self.pair},"
                f" device_ms={self.device_ms})")


class _Open:
    """A span being recorded (the context manager ``span`` returns)."""

    def __init__(self, tracer: "Tracer", name: str, pair, traced: bool):
        self.tracer, self.name, self.pair, self.traced = (
            tracer, name, pair, traced)

    def __enter__(self):
        tracer = self.tracer
        outer = tracer.open[-1] if tracer.open else None
        self.id = next(tracer.ids)
        self.parent = outer.id if outer is not None else None
        if self.pair is None and outer is not None:
            self.pair = outer.pair
        self.profiled = self.events = None
        if self.traced:
            import torch  # loaded: tracing is on only once torch records

            self.profiled = torch.profiler.record_function(PREFIX + self.name)
            self.profiled.__enter__()
            if torch.cuda.is_initialized():
                self.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
                self.events[0].record()
        tracer.open.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        tracer = self.tracer
        tracer.open.pop()
        record = Span(self.name, self.start, end, self.id, self.parent,
                      self.pair)
        if self.events is not None:
            self.events[1].record()
            tracer.pending.append((record, self.events))
        if self.profiled is not None:
            self.profiled.__exit__(*exc)
        tracer.ended.append(record)
        return False


class Tracer:
    """The process's spans; the module's functions are one instance's
    methods."""

    def __init__(self):
        self.enabled = False
        self.ended: list = []
        self.open: list = []
        self.pending: list = []
        self.ids = itertools.count()
        self.pairs = itertools.count()

    def enable(self) -> None:
        """Record spans whether or not a profiler is recording."""
        self.enabled = True

    def disable(self) -> None:
        """Record spans only while a profiler records (the default)."""
        self.enabled = False

    def on(self) -> bool:
        """Whether spans are being recorded now."""
        if self.enabled:
            return True
        torch = sys.modules.get("torch")
        return torch is not None and torch._C._autograd._profiler_enabled()

    def span(self, name: str, pair: int | None = None):
        """A context manager recording span ``name`` while tracing is on
        (one check and nothing else while it is off). ``pair`` defaults to
        the pair of the span it nests in."""
        if not self.on():
            return _OFF
        return _Open(self, name, pair, True)

    def setup_span(self, name: str):
        """A context manager recording set-up span ``setup.<name>``
        always, traced as any span while tracing is on."""
        return _Open(self, SETUP + name, None, self.on())

    def new_pair(self) -> int | None:
        """A new pair id while tracing is on, else None."""
        return next(self.pairs) if self.on() else None

    def add(self, name: str, start: float, end: float,
            pair: int | None = None) -> None:
        """Record, always, a span timed elsewhere (one that opens in one
        call and ends in another)."""
        outer = self.open[-1] if self.open else None
        self.ended.append(Span(name, start, end, next(self.ids),
                               outer.id if outer is not None else None, pair))

    def resolve(self) -> None:
        """Read the device times of the spans whose events the device has
        passed; never waits."""
        if not self.pending:
            return
        waiting = []
        for record, (first, last) in self.pending:
            if last.query():
                record.device_ms = first.elapsed_time(last)
            else:
                waiting.append((record, (first, last)))
        self.pending = waiting

    def records(self) -> list:
        """Every span ended so far (``Span``), in the order they ended."""
        self.resolve()
        return list(self.ended)

    def reset(self) -> None:
        """Forget every ended span."""
        self.ended.clear()
        self.pending.clear()


TRACER = Tracer()
enable, disable, on = TRACER.enable, TRACER.disable, TRACER.on
span, setup_span, new_pair = TRACER.span, TRACER.setup_span, TRACER.new_pair
add, resolve = TRACER.add, TRACER.resolve
records, reset = TRACER.records, TRACER.reset
