"""What several metric readers share: the window's answered requests and
host-clock statistics over them."""

from __future__ import annotations

import math
import statistics


def answered(run) -> list:
    return [r for r in run.requests if r.error is None
            and r.output is not None]


def dispatch_ms(run) -> float | None:
    """Mean host time a pair spends in ``dispatch`` (pad, pinned copies,
    enqueue; a wait on a full launch queue included), in ms."""
    times = [r.t_dispatched - r.t_dispatch for r in run.requests
             if not math.isnan(r.t_dispatched)]
    return 1e3 * statistics.fmean(times) if times else None


def nearest_rank(values: list, q: float) -> float:
    """The q-quantile of ``values`` by the nearest-rank rule."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]
