"""device_idle_pct.stream: the share, in %, of the device's traced stretch
(its first device interval's start to its last one's end) that no kernel,
copy or fill covers; the union of intervals, not a sum."""

from portbench.trace import busy_seconds


def read(run):
    trace = run.trace
    if trace is None or not trace.device or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy_seconds(trace) / trace.window_s)
