"""service_ms.open: the median over the window's answered requests of
dispatch start to map on the host, in ms: the service without the queue
wait."""

import statistics

from portbench.readers import answered


def read(run):
    times = [r.t_done - r.t_dispatch for r in answered(run)]
    return 1e3 * statistics.median(times) if times else None
