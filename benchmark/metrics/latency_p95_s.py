"""latency_p95_s: the 95th percentile (nearest rank) over every request
due in the window of due time to map on the host. A request that failed
or was never answered counts as 1e9 s, over any limit."""

from portbench.readers import nearest_rank

UNANSWERED_S = 1e9


def read(run):
    if not run.requests:
        return None
    latencies = [r.t_done - r.due if r.error is None and r.output is not None
                 else UNANSWERED_S for r in run.requests]
    return nearest_rank(latencies, 0.95)
