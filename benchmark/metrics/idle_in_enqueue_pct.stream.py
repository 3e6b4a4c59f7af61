"""idle_in_enqueue_pct.stream: of the device's idle time in the host-traced
stretch, the share, in %, during which the host was inside one of
match_pair's stage spans (enqueuing); the program's spans are put on the
trace's clock through the harness's dispatch spans."""

from portbench.program_spans import idle_in_enqueue_pct


def read(run):
    return idle_in_enqueue_pct(run)
