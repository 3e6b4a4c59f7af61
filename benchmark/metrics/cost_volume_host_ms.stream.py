"""cost_volume_host_ms.stream: host ms a pair in match_pair's cost_volume
spans, their self time: the enqueue of K1 and the border fills, once a side;
over the pairs of the device-only traced stretch."""

from portbench.program_spans import per_pair_ms


def read(run):
    return per_pair_ms(run, "cost_volume")
