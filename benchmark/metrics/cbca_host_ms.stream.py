"""cbca_host_ms.stream: host ms a pair in match_pair's cbca spans, their self
time: the enqueue of the arms, both CBCA stages and the chunk copies, once a
side; over the pairs of the device-only traced stretch."""

from portbench.program_spans import per_pair_ms


def read(run):
    return per_pair_ms(run, "cbca")
