"""sgm_host_ms.stream: host ms a pair in match_pair's sgm spans, their self
time: the enqueue of K3's sweeps and their penalty planes, once a side; over
the pairs of the device-only traced stretch."""

from portbench.program_spans import per_pair_ms


def read(run):
    return per_pair_ms(run, "sgm")
