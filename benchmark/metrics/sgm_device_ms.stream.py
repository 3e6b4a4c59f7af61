"""sgm_device_ms.stream: ms a pair that match_pair's sgm spans take on the
device's stream, between each span's CUDA events (idle inside them
included): K3's sweeps and their penalty planes, once a side; over the pairs
of the device-only traced stretch."""

from portbench.program_spans import per_pair_ms


def read(run):
    return per_pair_ms(run, "sgm", device=True)
