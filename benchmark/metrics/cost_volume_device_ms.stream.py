"""cost_volume_device_ms.stream: ms a pair that match_pair's cost_volume spans
take on the device's stream, between each span's CUDA events (idle inside
them included): K1 and the border fills, once a side; over the pairs of the
device-only traced stretch."""

from portbench.program_spans import per_pair_ms


def read(run):
    return per_pair_ms(run, "cost_volume", device=True)
