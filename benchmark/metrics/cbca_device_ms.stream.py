"""cbca_device_ms.stream: ms a pair that match_pair's cbca spans take on the
device's stream, between each span's CUDA events (idle inside them
included): the arms, both CBCA stages and the chunk copies, once a side;
over the pairs of the device-only traced stretch."""

from portbench.program_spans import per_pair_ms


def read(run):
    return per_pair_ms(run, "cbca", device=True)
