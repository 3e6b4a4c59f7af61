"""features_device_ms.stream: ms a pair that match_pair's features spans take
on the device's stream, between each span's CUDA events (idle inside them
included): the feature net on both images and the descriptors' cast; over
the pairs of the device-only traced stretch."""

from portbench.program_spans import per_pair_ms


def read(run):
    return per_pair_ms(run, "features", device=True)
