"""features_host_ms.stream: host ms a pair in match_pair's features spans,
their self time: the enqueue of the feature net on both images and the
descriptors' cast; over the pairs of the device-only traced stretch."""

from portbench.program_spans import per_pair_ms


def read(run):
    return per_pair_ms(run, "features")
