"""post_device_ms.stream: ms a pair that match_pair's post spans take on the
device's stream, between each span's CUDA events (idle inside them
included): the two WTAs, the LR check, subpixel and both filters; over the
pairs of the device-only traced stretch."""

from portbench.program_spans import per_pair_ms


def read(run):
    return per_pair_ms(run, "post", device=True)
