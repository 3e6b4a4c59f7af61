"""post_host_ms.stream: host ms a pair in match_pair's post spans, their self
time: the enqueue of the two WTAs, the LR check, subpixel and both filters;
over the pairs of the device-only traced stretch."""

from portbench.program_spans import per_pair_ms


def read(run):
    return per_pair_ms(run, "post")
