"""copy_in_ms.stream: host ms a pair in MatchPipeline's copy_in span (pad,
pinned staging, the enqueue of the copies to the device), over the pairs
of the device-only traced stretch."""

from portbench.program_spans import per_pair_ms


def read(run):
    return per_pair_ms(run, "copy_in")
