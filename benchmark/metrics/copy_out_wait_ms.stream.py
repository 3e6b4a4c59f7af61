"""copy_out_wait_ms.stream: host ms a pair in MatchPipeline's copy_out span
(the blocking copy of the map: the host waiting on the device, then the
crop), over the pairs of the device-only traced stretch."""

from portbench.program_spans import per_pair_ms


def read(run):
    return per_pair_ms(run, "copy_out")
