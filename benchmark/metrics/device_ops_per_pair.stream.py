"""device_ops_per_pair.stream: kernels, copies and fills on the device in
the device-only traced stretch, over the pairs the program dispatched
there."""

from portbench.program_spans import device_ops_per_pair


def read(run):
    return device_ops_per_pair(run)
