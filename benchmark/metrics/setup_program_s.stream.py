"""setup_program_s.stream: seconds of set-up inside the program's own set-up
spans (mccnn_tpu_torch/utils/tracing.py, recorded with tracing off too),
counted once where they overlap: the package's import, the kernel library
(hash, build if absent, load), the pipeline's construction (weights to the
device) and each bucket shape's first pair (its dispatch and its fetch, not
the caller's time between them: cuDNN's choice, lazy loads, the allocator's
growth, the device's first run)."""

from portbench.program_spans import setup_program_s


def read(run):
    return setup_program_s(run)
