"""setup_outside_s.stream: setup_s less setup_program_s.stream: set-up
outside the program's set-up spans (the interpreter, torch and the CUDA
context, the harness's weights and scenes, the rest of the warm pairs)."""

from portbench.program_spans import setup_program_s


def read(run):
    inside = setup_program_s(run)
    return None if inside is None else run.setup_s - inside
