"""peak_mem_gb: torch.cuda.max_memory_allocated() over the window (reset
after the warm pairs), in GB of 1e9 bytes."""


def read(run):
    if not run.memory_peak_bytes:
        return None
    return run.memory_peak_bytes / 1e9
