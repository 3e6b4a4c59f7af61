"""Run a program on N ranks in N fresh processes of this host.

``run_ranks(program, world_size, *args)`` spawns one process per rank,
starts the process group over ``tcp://127.0.0.1:<free port>``, builds the
mesh and returns ``[program(mesh, *args) for each rank]``. A rank that
raises fails the call with its traceback; a call that outlives
``timeout_s`` kills every child and raises ``TimeoutError``, so a hang in a
collective ends instead of waiting forever. ``program`` must be a
module-level function (the children import it by name) and its result
something picklable (numpy arrays, numbers, dicts of those). Each rank
runs one torch thread: the ranks share the host's cores.

The sharded matcher's tools, the CPU tests and ``cli/train.py
--data_parallel`` (one rank per card) launch their ranks with this.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import socket
import time
import traceback

from mccnn_tpu_torch.parallel.multihost import (
    DEFAULT_TIMEOUT_S,
    check_nccl_ranks,
    default_backend,
)


def free_port() -> int:
    """A TCP port on the loopback that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world_size, port, program, args, device, backend,
               timeout_s, results):
    try:
        import torch
        import torch.distributed as dist

        from mccnn_tpu_torch.parallel.mesh import make_mesh
        from mccnn_tpu_torch.parallel.multihost import initialize_distributed

        torch.set_num_threads(1)
        os.environ["LOCAL_WORLD_SIZE"] = str(world_size)
        os.environ["LOCAL_RANK"] = str(rank)
        initialize_distributed(f"127.0.0.1:{port}", world_size, rank,
                               device=device, backend=backend,
                               timeout_s=timeout_s)
        try:
            mesh = make_mesh(device=device, backend=backend)
            results.put((rank, True, program(mesh, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_ranks(program, world_size: int, *args, device: str = "cuda",
              backend: str | None = None,
              timeout_s: float | None = DEFAULT_TIMEOUT_S) -> list:
    """``program(mesh, *args)`` on ``world_size`` ranks; the results in
    rank order. ``backend`` defaults to NCCL on ``cuda`` and gloo on the
    CPU; NCCL with more ranks than cards raises before anything starts.
    ``timeout_s`` bounds each
    collective and the whole call; None bounds the collectives by the
    default and the call not at all (a training run)."""
    device = str(device)
    backend = backend or default_backend(device)
    check_nccl_ranks(backend, world_size)
    context = multiprocessing.get_context("spawn")
    results = context.Queue()
    port = free_port()
    children = [
        context.Process(
            target=_rank_main,
            args=(rank, world_size, port, program, args, device, backend,
                  timeout_s or DEFAULT_TIMEOUT_S, results),
            daemon=True)
        for rank in range(world_size)
    ]
    for child in children:
        child.start()
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    out = {}
    try:
        while len(out) < world_size:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                lost = [r for r, child in enumerate(children)
                        if r not in out and child.exitcode not in (None, 0)]
                if lost:
                    raise RuntimeError(
                        f"rank {lost[0]} of {world_size} died in "
                        f"{program.__name__} (exit code "
                        f"{children[lost[0]].exitcode})") from None
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{len(out)} of {world_size} ranks finished "
                        f"{program.__name__} within {timeout_s} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed in "
                                   f"{program.__name__}:\n{value}")
            out[rank] = value
        for child in children:
            child.join(timeout=60)
    finally:
        for child in children:
            if child.is_alive():
                child.kill()
                child.join(timeout=10)
        results.close()
    return [out[rank] for rank in range(world_size)]
