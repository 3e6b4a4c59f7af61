"""Multi-process scene sharding, the descendant of ``--start/--end``
(mccnn_tpu/parallel/multihost.py).

The reference parallelizes matching by running disjoint image-index ranges
in separate processes (reference: src/match.py:26-28,83-91). Here the same
contract maps to per-process scene subsets: start the process group, and
each process takes every ``process_count``-th scene. Outputs are per-scene
files, so the scheme is idempotent and restartable at one-image
granularity, exactly like the reference's.

``initialize_distributed`` starts a ``torch.distributed`` process group:
over ``tcp://`` when it is given the coordinator's address, the process
count and this process's index, else from torchrun's ``env://`` variables
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``), as
``jax.distributed.initialize()`` detects its cluster. The rest is pure
Python, a copy of the JAX package's assignment.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence, Tuple

DEFAULT_TIMEOUT_S = 600.0


def default_backend(device) -> str:
    """NCCL for CUDA devices, gloo for the CPU."""
    import torch

    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_nccl_ranks(backend: str, local_ranks: int) -> None:
    """Raise where NCCL would put more than one rank on a card: NCCL
    refuses that, gloo does not (and says so here, not as a hang)."""
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend == "nccl" and local_ranks > cards:
        raise ValueError(
            f"NCCL cannot run {local_ranks} ranks on {cards} card(s): it "
            "takes one rank per card; pass backend=\"gloo\" to share a card")


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device: str = "cuda",
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Start the default process group.

    ``coordinator_address`` is ``host:port`` (or a ``tcp://`` URL) of rank
    0; with it, ``num_processes`` and ``process_id`` are required. Without
    it the group reads torchrun's environment. ``backend`` defaults to NCCL
    on ``cuda`` and gloo on ``cpu``; no other backend is chosen silently.
    Every collective waits at most ``timeout_s`` seconds. On CUDA the
    process's current card becomes ``LOCAL_RANK`` modulo the card count.
    """
    import torch
    import torch.distributed as dist

    backend = backend or default_backend(device)
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and "
                             "process_id")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        world, rank = int(num_processes), int(process_id)
    else:
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    # ranks on this host: torchrun says; otherwise all of them
    check_nccl_ranks(backend, int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    if torch.device(device).type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))


def process_slice(
    num_scenes: int,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> List[int]:
    """Scene indices owned by this process (strided assignment).

    The defaults are the started group's rank and size; without a group,
    ``RANK`` and ``WORLD_SIZE`` from the environment; without those, one
    process (0 of 1), which is what JAX reports for a single process.
    """
    if process_index is None or process_count is None:
        process_index, process_count = _process_index_and_count()
    return list(range(process_index, num_scenes, process_count))


def _process_index_and_count() -> Tuple[int, int]:
    try:
        import torch.distributed as dist
    except ImportError:  # pragma: no cover
        dist = None
    if dist is not None and dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return 0, 1


def shard_scenes(
    scenes: Sequence[str],
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> List[Tuple[int, str]]:
    """(index, scene) pairs owned by this process."""
    indices = process_slice(len(scenes), process_index, process_count)
    return [(i, scenes[i]) for i in indices]
