"""The device mesh over a ``torch.distributed`` process group, and the
collectives the sharded matcher and trainer use (mccnn_tpu/parallel/mesh.py).

In the JAX package a ``jax.sharding.Mesh`` names the devices and XLA
inserts the collectives: GSPMD infers the vertical-SGM reshard and the
gathers, and ``lax.ppermute`` moves the CBCA halos. PyTorch infers
nothing, so this module writes them out, one process (rank) per device:

  * ``exchange_halo``: a row shard gains its neighbours' edge rows, zeros
    at the global ends (the ``lax.ppermute`` convention of
    mccnn_tpu/parallel/cbca.py:32-39);
  * ``rows_to_columns`` / ``columns_to_rows``: an ``all_to_all`` that turns
    a row shard into a column shard and back; the width need not divide by
    the rank count;
  * ``gather_rows``: the full array from every rank's rows;
  * ``all_reduce``: sum or max over ranks, in place.

gloo moves CUDA tensors for broadcast, all_reduce and barrier only, so on
gloo a CUDA tensor travels through pinned host memory; NCCL takes the
device tensors. Data moves as bytes (any dtype, bf16 and int8 included).
Each helper adds the bytes this rank sends, and the seconds it waits, to
``mesh.traffic`` under its kind: "halo", "reshard", "gather", "reduce",
"broadcast".
"""

from __future__ import annotations

import collections
import os
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from mccnn_tpu_torch.parallel.multihost import (
    check_nccl_ranks,
    default_backend,
)


class Mesh:
    """A 1-D mesh: every rank of the default process group, one device
    each. ``shape`` maps the axis name to the rank count, as a JAX mesh's
    does; ``traffic`` holds ``{kind: bytes sent}`` and ``{kind + "_s":
    seconds}`` of the helpers below."""

    def __init__(self, rank: int, size: int, device: torch.device,
                 backend: str, axis_name: str = "data"):
        self.rank = rank
        self.size = size
        self.device = device
        self.backend = backend
        self.axis_name = axis_name
        self.traffic = collections.Counter()

    @property
    def shape(self) -> dict:
        return {self.axis_name: self.size}

    @property
    def staged(self) -> bool:
        """Whether CUDA tensors go through host memory (gloo)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def __repr__(self) -> str:
        return (f"Mesh(rank={self.rank}, size={self.size}, "
                f"device={self.device}, backend={self.backend!r})")


def rank_device(device: str, rank: int) -> torch.device:
    """This rank's device: the CPU, or card ``LOCAL_RANK`` (else the rank)
    modulo the card count, so ranks beyond the cards share them."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but CUDA is "
                           "not available")
    if device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(num_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None,
              devices: Optional[Sequence] = None, *, device: str = "cuda",
              backend: Optional[str] = None) -> Mesh:
    """The mesh over the started process group (``initialize_distributed``).

    Every caller of the JAX package builds a 1-D mesh, and that is what
    this takes: ``num_devices`` must be the group's size (a smaller mesh
    would need a subgroup that every rank creates; start the group with
    that many ranks instead), and ``shape`` may name more axes only of
    size 1. ``devices`` lists one device per rank; by default each rank
    takes ``rank_device(device, rank)``. ``backend`` (default NCCL on
    ``cuda``, gloo on the CPU) must be the group's: the mesh records the
    backend it runs and never switches to another.
    """
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("start the process group first "
                           "(parallel.multihost.initialize_distributed)")
    size, rank = dist.get_world_size(), dist.get_rank()
    if num_devices is None:
        num_devices = size
    if num_devices > size:
        raise ValueError(
            f"requested {num_devices} devices, only {size} available")
    if num_devices != size:
        raise ValueError(f"a mesh spans the whole group of {size} ranks; "
                         f"start the group with {num_devices} ranks")
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (num_devices,) + (1,) * (len(axis_names) - 1)
    if len(shape) != len(axis_names) or shape[0] != num_devices or any(
            n != 1 for n in shape[1:]):
        raise ValueError(f"only 1-D meshes are supported (every rank on "
                         f"the first axis); got shape {tuple(shape)} for "
                         f"axes {axis_names}")
    if devices is not None:
        if len(devices) != size:
            raise ValueError(f"{len(devices)} devices for {size} ranks")
        device = devices[rank]
    rank_dev = rank_device(device, rank)
    want = backend or default_backend(rank_dev)
    actual = dist.get_backend()
    if actual != want:
        raise ValueError(f"the process group runs {actual!r}, the mesh was "
                         f"asked for {want!r}")
    if rank_dev.type == "cuda":
        check_nccl_ranks(want, int(os.environ.get("LOCAL_WORLD_SIZE", size)))
    return Mesh(rank, size, rank_dev, want, axis_names[0])


def shard_rows(height: int, mesh: Mesh) -> tuple:
    """This rank's row range ``(start, stop)`` of ``height`` rows."""
    if height % mesh.size:
        raise ValueError(
            f"H ({height}) must divide over {mesh.size} shards")
    rows = height // mesh.size
    return mesh.rank * rows, (mesh.rank + 1) * rows


def column_splits(width: int, size: int) -> list:
    """Columns per rank: ``width // size``, the first ``width % size``
    ranks one more."""
    base, extra = divmod(width, size)
    return [base + (j < extra) for j in range(size)]


def _bytes(tensor: torch.Tensor) -> torch.Tensor:
    return tensor.contiguous().view(-1).view(torch.uint8)


def _wire(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes as the backend moves them (host copy on gloo)."""
    data = _bytes(tensor)
    if mesh.staged:
        host = torch.empty(data.numel(), dtype=torch.uint8, pin_memory=True)
        host.copy_(data)
        return host
    return data


def _empty_wire(mesh: Mesh, count: int) -> torch.Tensor:
    if mesh.staged:
        return torch.empty(count, dtype=torch.uint8, pin_memory=True)
    return torch.empty(count, dtype=torch.uint8, device=mesh.device)


def _unwire(data: torch.Tensor, like: torch.Tensor, shape) -> torch.Tensor:
    """Bytes back into a tensor of ``like``'s dtype and device."""
    data = data.to(like.device, non_blocking=False)
    return data.view(like.dtype).view(tuple(shape))


class _Timed:
    def __init__(self, mesh: Mesh, kind: str, sent: int):
        self.mesh, self.kind, self.sent = mesh, kind, sent

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.mesh.traffic[self.kind] += self.sent
        self.mesh.traffic[self.kind + "_s"] += time.perf_counter() - self.start
        return False


def exchange_halo(local: torch.Tensor, radius: int,
                  mesh: Mesh) -> torch.Tensor:
    """(Hl, ...) -> (Hl + 2 radius, ...): the previous rank's last
    ``radius`` rows above, the next rank's first below, zeros at the global
    ends (``dist.batch_isend_irecv``)."""
    if radius == 0:
        return local
    if local.shape[0] < radius:
        raise ValueError(
            f"shard height {local.shape[0]} smaller than the halo {radius}")
    edge_shape = (radius, *local.shape[1:])
    top = torch.zeros(edge_shape, dtype=local.dtype, device=local.device)
    bottom = torch.zeros_like(top)
    count = top.numel() * top.element_size()
    ops, received = [], []
    for peer, send, into in ((mesh.rank - 1, local[:radius], top),
                             (mesh.rank + 1, local[-radius:], bottom)):
        if 0 <= peer < mesh.size:
            inbox = _empty_wire(mesh, count)
            ops += [dist.P2POp(dist.isend, _wire(mesh, send), peer),
                    dist.P2POp(dist.irecv, inbox, peer)]
            received.append((inbox, into))
    with _Timed(mesh, "halo", count * len(received)):
        for request in dist.batch_isend_irecv(ops) if ops else ():
            request.wait()
        for inbox, into in received:
            into.copy_(_unwire(inbox, into, edge_shape))
    return torch.cat([top, local, bottom])


def _all_to_all(mesh: Mesh, send: torch.Tensor, send_counts: list,
                recv_counts: list) -> torch.Tensor:
    """Bytes ``send`` split by ``send_counts`` to the ranks in order; the
    bytes received, by ``recv_counts``."""
    inbox = _empty_wire(mesh, sum(recv_counts))
    sent = sum(send_counts) - send_counts[mesh.rank]
    with _Timed(mesh, "reshard", sent):
        dist.all_to_all_single(inbox, send, recv_counts, send_counts)
    return inbox


def rows_to_columns(local: torch.Tensor, mesh: Mesh) -> tuple:
    """A row shard (Hl, W, ...) -> this rank's column shard (H, Wc, ...)
    of the whole array, and its first column. Columns split as
    ``column_splits``; every rank holds Hl rows."""
    rows, width = local.shape[0], local.shape[1]
    splits = column_splits(width, mesh.size)
    starts = [sum(splits[:j]) for j in range(mesh.size)]
    rest = local.shape[2:]
    per_col = rows * local[0, 0].numel() * local.element_size()
    send = _wire(mesh, torch.cat([
        local[:, s:s + n].reshape(-1) for s, n in zip(starts, splits)]))
    mine = splits[mesh.rank]
    inbox = _all_to_all(mesh, send, [n * per_col for n in splits],
                        [mine * per_col] * mesh.size)
    out = _unwire(inbox, local, (mesh.size * rows, mine, *rest))
    return out, starts[mesh.rank]


def columns_to_rows(columns: torch.Tensor, width: int,
                    mesh: Mesh) -> torch.Tensor:
    """Invert ``rows_to_columns``: a column shard (H, Wc, ...) of a
    ``width``-column array -> this rank's row shard (Hl, W, ...)."""
    height = columns.shape[0]
    rows = height // mesh.size
    splits = column_splits(width, mesh.size)
    per_col = rows * columns[0, 0].numel() * columns.element_size()
    mine = splits[mesh.rank]
    inbox = _all_to_all(mesh, _wire(mesh, columns),
                        [mine * per_col] * mesh.size,
                        [n * per_col for n in splits])
    rest = columns.shape[2:]
    pieces, offset = [], 0
    for n in splits:
        size = n * per_col
        pieces.append(_unwire(inbox[offset:offset + size], columns,
                              (rows, n, *rest)))
        offset += size
    return torch.cat(pieces, dim=1)


def gather_rows(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's equal row shard (Hl, ...) -> the whole (N Hl, ...)
    array, on every rank."""
    data = _wire(mesh, local)
    inboxes = [_empty_wire(mesh, data.numel()) for _ in range(mesh.size)]
    with _Timed(mesh, "gather", data.numel() * (mesh.size - 1)):
        dist.all_gather(inboxes, data)
    return torch.cat([_unwire(box, local, local.shape) for box in inboxes])


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(tensor: torch.Tensor, mesh: Mesh,
               op: str = "sum") -> torch.Tensor:
    """Reduce ``tensor`` over the ranks in place (``op`` "sum" or "max")
    and return it; every rank gets the same bits."""
    if mesh.staged:
        host = tensor.detach().to("cpu").pin_memory()
        with _Timed(mesh, "reduce", host.numel() * host.element_size()):
            dist.all_reduce(host, op=_OPS[op])
        tensor.copy_(host)
        return tensor
    with _Timed(mesh, "reduce", tensor.numel() * tensor.element_size()):
        dist.all_reduce(tensor, op=_OPS[op])
    return tensor


def broadcast(tensor: torch.Tensor, mesh: Mesh,
              src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``tensor`` on every rank, in place."""
    with _Timed(mesh, "broadcast", tensor.numel() * tensor.element_size()):
        if mesh.staged:
            host = tensor.detach().to("cpu")
            dist.broadcast(host, src)
            tensor.copy_(host)
        else:
            dist.broadcast(tensor, src)
    return tensor
