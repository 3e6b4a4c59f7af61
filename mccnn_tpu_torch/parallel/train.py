"""Data-parallel training over the ranks of a mesh
(mccnn_tpu/parallel/train.py).

The JAX package shards the batch over the mesh's 'data' axis with the
params replicated, and XLA turns the replicated-gradient requirement into a
psum over the devices. Here each rank is one replica:

  * ``shard_batch`` keeps this rank's 1 / N of the global batch (every rank
    draws the same global batch from the same seeded sampler, so the sample
    stream is the single-process stream);
  * ``make_dp_train_step`` broadcasts rank 0's parameters and momentum
    once, then per step computes the local mean hinge loss and its
    gradients, sums the gradients over the ranks and divides by N (the
    global-batch mean gradient, JAX's psum), and takes the same SGD-momentum
    step on every replica. The reduction gives every rank the same bits, so
    the replicas stay bit-identical.
"""

from __future__ import annotations

import torch

from mccnn_tpu_torch.models.net import FeatureNet, disable_tf32
from mccnn_tpu_torch.parallel.mesh import Mesh, all_reduce, broadcast
from mccnn_tpu_torch.pipeline.train import (
    Batch,
    batch_to_device,
    hinge_loss,
    make_optimizer,
)
from mccnn_tpu_torch.utils.config import TrainConfig


def shard_batch(batch, mesh: Mesh) -> Batch:
    """This rank's contiguous 1 / N of a global ``(left, pos, neg)`` batch
    of host arrays, as float32 tensors on the rank's device."""
    size = batch[0].shape[0]
    if size % mesh.size:
        raise ValueError(
            f"batch of {size} does not divide over {mesh.size} ranks")
    per = size // mesh.size
    start = mesh.rank * per
    return batch_to_device([x[start:start + per] for x in batch],
                           mesh.device)


def make_dp_train_step(config: TrainConfig, net: FeatureNet, mesh: Mesh,
                       optimizer: torch.optim.Optimizer = None):
    """``train_step(local_batch) -> loss``: one data-parallel SGD step of
    ``net`` (on ``mesh.device``) in place; the loss is the global batch's
    mean (a 0-d tensor, the same on every rank). Rank 0's parameters and
    momentum traces are broadcast to every rank first."""
    if optimizer is None:
        optimizer = make_optimizer(config, net)
    disable_tf32()
    net.requires_grad_(True)
    params = list(net.parameters())
    with torch.no_grad():
        for p in params:
            broadcast(p.data, mesh)
            trace = optimizer.state.get(p, {}).get("momentum_buffer")
            if trace is not None:
                broadcast(trace, mesh)

    def train_step(batch: Batch) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = hinge_loss(net, batch, config.margin)
        loss.backward()
        with torch.no_grad():
            flat = torch.cat([p.grad.reshape(-1) for p in params]
                             + [loss.detach().reshape(1)])
            all_reduce(flat, mesh)
            # a true division by N: the mean of the ranks' mean gradients
            flat = flat / torch.full_like(flat, mesh.size)
            offset = 0
            for p in params:
                count = p.numel()
                p.grad.copy_(flat[offset:offset + count].view_as(p))
                offset += count
        optimizer.step()
        return flat[-1]

    return train_step
