"""Hinge-loss Siamese training step on PyTorch (mccnn_tpu/pipeline/train.py).

Three weight-sharing streams embed (left, right_pos, right_neg) 11 x 11
patches to unit 64-d descriptors; scores are channel dot products;
loss = mean(max(0, margin - s_pos + s_neg)); the optimizer is SGD with
momentum ``beta``, no dampening and no Nesterov: trace = g + beta * trace,
p -= lr * trace, the first trace g. That is optax's ``sgd(momentum=beta)``
and ``torch.optim.SGD(momentum=beta)`` alike.

The three streams run as one batch of 3B through the net: each sample's
values are those of three separate calls, and the gradients differ from
the JAX package's only in the order of their sums. Both ``max`` ties (the
ReLUs and the hinge) split the gradient as ``jnp.maximum`` does. f32
convolutions run without TF32 on the card, as the JAX reference is exact
f32.

The JAX step is a pure function of (params, opt_state, batch); here the
net and the optimizer hold that state, and the step returns the loss as a
tensor on the net's device without waiting for the device. The momentum
traces cross to and from the checkpoint format as a numpy tree in HWIO
(``momentum_to_numpy``, ``load_momentum``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from mccnn_tpu_torch.models.net import (
    FeatureNet,
    NumpyParams,
    disable_tf32,
    patch_descriptors,
)
from mccnn_tpu_torch.utils.config import TrainConfig

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (left, pos, neg)


def hinge_loss(net: FeatureNet, batch: Batch, margin: float) -> torch.Tensor:
    left, right_pos, right_neg = batch
    count = left.shape[0]
    descriptors = patch_descriptors(net, torch.cat([left, right_pos,
                                                    right_neg]))
    desc_left = descriptors[:count]
    score_pos = torch.sum(desc_left * descriptors[count:2 * count], dim=-1)
    score_neg = torch.sum(desc_left * descriptors[2 * count:], dim=-1)
    return torch.mean(torch.maximum(score_pos.new_zeros(()),
                                    margin - score_pos + score_neg))


def make_optimizer(config: TrainConfig, net: FeatureNet) -> torch.optim.SGD:
    return torch.optim.SGD(net.parameters(), lr=config.learning_rate,
                           momentum=config.beta)


def make_train_step(config: TrainConfig, net: FeatureNet,
                    optimizer: torch.optim.Optimizer = None):
    """Build ``train_step(batch) -> loss``: one SGD step of ``net`` in
    place. The loss is a 0-d tensor on the net's device; nothing in the
    step waits for the device."""
    if optimizer is None:
        optimizer = make_optimizer(config, net)
    disable_tf32()
    net.requires_grad_(True)

    def train_step(batch: Batch) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = hinge_loss(net, batch, config.margin)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


def make_eval_step(config: TrainConfig, net: FeatureNet):
    disable_tf32()

    def eval_step(batch: Batch) -> torch.Tensor:
        with torch.no_grad():
            return hinge_loss(net, batch, config.margin)

    return eval_step


def batch_to_device(batch: Sequence[np.ndarray], device) -> Batch:
    """Host patch arrays -> float32 tensors on ``device``. A CUDA copy goes
    through pinned memory, so it queues behind the running step instead of
    waiting for it."""
    device = torch.device(device)
    out = []
    for array in batch:
        tensor = torch.from_numpy(np.ascontiguousarray(array, np.float32))
        if device.type == "cuda":
            tensor = tensor.pin_memory().to(device, non_blocking=True)
        out.append(tensor.to(device))
    return tuple(out)


def momentum_to_numpy(net: FeatureNet,
                      optimizer: torch.optim.Optimizer) -> NumpyParams:
    """The momentum traces as a ``{"conv{i}": {"w": HWIO, "b"}}`` tree (the
    JAX package's optax trace); zeros before the first step, as optax's
    initial state."""

    def trace(parameter):
        buffer = optimizer.state.get(parameter, {}).get("momentum_buffer")
        if buffer is None:
            buffer = torch.zeros_like(parameter)
        return buffer.detach().cpu()

    return {
        f"conv{i}": {
            "w": trace(conv.weight).permute(2, 3, 1, 0).numpy().copy(),
            "b": trace(conv.bias).numpy().copy(),
        }
        for i, conv in enumerate(net.convs, start=1)
    }


def load_momentum(net: FeatureNet, optimizer: torch.optim.Optimizer,
                  momentum: NumpyParams) -> None:
    """Set the optimizer's momentum traces from a ``momentum_to_numpy``
    tree (HWIO weights)."""
    for i, conv in enumerate(net.convs, start=1):
        layer = momentum[f"conv{i}"]
        for parameter, value in ((conv.weight, np.asarray(layer["w"])
                                  .transpose(3, 2, 0, 1)),
                                 (conv.bias, np.asarray(layer["b"]))):
            if value.shape != tuple(parameter.shape):
                raise ValueError(
                    f"conv{i} momentum of shape {value.shape} for a "
                    f"parameter of shape {tuple(parameter.shape)}")
            optimizer.state[parameter]["momentum_buffer"] = (
                torch.from_numpy(np.array(value, np.float32))
                .to(parameter.device))
