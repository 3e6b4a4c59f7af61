"""MC-CNN fast-architecture feature network (mccnn_tpu/models/net.py).

Five 3x3 VALID convolutions with 64 maps, ReLU on all but the last, then
L2 normalization over channels: a zero-padded (H+10, W+10) image maps to an
(H, W, 64) field of unit descriptors, an 11 x 11 training patch to one
(``patch_descriptors``). One net serves matching and training.

Weights are kept as PyTorch's OIHW; ``params_from_numpy`` takes the JAX
package's ``{"conv{i}": {"w": HWIO, "b": (64,)}}`` tree. f32 convolutions
must not run in TF32 on the card (cuDNN's default): the matching and
training pipelines call ``disable_tf32`` first.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from mccnn_tpu_torch.utils.config import NetConfig

NumpyParams = Dict[str, Dict[str, np.ndarray]]

# tf.nn.l2_normalize's epsilon
_L2_NORMALIZE_EPS = 1e-12


class FeatureNet(nn.Module):
    """VALID conv stack on NCHW input; ReLU on all layers but the last."""

    def __init__(self, config: NetConfig = NetConfig()):
        super().__init__()
        layers = []
        cin = config.input_channels
        for i in range(1, config.num_layers + 1):
            groups = config.groups if i > 1 else 1  # layer 1 input is 1-channel
            layers.append(nn.Conv2d(cin, config.num_maps, config.kernel_size,
                                    groups=groups))
            cin = config.num_maps
        self.convs = nn.ModuleList(layers)

    @property
    def pad(self) -> int:
        """Zero padding per side that keeps one descriptor per pixel."""
        return sum(conv.kernel_size[0] - 1 for conv in self.convs) // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        last = len(self.convs) - 1
        zero = x.new_zeros(())
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if i < last:
                # jnp.maximum(x, 0.0), as in the JAX package: the same
                # values as F.relu, but a tie at 0 sends half the gradient
                # to each side (F.relu sends none). Training meets ties:
                # biases start at 0 and windows in the zero padding of
                # border patches give exactly 0.
                x = torch.maximum(x, zero)
        return x


def disable_tf32() -> None:
    """f32 convolutions and matrix products in f32 on the card, as the JAX
    reference computes them, not in TF32 (cuDNN's default)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x * rsqrt(max(sum(x^2), eps)) -- tf.nn.l2_normalize semantics."""
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=_L2_NORMALIZE_EPS))


def patch_descriptors(net: FeatureNet, patches: torch.Tensor) -> torch.Tensor:
    """(B, p, p, 1) training patches (the sampler's NHWC layout) -> (B, 64)
    unit descriptors (mccnn_tpu/models/net.py::patch_descriptors)."""
    features = net(patches.permute(0, 3, 1, 2))
    return l2_normalize(features.reshape(features.shape[0], -1), dim=-1)


def extract_features(net: FeatureNet, image: torch.Tensor) -> torch.Tensor:
    """(H, W) standardized image -> (H, W, 64) f32 unit descriptor field."""
    pad = net.pad
    x = F.pad(image, (pad, pad, pad, pad))[None, None]
    features = net(x)[0].permute(1, 2, 0)
    return l2_normalize(features, dim=-1).contiguous()


def init_params(seed: int = 0, config: NetConfig = NetConfig()) -> NumpyParams:
    """Glorot-uniform HWIO weights and zero biases, as a numpy tree.

    The same layout as the JAX package's ``init_params``; the numbers come
    from numpy's generator, so they differ from JAX's for the same seed.
    """
    rng = np.random.default_rng(seed)
    params: NumpyParams = {}
    cin = config.input_channels
    k = config.kernel_size
    for i in range(1, config.num_layers + 1):
        groups = config.groups if i > 1 else 1
        shape = (k, k, cin // groups, config.num_maps)
        fan_in = k * k * shape[2]
        fan_out = k * k * shape[3]
        limit = np.sqrt(6.0 / (fan_in + fan_out))
        params[f"conv{i}"] = {
            "w": rng.uniform(-limit, limit, shape).astype(np.float32),
            "b": np.zeros((config.num_maps,), np.float32),
        }
        cin = config.num_maps
    return params


def params_from_numpy(params: NumpyParams) -> FeatureNet:
    """Build a FeatureNet from a ``{"conv{i}": {"w": HWIO, "b"}}`` tree."""
    num_layers = len(params)
    first = np.asarray(params["conv1"]["w"])
    k, _, cin, maps = first.shape
    groups = 1
    if num_layers > 1:
        groups = maps // np.asarray(params["conv2"]["w"]).shape[2]
    net = FeatureNet(NetConfig(num_layers=num_layers, num_maps=maps,
                               kernel_size=k, input_channels=cin,
                               groups=groups))
    with torch.no_grad():
        for i, conv in enumerate(net.convs, start=1):
            layer = params[f"conv{i}"]
            w = torch.from_numpy(np.array(layer["w"], np.float32))
            conv.weight.copy_(w.permute(3, 2, 0, 1))  # HWIO -> OIHW
            conv.bias.copy_(torch.from_numpy(np.array(layer["b"],
                                                      np.float32)))
    return net.eval().requires_grad_(False)


def params_to_numpy(net: FeatureNet) -> NumpyParams:
    """The inverse of ``params_from_numpy``: HWIO weights, as the JAX
    package keeps them."""
    return {
        f"conv{i}": {
            "w": conv.weight.detach().permute(2, 3, 1, 0).cpu().numpy().copy(),
            "b": conv.bias.detach().cpu().numpy().copy(),
        }
        for i, conv in enumerate(net.convs, start=1)
    }

