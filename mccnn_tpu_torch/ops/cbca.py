"""Cross-based cost aggregation, plain PyTorch (mccnn_tpu/ops/cbca.py).

  * Each pixel grows 4 arms, extending while the endpoint's intensity stays
    within ``intensity_threshold`` of the centre and the offset stays under
    ``distance_threshold`` (``compute_arms``).
  * The support region of p is the union, over pixels v on p's vertical
    arm, of v's horizontal arm.
  * Each round replaces every disparity fibre with the mean over the
    support region; the region-size normalizer is computed once.

Sums run in f32 in a fixed order (centre, then +1, -1, +2, -2, ...), the
order of the JAX stencil and of kernel K2 (``ops/cbca_fused.py``); each
round's result is cast back to the storage dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.nn import functional as F


class CrossArms(NamedTuple):
    """Arm extents per pixel (int32 (H, W) maps, self excluded)."""

    up: torch.Tensor
    down: torch.Tensor
    left: torch.Tensor
    right: torch.Tensor


def compute_arms(image: torch.Tensor, intensity_threshold: float,
                 distance_threshold: int) -> CrossArms:
    """Grow the 4 support arms of every pixel of an (H, W) image.

    The intensity test ``|I(p) - I(q)| < tau`` is on the endpoint q; arms
    are capped at ``distance_threshold - 1`` and at the image border.
    """

    def arm(dim: int, sign: int) -> torch.Tensor:
        size = image.shape[dim]
        coords = torch.arange(size, device=image.device)
        coords = coords[:, None] if dim == 0 else coords[None, :]
        length = torch.zeros(image.shape, dtype=torch.int32,
                             device=image.device)
        alive = torch.ones(image.shape, dtype=torch.bool, device=image.device)
        for offset in range(1, distance_threshold):
            neighbor = torch.roll(image, sign * offset, dims=dim)
            if sign > 0:  # neighbour at coord - offset (up / left)
                in_bounds = coords - offset >= 0
            else:  # neighbour at coord + offset (down / right)
                in_bounds = coords + offset < size
            alive = alive & in_bounds & (
                torch.abs(image - neighbor) < intensity_threshold)
            length = length + alive.to(torch.int32)
        return length

    return CrossArms(up=arm(0, +1), down=arm(0, -1), left=arm(1, +1),
                     right=arm(1, -1))


def _arm_stencil_sum(volume: torch.Tensor, neg_arm: torch.Tensor,
                     pos_arm: torch.Tensor, dim: int,
                     distance_threshold: int) -> torch.Tensor:
    """sum over o in [-neg_arm(p), +pos_arm(p)] of volume[p + o along dim].

    ``volume`` is an (H, W) plane or an (H, W, D) volume; the arms are
    (H, W). Border-capped arms never reach the zero padding.
    """
    radius = distance_threshold - 1
    pad = [0, 0] * volume.ndim
    at = 2 * (volume.ndim - 1 - dim)  # F.pad lists the last dim first
    pad[at] = pad[at + 1] = radius
    padded = F.pad(volume, pad)
    size = volume.shape[dim]

    def shifted(offset: int) -> torch.Tensor:
        return padded.narrow(dim, radius + offset, size)

    def gate(plane: torch.Tensor) -> torch.Tensor:
        return plane[..., None] if volume.ndim == 3 else plane

    acc = volume  # offset 0: always in the arm
    for offset in range(1, distance_threshold):
        acc = acc + torch.where(gate(pos_arm >= offset), shifted(+offset), 0.0)
        acc = acc + torch.where(gate(neg_arm >= offset), shifted(-offset), 0.0)
    return acc


def inverse_region_size(arms: CrossArms,
                        distance_threshold: int) -> torch.Tensor:
    """(H, W) f32 1 / |support region| (disparity-independent)."""
    h_count = (arms.left + arms.right + 1).float()
    region = _arm_stencil_sum(h_count, arms.up, arms.down, 0,
                              distance_threshold)
    return 1.0 / region


def cbca_round(volume: torch.Tensor, arms: CrossArms,
               inv_region: torch.Tensor, distance_threshold: int,
               compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """One aggregation round: f32 sums, result in the storage dtype.

    ``compute_dtype=torch.bfloat16`` rounds every volume value to bf16
    before the horizontal sum (the JAX kernels' bf16-multiply mode on f32
    storage; a no-op on a bf16 volume); all sums stay f32.
    """
    if compute_dtype == torch.bfloat16:
        operand = volume.to(torch.bfloat16).float()
    elif compute_dtype in (None, torch.float32):
        operand = volume.float()
    else:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{compute_dtype}")
    horiz = _arm_stencil_sum(operand, arms.left, arms.right, 1,
                             distance_threshold)
    aggregated = _arm_stencil_sum(horiz, arms.up, arms.down, 0,
                                  distance_threshold)
    return (aggregated * inv_region[..., None]).to(volume.dtype)


def cbca(volume: torch.Tensor, arms: CrossArms, num_iterations: int,
         distance_threshold: int = 14,
         compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Aggregate an (H, W, D) cost volume over cross support regions."""
    if num_iterations == 0:
        return volume
    inv_region = inverse_region_size(arms, distance_threshold)
    for _ in range(num_iterations):
        volume = cbca_round(volume, arms, inv_region, distance_threshold,
                            compute_dtype)
    return volume
