"""What the CBCA round kernels' wrappers share (K2 ``ops/cbca_fused.py``,
K4 there too, K7 ``ops/cbca_pallas.py``): the operand checks of one round
and the two-buffer loop of the out-of-place kernels."""

from __future__ import annotations

import torch

from mccnn_tpu_torch.kernels.build import require_cuda
from mccnn_tpu_torch.ops.cbca import CrossArms, inverse_region_size

MAX_RADIUS = 16  # the kernels' halo


def check_round_operands(vol_in: torch.Tensor, vol_out: torch.Tensor,
                         arms: CrossArms, inv_region: torch.Tensor,
                         distance_threshold: int, dtypes: tuple, lanes: int,
                         in_place: bool = False) -> int:
    """Validate the operands of a round kernel; returns the radius.

    ``dtypes`` are the storage types the kernel takes, ``lanes`` what the
    depth must be a multiple of; ``in_place`` says whether the output may
    be the input.
    """
    require_cuda("volume", vol_in, dtypes)
    require_cuda("output volume", vol_out, (vol_in.dtype,))
    for name, plane in zip(CrossArms._fields, arms):
        require_cuda(f"{name} arm", plane, (torch.int32,))
    require_cuda("inv_region", inv_region, (torch.float32,))
    height, width, depth = vol_in.shape
    if (vol_out.shape != vol_in.shape
            or any(a.shape != (height, width) for a in arms)
            or inv_region.shape != (height, width) or depth % lanes):
        raise ValueError(
            f"cbca round: mismatched shapes or D % {lanes} != 0")
    if not in_place and vol_out.data_ptr() == vol_in.data_ptr():
        raise ValueError("cbca round: the kernel cannot run in place")
    radius = distance_threshold - 1
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(
            f"distance_threshold {distance_threshold} exceeds the kernel halo")
    return radius


def run_rounds(round_cuda, volume: torch.Tensor, arms: CrossArms,
               num_iterations: int, distance_threshold: int) -> torch.Tensor:
    """``num_iterations`` out-of-place rounds over two buffers on CUDA."""
    inv_region = inverse_region_size(arms, distance_threshold).contiguous()
    arms = CrossArms(*(a.to(torch.int32).contiguous() for a in arms))
    # the caller's volume is never written: round 1 reads it, later rounds
    # alternate between the two buffers
    buffers = [torch.empty_like(volume)]
    source = volume
    for i in range(num_iterations):
        if i == 1:
            buffers.append(torch.empty_like(volume))
        target = buffers[i % 2]
        round_cuda(source, target, arms, inv_region, distance_threshold)
        source = target
    return source
