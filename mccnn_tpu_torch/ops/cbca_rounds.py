"""What the CBCA round kernels' wrappers share (K2 and K4
``ops/cbca_fused.py``, K7 ``ops/cbca_pallas.py``, K8 ``ops/cbca_rolling.py``,
K9 ``ops/cbca_fused2.py``): the operand checks of one round, the launch of
an out-of-place round kernel and the two-buffer loop over rounds."""

from __future__ import annotations

import torch

from mccnn_tpu_torch.kernels.build import (
    LAUNCHES,
    check,
    library,
    require_cuda,
    stream_handle,
)
from mccnn_tpu_torch.ops.cbca import CrossArms, inverse_region_size

MAX_RADIUS = 16  # the kernels' halo


def check_round_operands(vol_in: torch.Tensor, vol_out: torch.Tensor,
                         arms: CrossArms, inv_region: torch.Tensor,
                         distance_threshold: int, dtypes: tuple,
                         lanes: int) -> int:
    """Validate the operands of a round kernel; returns the radius.

    ``dtypes`` are the storage types the kernel takes, ``lanes`` what the
    depth must be a multiple of. Every round kernel reads its neighbours,
    so the output may not be the input.
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
    if vol_out.data_ptr() == vol_in.data_ptr():
        raise ValueError("cbca round: the kernel cannot run in place")
    radius = distance_threshold - 1
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(
            f"distance_threshold {distance_threshold} exceeds the kernel halo")
    return radius


def compute_flag(volume: torch.Tensor, compute_dtype) -> int:
    """The kernels' bf16-operand flag for a ``compute_dtype`` argument: 1
    when f32 storage is to be rounded to bf16 before the horizontal sum."""
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{compute_dtype}")
    return int(compute_dtype == torch.bfloat16
               and volume.dtype == torch.float32)


def launch_round(entry: str, name: str, vol_in: torch.Tensor,
                 vol_out: torch.Tensor, arms: CrossArms,
                 inv_region: torch.Tensor, distance_threshold: int,
                 dtypes: tuple, lanes: int, *flags: int) -> None:
    """Launch the out-of-place round kernel ``entry`` (a C function taking
    volume in, volume out, the four arm planes, 1 / region, H, W, D, the
    radius, then ``flags``) and count it under ``name``."""
    radius = check_round_operands(vol_in, vol_out, arms, inv_region,
                                  distance_threshold, dtypes, lanes)
    height, width, depth = vol_in.shape
    code = getattr(library(), entry)(
        vol_in.data_ptr(), vol_out.data_ptr(), arms.left.data_ptr(),
        arms.right.data_ptr(), arms.up.data_ptr(), arms.down.data_ptr(),
        inv_region.data_ptr(), height, width, depth, radius, *flags,
        stream_handle(vol_in),
    )
    check(code, name)
    LAUNCHES.add(name)


def run_rounds(round_cuda, volume: torch.Tensor, arms: CrossArms,
               num_iterations: int, distance_threshold: int) -> torch.Tensor:
    """``num_iterations`` out-of-place launches over two buffers on CUDA;
    ``round_cuda(vol_in, vol_out, arms, inv_region, distance_threshold)``."""
    if num_iterations == 0:
        return volume
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
