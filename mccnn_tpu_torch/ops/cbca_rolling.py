"""CBCA rounds on kernel K8, the row-rolling round
(mccnn_tpu/ops/cbca_rolling.py).

``cbca_fused_rolling`` is a drop-in for ``ops.cbca.cbca`` on f32 and bf16
volumes, the ``cbca_impl="rolling"`` backend, and with
``compute_dtype=torch.bfloat16`` on f32 storage ``"rolling16"``: the
region-size normalizer once per call, then one launch of
``csrc/cbca_rolling.cu`` per round on a CUDA tensor, or the plain round
(``ops/cbca.py``, with the same rounding points) on a CPU tensor. The kernel
is its own instantiation of the walk that K2 runs (``csrc/cbca_walk.cuh``):
it rolls down a band of a column strip several rows a step, with the
horizontal sums in a shared-memory ring and register windows, so every
volume row is read once per strip and no scratch volume exists. It sums in
the plain round's order and equals the plain round, and K2
(``ops/cbca_fused.py``), bit for bit. D need only be a multiple of one lane
chunk (16 lanes in bf16, 8 in f32; K2 takes whole 128-lane chunks). Every
shape runs the kernel: the JAX wrapper's fallback for narrow images is a
TPU tiling limit and has no counterpart here.

A round reads its neighbours, so on CUDA the rounds alternate between two
buffers and the caller's volume is never written.
"""

from __future__ import annotations

import torch

from mccnn_tpu_torch.ops.cbca import CrossArms, cbca
from mccnn_tpu_torch.ops.cbca_rounds import (
    compute_flag,
    launch_round,
    run_rounds,
)

_STORAGE = (torch.float32, torch.bfloat16)


def cbca_rolling_round_cuda(vol_in: torch.Tensor, vol_out: torch.Tensor,
                            arms: CrossArms, inv_region: torch.Tensor,
                            distance_threshold: int,
                            compute_dtype: torch.dtype | None = None) -> None:
    """Launch one K8 round: vol_out <- round(vol_in), out of place."""
    bf16 = vol_in.dtype == torch.bfloat16
    # a block's lane chunk is one 32-byte sector of a pixel's D-row
    launch_round("mccnn_cbca_rolling_round", "cbca_rolling_round", vol_in,
                 vol_out, arms, inv_region, distance_threshold, _STORAGE,
                 16 if bf16 else 8, int(bf16),
                 compute_flag(vol_in, compute_dtype))


def cbca_fused_rolling(volume: torch.Tensor, arms: CrossArms,
                       num_iterations: int, distance_threshold: int = 14,
                       compute_dtype: torch.dtype | None = None
                       ) -> torch.Tensor:
    """Drop-in for ``ops.cbca.cbca`` (f32 and bf16 volumes), backed by K8.

    ``compute_dtype=torch.bfloat16`` rounds the volume values to bf16
    before each round's horizontal sum (f32 sums and storage), as
    ``cbca_fused`` does.
    """
    if volume.dtype not in _STORAGE:
        raise ValueError(
            f"cbca_fused_rolling takes float32 or bfloat16 volumes, got "
            f"{volume.dtype}")
    if num_iterations == 0 or volume.device.type == "cpu":
        return cbca(volume, arms, num_iterations, distance_threshold,
                    compute_dtype)

    def one_round(vol_in, vol_out, arms, inv_region, distance):
        cbca_rolling_round_cuda(vol_in, vol_out, arms, inv_region, distance,
                                compute_dtype)

    return run_rounds(one_round, volume.contiguous(), arms, num_iterations,
                      distance_threshold)
