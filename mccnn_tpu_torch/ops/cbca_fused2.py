"""CBCA on kernel K9, two rounds per pass (mccnn_tpu/ops/cbca_fused2.py).

``cbca_fused_two`` is a drop-in for ``ops.cbca.cbca`` on f32 and bf16
volumes, the ``cbca_impl="fused2"`` backend, and with
``compute_dtype=torch.bfloat16`` on f32 storage ``"fused2_16"``. It runs
``num_iterations // 2`` launches of ``csrc/cbca_two_round.cu``, each of
which computes two rounds with the first round's result kept on the chip,
and an odd remainder round through ``cbca_fused`` (K2). The intermediate is
rounded to the storage type exactly where an unfused round would store it
(in bf16 storage once; in the mixed mode it stays f32 and is rounded to
bf16 again as the second round's operand), so a pass equals two single
rounds bit for bit, and on a CPU tensor the function simply runs the plain
rounds (``ops/cbca.py``). Every shape runs the kernel: the JAX wrapper's
fallback for narrow images is a TPU tiling limit and has no counterpart
here.

A pass reads its neighbours, so on CUDA the passes alternate between two
buffers and the caller's volume is never written.
"""

from __future__ import annotations

import torch

from mccnn_tpu_torch.ops.cbca import CrossArms, cbca
from mccnn_tpu_torch.ops.cbca_fused import cbca_fused
from mccnn_tpu_torch.ops.cbca_rounds import (
    compute_flag,
    launch_round,
    run_rounds,
)

_STORAGE = (torch.float32, torch.bfloat16)
_LANES = 8  # disparities per block: D must be a multiple


def cbca_two_rounds_cuda(vol_in: torch.Tensor, vol_out: torch.Tensor,
                         arms: CrossArms, inv_region: torch.Tensor,
                         distance_threshold: int,
                         compute_dtype: torch.dtype | None = None) -> None:
    """Launch one K9 pass: vol_out <- round(round(vol_in)), out of place."""
    launch_round("mccnn_cbca_two_rounds", "cbca_two_rounds", vol_in, vol_out,
                 arms, inv_region, distance_threshold, _STORAGE, _LANES,
                 int(vol_in.dtype == torch.bfloat16),
                 compute_flag(vol_in, compute_dtype))


def cbca_fused_two(volume: torch.Tensor, arms: CrossArms,
                   num_iterations: int, distance_threshold: int = 14,
                   compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Drop-in for ``ops.cbca.cbca`` (f32 and bf16 volumes), backed by K9.

    ``num_iterations // 2`` two-round passes; an odd remainder round goes
    through ``cbca_fused``.
    """
    if volume.dtype not in _STORAGE:
        raise ValueError(
            f"cbca_fused_two takes float32 or bfloat16 volumes, got "
            f"{volume.dtype}")
    if num_iterations == 0 or volume.device.type == "cpu":
        return cbca(volume, arms, num_iterations, distance_threshold,
                    compute_dtype)

    def one_pass(vol_in, vol_out, arms, inv_region, distance):
        cbca_two_rounds_cuda(vol_in, vol_out, arms, inv_region, distance,
                             compute_dtype)

    out = run_rounds(one_pass, volume.contiguous(), arms,
                     num_iterations // 2, distance_threshold)
    if num_iterations % 2:
        out = cbca_fused(out, arms, 1, distance_threshold,
                         compute_dtype=compute_dtype)
    return out
