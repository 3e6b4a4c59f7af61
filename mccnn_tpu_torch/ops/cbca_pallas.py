"""Exact-f32 single-pass CBCA rounds on kernel K7
(mccnn_tpu/ops/cbca_pallas.py).

``cbca_pallas`` is a drop-in for ``ops.cbca.cbca`` on f32 volumes, the
``cbca_impl="pallas"`` backend: the region-size normalizer once per call,
then one launch of ``csrc/cbca_stencil.cu`` per round on a CUDA tensor, or
the plain round (``ops/cbca.py``) on a CPU tensor. The kernel runs K2's
one-pass walk (``csrc/cbca_walk.cuh``) in f32 with blocks of its own: the
horizontal sums stay on the chip (no scratch volume in device memory) and
are taken in the plain round's order, so the two agree bit for bit, and
K7 equals K2 in f32.

A round reads its neighbours, so on CUDA the rounds alternate between two
buffers: a copy of the input and one more volume.
"""

from __future__ import annotations

import torch

from mccnn_tpu_torch.ops.cbca import CrossArms, cbca
from mccnn_tpu_torch.ops.cbca_rounds import launch_round, run_rounds

_LANES = 8  # disparities per block: D must be a multiple


def cbca_stencil_round_cuda(vol_in: torch.Tensor, vol_out: torch.Tensor,
                            arms: CrossArms, inv_region: torch.Tensor,
                            distance_threshold: int) -> None:
    """Launch one K7 round: vol_out <- round(vol_in), out of place."""
    launch_round("mccnn_cbca_stencil_round", "cbca_stencil_round", vol_in,
                 vol_out, arms, inv_region, distance_threshold,
                 (torch.float32,), _LANES)


def cbca_pallas(volume: torch.Tensor, arms: CrossArms, num_iterations: int,
                distance_threshold: int = 14) -> torch.Tensor:
    """Drop-in for ``ops.cbca.cbca`` on f32 volumes, backed by K7."""
    if volume.dtype != torch.float32:
        raise ValueError(
            f"cbca_pallas takes float32 volumes, got {volume.dtype}")
    if num_iterations == 0 or volume.device.type == "cpu":
        return cbca(volume, arms, num_iterations, distance_threshold)
    return run_rounds(cbca_stencil_round_cuda, volume, arms, num_iterations,
                      distance_threshold)
