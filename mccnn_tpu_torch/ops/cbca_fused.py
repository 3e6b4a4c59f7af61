"""CBCA rounds on kernels K2 and K4 (mccnn_tpu/ops/cbca_fused.py).

``cbca_fused`` computes the region-size normalizer once per call, then
runs one launch of ``csrc/cbca_round.cu`` per round on a CUDA tensor, or
the plain round (``ops/cbca.py``) on a CPU tensor. The kernel sums in f32
in the plain round's order, so the two agree bit for bit; this is tighter
than the TPU kernel's bf16 mode, which rounds the horizontal sums to bf16
in its DEFAULT-precision vertical phase.

A round is one pass that keeps its horizontal sums on the chip and reads
its neighbours, so on CUDA the rounds alternate between two buffers of the
storage type (``ops/cbca_rounds.py``) and the caller's volume is never
written.

``cbca_fused(..., compute_dtype=torch.bfloat16)`` on an f32 volume is the
mixed mode ("fused16"): f32 storage between rounds, every volume value
rounded to bf16 before the horizontal sum, all sums f32; a flag of K2 and of
the plain round. The TPU kernel's DEFAULT-precision vertical phase also
rounds the horizontal sums to bf16 in this mode; the port leaves that out,
here as in bf16 storage.

``cbca_fused(..., int8_storage=True)`` is the int8 memory mode ("fused8"):
the volume is quantized once per call (``_quantize_int8``: one symmetric
scale from the non-BIG values, BIG lanes pinned to 127), every round is
exact integer math on kernel K4 (``csrc/cbca_round_int8.cu``; on a CPU
tensor ``cbca_int8_plain``, the counterpart of JAX's ``cbca_int8_xla``), and
the result is dequantized. An int8 input is taken as pre-quantized ("raw"
mode): int8 in, int8 out, no scale. Kernel and plain version agree bit for
bit.
"""

from __future__ import annotations

import torch

from mccnn_tpu_torch.ops.cbca import (
    CrossArms,
    cbca,
    cbca_round,
    inverse_region_size,
)
from mccnn_tpu_torch.ops.cbca_rounds import (
    compute_flag,
    launch_round,
    run_rounds,
)
from mccnn_tpu_torch.ops.common import BIG_COST

_STORAGE = (torch.float32, torch.bfloat16)
_LANES = 128  # disparities per K2 launch: D must be a multiple
_BIG_CUTOFF = 1e8  # values at or above this are BIG_COST pad sentinels
_INT8_LANES = 32  # D must be a multiple (K4 takes 16 lanes a block)


def cbca_round_cuda(vol_in: torch.Tensor, vol_out: torch.Tensor,
                    arms: CrossArms, inv_region: torch.Tensor,
                    distance_threshold: int,
                    compute_dtype: torch.dtype | None = None) -> None:
    """Launch one K2 round: vol_out <- round(vol_in), out of place.

    ``compute_dtype=torch.bfloat16`` on f32 storage rounds each value to
    bf16 as it enters the horizontal sum."""
    launch_round("mccnn_cbca_round", "cbca_round", vol_in, vol_out, arms,
                 inv_region, distance_threshold, _STORAGE, _LANES,
                 int(vol_in.dtype == torch.bfloat16),
                 compute_flag(vol_in, compute_dtype))


def _quantize_int8(volume: torch.Tensor):
    """Symmetric per-call int8 quantization of a cost volume: (q, scale).

    One scale per call from the valid (non-BIG) values: rounds are convex
    averages, so the entry scale stays valid for every later round.
    BIG_COST lanes quantize to exactly 127 and valid values to at most 126
    in magnitude, so q == 127 identifies BIG: the lanes average only among
    themselves and stay 127 under integer-average rounds.
    """
    scale = int8_scale(int8_amax(volume))
    return quantize_int8(volume, scale), scale


def int8_amax(volume: torch.Tensor) -> torch.Tensor:
    """0-d f32 largest |value| of the valid (non-BIG) lanes. The sharded
    matcher takes it over every shard (a max is exact in any order) and
    then quantizes each shard as the whole volume would be."""
    vol_f = volume.float()
    return torch.where(vol_f >= _BIG_CUTOFF, 0.0, vol_f.abs()).max()


def int8_scale(amax: torch.Tensor) -> torch.Tensor:
    """The quantization scale 126 / amax."""
    # a true division: torch evaluates ``126.0 / tensor`` as a reciprocal
    # times 126, which rounds differently
    return torch.full_like(amax, 126.0) / torch.clamp(amax, min=1e-30)


def quantize_int8(volume: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The int8 codes of ``volume`` at ``scale``; BIG lanes become 127."""
    vol_f = volume.float()
    q = torch.clamp(torch.round(vol_f * scale), -126.0, 126.0)
    return torch.where(vol_f >= _BIG_CUTOFF, 127.0, q).to(torch.int8)


def _dequantize_int8(q: torch.Tensor, scale, out_dtype) -> torch.Tensor:
    """Invert ``_quantize_int8``; q == 127 restores the BIG_COST sentinel."""
    deq = q.float() / scale
    return torch.where(q == 127, BIG_COST, deq).to(out_dtype)


def cbca_round_int8_plain(q: torch.Tensor, arms: CrossArms,
                          inv_region: torch.Tensor,
                          distance_threshold: int) -> torch.Tensor:
    """One int8 round: round_half_even(sum(q) * inv_region), stored int8.

    The f32 sums of at most 27 x 27 int8 values are exact integers (below
    2^24) in any order.
    """
    out = cbca_round(q.float(), arms, inv_region, distance_threshold)
    return torch.round(out).to(torch.int8)


def cbca_int8_plain(volume: torch.Tensor, arms: CrossArms,
                    num_iterations: int,
                    distance_threshold: int = 14) -> torch.Tensor:
    """Plain version of the int8-storage aggregation (K4's reference).

    A float volume is quantized once, aggregated and dequantized to its own
    dtype; an int8 volume is pre-quantized and stays int8.
    """
    if num_iterations == 0:
        return volume
    raw = volume.dtype == torch.int8
    q, scale = (volume, None) if raw else _quantize_int8(volume)
    inv_region = inverse_region_size(arms, distance_threshold)
    for _ in range(num_iterations):
        q = cbca_round_int8_plain(q, arms, inv_region, distance_threshold)
    return q if raw else _dequantize_int8(q, scale, volume.dtype)


def cbca_round_int8_cuda(vol_in: torch.Tensor, vol_out: torch.Tensor,
                         arms: CrossArms, inv_region: torch.Tensor,
                         distance_threshold: int) -> None:
    """Launch one K4 round: vol_out <- round(vol_in), out of place."""
    launch_round("mccnn_cbca_round_int8", "cbca_round_int8", vol_in, vol_out,
                 arms, inv_region, distance_threshold, (torch.int8,),
                 _INT8_LANES)


def _cbca_fused_int8(volume: torch.Tensor, arms: CrossArms,
                     num_iterations: int,
                     distance_threshold: int) -> torch.Tensor:
    if num_iterations == 0 or volume.device.type == "cpu":
        return cbca_int8_plain(volume, arms, num_iterations,
                               distance_threshold)
    raw = volume.dtype == torch.int8
    q, scale = (volume, None) if raw else _quantize_int8(volume)
    q = run_rounds(cbca_round_int8_cuda, q.contiguous(), arms,
                   num_iterations, distance_threshold)
    return q if raw else _dequantize_int8(q, scale, volume.dtype)


def cbca_fused(volume: torch.Tensor, arms: CrossArms, num_iterations: int,
               distance_threshold: int = 14, int8_storage: bool = False,
               compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Drop-in for ``ops.cbca.cbca`` (f32 and bf16 volumes).

    ``int8_storage=True`` runs the rounds in int8 (K4); an int8 volume is
    then taken as pre-quantized and returned as int8.
    ``compute_dtype=torch.bfloat16`` rounds the volume values to bf16 before
    each round's horizontal sum (f32 sums and storage; the module docstring
    says what of the TPU mode is left out).
    """
    if int8_storage:
        return _cbca_fused_int8(volume, arms, num_iterations,
                                distance_threshold)
    if num_iterations == 0 or volume.device.type == "cpu":
        return cbca(volume, arms, num_iterations, distance_threshold,
                    compute_dtype)

    def one_round(vol_in, vol_out, arms, inv_region, distance):
        cbca_round_cuda(vol_in, vol_out, arms, inv_region, distance,
                        compute_dtype)

    return run_rounds(one_round, volume.contiguous(), arms, num_iterations,
                      distance_threshold)
