"""CBCA aggregation as banded 0/1 matrix products
(mccnn_tpu/ops/cbca_mxu.py, ``cbca_impl="mxu"``).

The arm-gated sums are linear operators with round-invariant masks:

    mid[h, :, :] = M[h]^T @ vol[h]     M[h][w', w] = 1 iff w' is on the
                                       horizontal arm of (h, w)
    out[., w, :] = N[w]^T @ mid[., w]  N[w][h', h] = 1 iff h' is on the
                                       vertical arm of (h, w)

Both mask stacks are built once per image (int8) and reused by every round.
This is plain XLA in the JAX package, outside any Pallas kernel, so here the
two batched products are ``torch.bmm``. Numerics as in JAX: the volume and
the horizontal sums are each rounded to bf16 once per round, the products
accumulate in f32 and the result is f32. ``torch.bmm`` of bf16 operands
would round its result to bf16, so the bf16-rounded values are multiplied
as f32 (the masks are 0/1, every product is exact; TF32 must be off, which
is PyTorch's default for matrix products and what ``match_pair`` sets).

The stacks take H x W x W + W x H x H bytes; they are built, and widened to
f32 for the products, a chunk of rows or columns at a time.
"""

from __future__ import annotations

import torch

from mccnn_tpu_torch.ops.cbca import CrossArms, inverse_region_size

_CHUNK_BYTES = 256 * 1024 * 1024  # f32 mask slab widened per product


def _chunk(batch: int, side: int) -> int:
    """Batch entries per slab of (side, side) f32 masks."""
    return max(1, min(batch, _CHUNK_BYTES // (4 * side * side)))


def _band_masks(neg_arm: torch.Tensor, pos_arm: torch.Tensor) -> torch.Tensor:
    """(B, N, N) int8: mask[b, src, dst] = 1 iff src - dst lies in
    [-neg_arm[b, dst], pos_arm[b, dst]]."""
    batch, side = neg_arm.shape
    index = torch.arange(side, dtype=torch.int32, device=neg_arm.device)
    delta = index[None, :, None] - index[None, None, :]  # src - dst
    out = torch.empty((batch, side, side), dtype=torch.int8,
                      device=neg_arm.device)
    step = _chunk(batch, side)
    for b0 in range(0, batch, step):
        b1 = min(b0 + step, batch)
        neg = neg_arm[b0:b1, None, :].to(torch.int32)
        pos = pos_arm[b0:b1, None, :].to(torch.int32)
        out[b0:b1] = ((delta >= -neg) & (delta <= pos)).to(torch.int8)
    return out


def build_masks(arms: CrossArms):
    """(H, W, W) horizontal and (W, H, H) vertical int8 mask stacks."""
    horiz = _band_masks(arms.left, arms.right)
    vert = _band_masks(arms.up.T, arms.down.T)
    return horiz, vert


def _masked_sums(masks: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """out[b, dst, :] = sum over src of masks[b, src, dst] * values[b, src, :]
    in f32, a slab of the batch at a time."""
    batch, side, _ = masks.shape
    out = torch.empty_like(values)
    step = _chunk(batch, side)
    for b0 in range(0, batch, step):
        b1 = min(b0 + step, batch)
        out[b0:b1] = torch.bmm(masks[b0:b1].transpose(1, 2).float(),
                               values[b0:b1])
    return out


def cbca_mxu(volume: torch.Tensor, arms: CrossArms, num_iterations: int,
             distance_threshold: int = 14, masks=None) -> torch.Tensor:
    """Aggregate an (H, W, D) f32 volume with bf16-rounded operands; pass
    ``masks=build_masks(arms)`` to share the stacks between calls."""
    if num_iterations == 0:
        return volume
    if volume.dtype != torch.float32:
        # the JAX round returns f32, so its loop takes f32 volumes only
        raise ValueError(f"cbca_mxu takes float32 volumes, got {volume.dtype}")
    horiz, vert = masks if masks is not None else build_masks(arms)
    inv_region = inverse_region_size(arms, distance_threshold)[..., None]
    for _ in range(num_iterations):
        vol16 = volume.to(torch.bfloat16).float()
        mid16 = _masked_sums(horiz, vol16).to(torch.bfloat16).float()
        # the vertical product is batched over columns: (W, H, D)
        out = _masked_sums(vert, mid16.transpose(0, 1).contiguous())
        volume = out.transpose(0, 1) * inv_region
    return volume.contiguous()
