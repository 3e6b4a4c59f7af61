"""Banded-block CBCA against the dense-mask products (the port of
tools/bench_cbca_banded.py, on the ``mxu`` CBCA).

``cbca_impl="mxu"`` (``ops/cbca_mxu.py``) sums each pixel's arms as a
product with a dense 0/1 mask, (W, W) per row and (H, H) per column, almost
all zeros beyond the arms' reach. ``banded_round`` keeps, for each block
of ``block`` columns (rows), only the three (block, block) mask blocks
that pair it with itself and its two neighbours: an arm of at most
``dist - 1`` pixels reaches no further when ``block >= dist - 1``. The
numerics are the dense round's: operands rounded to bf16, products summed
in f32 (the bf16-rounded values multiplied as f32 with TF32 off; the masks
are 0/1, so every product is exact), the horizontal sums rounded to bf16
once, ``inverse_region_size`` at the end.

    python -m mccnn_tpu_torch.tools.bench_cbca_banded

Times ``cbca_mxu(v, a, 1, 14)`` (its masks built in the call) and
``banded_round`` on a seeded 1000 x 1504 x 256 f32 volume with CUDA
events, one warm-up and ``ITERS`` calls each, and prints both, their peak
device memory, their max abs difference and the card (``nvidia-smi``'s
name and power limit). Needs a CUDA device.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

from mccnn_tpu_torch.ops.cbca import (
    CrossArms,
    _arm_stencil_sum,
    inverse_region_size,
)

SHAPE = (1000, 1504, 256)  # H, W, D_pad: the main path's volume
TAU, DIST = 0.02, 14
ITERS = 3


def random_inputs(device: torch.device):
    """The JAX tool's inputs: a normal (H, W) image, then a normal (H, W,
    D) f32 volume from ``np.random.default_rng(0)``."""
    height, width, _ = SHAPE
    rng = np.random.default_rng(0)
    image = rng.normal(size=(height, width)).astype(np.float32)
    volume = rng.normal(size=SHAPE).astype(np.float32)
    return (torch.from_numpy(image).to(device),
            torch.from_numpy(volume).to(device))


def _block_masks(neg: torch.Tensor, pos: torch.Tensor,
                 block: int) -> torch.Tensor:
    """(B, N / block, 3, block, block) bf16 from (B, N) arms: mask[b, i, s,
    a, c] = 1 iff source a of block i + s - 1 lies on the arm of
    destination c of block i."""
    batch, side = neg.shape
    index = torch.arange(block, dtype=torch.int32, device=neg.device)
    shift = torch.arange(3, dtype=torch.int32, device=neg.device)
    delta = ((shift[:, None, None] - 1) * block + index[None, :, None]
             - index[None, None, :])  # (3, a, c): source - destination
    neg = neg.reshape(batch, side // block, 1, 1, block).to(torch.int32)
    pos = pos.reshape(batch, side // block, 1, 1, block).to(torch.int32)
    return ((delta >= -neg) & (delta <= pos)).to(torch.bfloat16)


def _block_sums(masks: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """out[n, c, :] = sum over a of masks[n, a, c] * values[n, a, :] in
    f32, for bf16 masks and bf16-rounded values."""
    return torch.bmm(masks.transpose(1, 2).float(), values)


def banded_round(vol: torch.Tensor, arms: CrossArms, dist: int = 14,
                 block: int = 128) -> torch.Tensor:
    """One aggregation round of an (H, W, D) f32 volume with banded-block
    masks: three block-shifted batched products along the rows, then three
    along the columns. Needs ``block >= dist - 1``."""
    if block < dist - 1:
        raise ValueError(
            f"block {block} < dist - 1 = {dist - 1}: an arm would reach "
            "past the neighbouring block, which the masks do not hold")
    height, width, d_pad = vol.shape
    wb, hb = -(-width // block), -(-height // block)
    wp, hp = wb * block, hb * block

    def pad_plane(plane):
        return F.pad(plane, (0, wp - width, 0, hp - height))

    padded = CrossArms(*(pad_plane(arm) for arm in arms))
    mh = _block_masks(padded.left, padded.right, block)  # (hp, wb, 3, ...)
    nv = _block_masks(padded.up.T, padded.down.T, block)  # (wp, hb, 3, ...)
    inv_region = inverse_region_size(padded, dist)[..., None]

    # one bf16 copy padded by a block each side; the shifted block views
    # are its column ranges
    v16 = F.pad(vol.to(torch.bfloat16),
                (0, 0, block, wp - width + block, 0, hp - height))
    mid = None
    for s in range(3):
        shifted = v16[:, s * block: s * block + wp].to(
            torch.float32, memory_format=torch.contiguous_format)
        term = _block_sums(mh[:, :, s].reshape(hp * wb, block, block),
                           shifted.view(hp * wb, block, d_pad))
        mid = term if mid is None else mid + term

    m16 = F.pad(mid.view(hp, wp, d_pad).to(torch.bfloat16),
                (0, 0, 0, 0, block, block))
    del mid
    out = None
    for s in range(3):
        # (hb, block, wp, D) -> (wp, hb, block, D): batched over columns
        shifted = m16[s * block: s * block + hp].view(
            hb, block, wp, d_pad).permute(2, 0, 1, 3).to(
                torch.float32, memory_format=torch.contiguous_format)
        term = _block_sums(nv[:, :, s].reshape(wp * hb, block, block),
                           shifted.view(wp * hb, block, d_pad))
        out = term if out is None else out + term
    out = out.view(wp, hb, block, d_pad).permute(1, 2, 0, 3).reshape(
        hp, wp, d_pad) * inv_region
    return out[:height, :width]


def round_tolerance(vol: torch.Tensor, arms: CrossArms,
                    dist: int = 14) -> torch.Tensor:
    """Per element, how far two rounds of ``vol`` with bf16 operands and
    f32 sums taken in other orders (dense against banded, the port against
    JAX) may lie apart.

    The products are exact, so two horizontal sums differ by f32 rounding
    alone, and their bf16 roundings by that and at most one bf16 ulp of the
    sum. A result sums the rounded horizontal sums over its vertical arm in
    f32 and scales by 1 / |region|. The bound: those ulps summed over the
    arm, plus 8 (2 dist - 1) f32 ulps of the arm's sum of |operands| for
    the f32 roundings of both orders' horizontal and vertical sums, scaled.
    """
    operand = vol.to(torch.bfloat16).float()
    mid = _arm_stencil_sum(operand, arms.left, arms.right, 1, dist).abs()
    spread = _arm_stencil_sum(operand.abs(), arms.left, arms.right, 1, dist)
    # a sum just below a power of two may round up to it in the other order
    ulp = torch.exp2(torch.floor(torch.log2(mid * (1 + 2.0 ** -8))) - 7)
    flips = _arm_stencil_sum(ulp, arms.up, arms.down, 0, dist)
    magnitude = _arm_stencil_sum(spread, arms.up, arms.down, 0, dist)
    inv_region = inverse_region_size(arms, dist)[..., None]
    return (flips + (2 * dist - 1) * 2.0 ** -21 * magnitude) * inv_region


def timed(label: str, fn, card: str, iters: int = ITERS):
    """(ms a call over ``iters`` calls after one warm-up, with CUDA events;
    peak device GB above what was allocated before), printed beside the
    card."""
    from mccnn_tpu_torch.tools.bench_cbca_stream import _time_ms

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = _time_ms(fn, iters)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    print(f"{label:44s} {ms:9.2f} ms, peak {peak:.2f} GB above the inputs "
          f"[{card}]", flush=True)
    return ms, peak


def main() -> dict:
    """Time the dense and the banded round on the card; prints a line per
    measurement and returns the numbers."""
    from mccnn_tpu_torch.bench import device_label
    from mccnn_tpu_torch.models.net import disable_tf32
    from mccnn_tpu_torch.ops.cbca import compute_arms
    from mccnn_tpu_torch.ops.cbca_mxu import cbca_mxu

    if not torch.cuda.is_available():
        raise RuntimeError("bench_cbca_banded needs a CUDA device")
    device = torch.device("cuda")
    disable_tf32()
    card = device_label(device)
    image, vol = random_inputs(device)
    arms = compute_arms(image, TAU, DIST)

    dense_ms, dense_gb = timed("dense mxu x1",
                               lambda: cbca_mxu(vol, arms, 1, DIST), card)
    banded_ms, banded_gb = timed("banded-block mxu x1",
                                 lambda: banded_round(vol, arms, DIST), card)
    dense = cbca_mxu(vol, arms, 1, DIST)
    banded = banded_round(vol, arms, DIST)
    finite = bool(torch.isfinite(dense).all() and torch.isfinite(banded).all())
    error = (dense - banded).abs()
    del dense, banded
    tolerance = round_tolerance(vol, arms, DIST)
    within = bool((error <= tolerance).all())
    diff, largest = float(error.max()), float(tolerance.max())
    print(f"dense vs banded max abs diff: {diff} (within the per-element "
          f"tolerance {within}, its largest {largest}; finite {finite}) "
          f"[{card}]", flush=True)
    return {"tool": "bench_cbca_banded", "device": card,
            "shape": list(SHAPE), "dense_ms": dense_ms,
            "banded_ms": banded_ms, "dense_peak_gb": dense_gb,
            "banded_peak_gb": banded_gb, "max_abs_diff": diff,
            "within_tolerance": within, "largest_tolerance": largest,
            "finite": finite}


if __name__ == "__main__":
    main()
