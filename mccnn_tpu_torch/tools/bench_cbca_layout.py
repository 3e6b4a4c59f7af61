"""CBCA as stencil ops in the (H, W, D) layout against (H, D, W) (the port
of tools/bench_cbca_layout.py).

``ops/cbca.py::cbca`` sums the arms as 2 x 13 gated shifted views a
direction over an (H, W, D) volume: a w-shift moves whole D-fibres.
``cbca_hdw`` is the same round with the volume transposed to (H, D, W),
so the w-shifts run along the contiguous last axis and the gates are (H,
1, W) planes; every element sees the same additions in the same order, so
the two agree bit for bit. Neither is a kernel the matcher launches
(``cbca_impl`` "auto", "xla" and "fused" run K2): the tool measures what
the plain torch-op round costs in either layout.

    python -m mccnn_tpu_torch.tools.bench_cbca_layout

Times ``cbca`` x1 and ``cbca_hdw`` x1 (one warm-up and three calls)
and ``cbca_hdw`` x16 (one warm-up and one call) on the banded tool's
seeded 1000 x 1504 x 256 f32 volume with CUDA events, and prints each,
their peak device memory, the two layouts' max abs difference after two
rounds and the card (``nvidia-smi``'s name and power limit). Needs a CUDA
device.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from mccnn_tpu_torch.ops.cbca import CrossArms, inverse_region_size


def cbca_hdw(volume: torch.Tensor, arms: CrossArms, iters: int,
             dist: int = 14) -> torch.Tensor:
    """``iters`` CBCA rounds of an (H, W, D) f32 volume computed in the
    (H, D, W) layout: one transpose in, w-shifts on the last axis, h-shifts
    on the first, one transpose out."""
    height, width, _ = volume.shape
    radius = dist - 1
    inv_region = inverse_region_size(arms, dist)[:, None, :]  # (H, 1, W)
    offsets = range(1, dist)
    gates_l = [(arms.left >= o)[:, None, :] for o in offsets]
    gates_r = [(arms.right >= o)[:, None, :] for o in offsets]
    gates_u = [(arms.up >= o)[:, None, :] for o in offsets]
    gates_d = [(arms.down >= o)[:, None, :] for o in offsets]

    vol = volume.permute(0, 2, 1).contiguous()  # (H, D, W)
    for _ in range(iters):
        pw = F.pad(vol, (radius, radius))
        mid = vol
        for o in offsets:
            mid = mid + torch.where(
                gates_r[o - 1], pw[..., radius + o: radius + o + width], 0.0)
            mid = mid + torch.where(
                gates_l[o - 1], pw[..., radius - o: radius - o + width], 0.0)
        ph = F.pad(mid, (0, 0, 0, 0, radius, radius))
        out = mid
        for o in offsets:
            out = out + torch.where(
                gates_d[o - 1], ph[radius + o: radius + o + height], 0.0)
            out = out + torch.where(
                gates_u[o - 1], ph[radius - o: radius - o + height], 0.0)
        vol = out * inv_region
    return vol.permute(0, 2, 1).contiguous()


def main() -> dict:
    """Time both layouts on the card; prints a line per measurement and
    returns the numbers."""
    from mccnn_tpu_torch.bench import device_label
    from mccnn_tpu_torch.ops.cbca import cbca, compute_arms
    from mccnn_tpu_torch.tools.bench_cbca_banded import (
        DIST,
        SHAPE,
        TAU,
        random_inputs,
        timed,
    )

    if not torch.cuda.is_available():
        raise RuntimeError("bench_cbca_layout needs a CUDA device")
    device = torch.device("cuda")
    card = device_label(device)
    image, vol = random_inputs(device)
    arms = compute_arms(image, TAU, DIST)

    hwd_ms, hwd_gb = timed("cbca torch ops (H,W,D) x1",
                           lambda: cbca(vol, arms, 1, DIST), card)
    hdw_ms, hdw_gb = timed("cbca torch ops (H,D,W) x1",
                           lambda: cbca_hdw(vol, arms, 1, DIST), card)
    hdw16_ms, _ = timed("cbca torch ops (H,D,W) x16",
                        lambda: cbca_hdw(vol, arms, 16, DIST), card, iters=1)
    a = cbca(vol, arms, 2, DIST)
    b = cbca_hdw(vol, arms, 2, DIST)
    finite = bool(torch.isfinite(a).all() and torch.isfinite(b).all())
    diff = float((a - b).abs().max())
    scale = float(a.abs().max())
    print(f"layout diff: {diff} (largest |value| {scale}, finite {finite})"
          f" [{card}]", flush=True)
    return {"tool": "bench_cbca_layout", "device": card,
            "shape": list(SHAPE), "hwd_ms": hwd_ms, "hdw_ms": hdw_ms,
            "hdw_x16_ms": hdw16_ms, "hwd_peak_gb": hwd_gb,
            "hdw_peak_gb": hdw_gb, "layout_diff": diff, "scale": scale,
            "finite": finite}


if __name__ == "__main__":
    main()
