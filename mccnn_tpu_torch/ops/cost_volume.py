"""Disparity cost volumes (mccnn_tpu/ops/cost_volume.py).

  * left:  ``cost[h, w, d] = -<fL(h, w), fR(h, w - d)>``
  * right: ``cost[h, w, d] = -<fR(h, w), fL(h, w + d)>``

over 64-d unit descriptors, in ``(H, W, D_pad)`` volumes whose lanes
``d >= ndisp`` hold ``BIG_COST``. Entries with no correspondence are then
filled sequentially, in place, with the mean of the <= 3 nearest columns
(``border_fill``, the counterpart of ``_border_fill_left`` /
``_border_fill_right``): on a CUDA tensor kernel K11 (``csrc/border_fill.cu``,
one launch a side, bit-equal to the torch-op loop on the card), on a CPU
tensor that loop, ``border_fill_plain``. K11 replaces no TPU kernel: JAX
runs the fills as a ``lax.scan``.

``band_side`` is the wrapper of kernel K1 (``csrc/band.cu``, replacing
mccnn_tpu/ops/cost_volume_pallas.py::_band_kernel_mxu_one) and
``band_pair`` that of K5 (``csrc/band_pair.cu``, replacing
``_band_kernel_mxu``: both sides in one launch): on a CUDA tensor they
launch the kernel, on a CPU tensor they run ``band_side_plain`` /
``band_pair_plain``. For bf16 volumes the caller passes bf16 descriptors
(the JAX pipeline casts them too); products of bf16 values are exact in
f32, and the correlation accumulates in f32 either way. On bf16
descriptors K1 multiplies on the tensor cores (``mma.sync``) and reads the
band off the correlation tile's diagonals, so only the order of the
64-term sum differs from the plain version's and from K5's: the stored
bf16 values lie within one ulp. On f32 descriptors K1 runs K5's block
routine (``csrc/band_tile.cuh``) one-sided, with its fmaf chain in channel
order, and K5 equals two K1 launches bit for bit.

``band_pair_pallas`` is the counterpart of the JAX package's function of
that name (mccnn_tpu/ops/cost_volume_pallas.py): with ``use_mxu=True`` it
routes to K1 / K5; with ``use_mxu=False`` it runs kernel K6
(``csrc/band_vpu.cu``, replacing ``_band_kernel``, the bitwise-f32 path) and
returns both raw score bands: no negation, no ``BIG_COST`` lanes, 0 where
the match falls outside the image. On f32 descriptors K6 accumulates with
K5's fmaf chain, so ``-K6 == K5(ndisp=d_pad)`` bit for bit.

``cost_volume_pair(method=...)``: "auto" and "pallas" run the kernels (K1
for one side, K5 for both); "matmul" and "rolldot" are the JAX package's
XLA paths as torch ops, on any device: ``_scores_matmul`` (the plain band's
own correlation, the counterpart of ``_left_scores_matmul``) or
``_left_scores_rolldot``, then ``_right_from_left``.
"""

from __future__ import annotations

import torch

from mccnn_tpu_torch.kernels.build import (
    LAUNCHES,
    check,
    library,
    require_cuda,
    stream_handle,
)
from mccnn_tpu_torch.ops.common import BIG_COST, pad_disparities

_STORAGE = (torch.float32, torch.bfloat16)


def _scores_matmul(anchor: torch.Tensor, other: torch.Tensor, d_pad: int,
                   side: str, row_chunk: int = 8) -> torch.Tensor:
    """Raw f32 scores of one side by row-block (W, W) correlation matmuls
    and a banded gather: ``scores[h, u, d] = corr[h, u, clip(v)]`` with
    ``corr[h, u, v] = <anchor(h, u), other(h, v)>`` and ``v = u - d``
    (left) or ``v = u + d`` (right). The caller masks the clipped entries.
    """
    height, width, _ = anchor.shape
    device = anchor.device
    cols = torch.arange(width, device=device)[:, None]
    disps = torch.arange(d_pad, device=device)[None, :]
    src = cols - disps if side == "left" else cols + disps  # (W, D)
    index = src.clamp(0, width - 1)
    a = anchor.float()
    o = other.float()
    scores = torch.empty((height, width, d_pad), dtype=torch.float32,
                         device=device)
    for h0 in range(0, height, row_chunk):
        h1 = min(h0 + row_chunk, height)
        corr = torch.bmm(a[h0:h1], o[h0:h1].transpose(1, 2))
        scores[h0:h1] = torch.gather(
            corr, 2, index.expand(h1 - h0, width, d_pad))
    return scores


def band_side_plain(anchor: torch.Tensor, other: torch.Tensor, ndisp: int,
                    d_pad: int, side: str, dtype: torch.dtype) -> torch.Tensor:
    """Finalized band of one side: the negated scores, 0 where the match
    falls outside the image and ``BIG_COST`` on the pad lanes."""
    width = anchor.shape[1]
    cols = torch.arange(width, device=anchor.device)[:, None]
    disps = torch.arange(d_pad, device=anchor.device)[None, :]
    valid = cols >= disps if side == "left" else cols + disps < width
    scores = _scores_matmul(anchor, other, d_pad, side)
    cost = torch.where(valid, -scores, 0.0)
    return torch.where(disps < ndisp, cost, BIG_COST).to(dtype)


def band_side(anchor: torch.Tensor, other: torch.Tensor, ndisp: int,
              d_pad: int, side: str, dtype: torch.dtype) -> torch.Tensor:
    """K1 wrapper: kernel on CUDA, ``band_side_plain`` on the CPU."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    if anchor.device.type == "cpu":
        return band_side_plain(anchor, other, ndisp, d_pad, side, dtype)
    require_cuda("anchor features", anchor, (dtype,))
    require_cuda("other features", other, (dtype,))
    if dtype not in _STORAGE:
        raise ValueError(f"unsupported volume dtype {dtype}")
    height, width, channels = anchor.shape
    if other.shape != anchor.shape or channels != 64 or d_pad % 128:
        raise ValueError(
            f"band kernel takes two (H, W, 64) fields and D_pad % 128 == 0; "
            f"got {tuple(anchor.shape)}, {tuple(other.shape)}, D_pad {d_pad}"
        )
    out = torch.empty((height, width, d_pad), dtype=dtype,
                      device=anchor.device)
    code = library().mccnn_band_side(
        anchor.data_ptr(), other.data_ptr(), out.data_ptr(), height, width,
        channels, d_pad, ndisp, int(side == "right"),
        int(dtype == torch.bfloat16), stream_handle(anchor),
    )
    check(code, "band_side")
    LAUNCHES.add("band_side")
    return out


def band_pair_plain(features_left: torch.Tensor,
                    features_right: torch.Tensor, ndisp: int, d_pad: int,
                    dtype: torch.dtype):
    """Both finalized bands, (left, right), by the plain one-side version."""
    return (
        band_side_plain(features_left, features_right, ndisp, d_pad, "left",
                        dtype),
        band_side_plain(features_right, features_left, ndisp, d_pad, "right",
                        dtype),
    )


def band_pair(features_left: torch.Tensor, features_right: torch.Tensor,
              ndisp: int, d_pad: int, dtype: torch.dtype):
    """K5 wrapper: one launch writes both bands on CUDA; ``band_pair_plain``
    on the CPU. Returns (left, right)."""
    if features_left.device.type == "cpu":
        return band_pair_plain(features_left, features_right, ndisp, d_pad,
                               dtype)
    require_cuda("left features", features_left, (dtype,))
    require_cuda("right features", features_right, (dtype,))
    if dtype not in _STORAGE:
        raise ValueError(f"unsupported volume dtype {dtype}")
    height, width, channels = features_left.shape
    if (features_right.shape != features_left.shape or channels != 64
            or d_pad % 128):
        raise ValueError(
            f"band kernel takes two (H, W, 64) fields and D_pad % 128 == 0; "
            f"got {tuple(features_left.shape)}, "
            f"{tuple(features_right.shape)}, D_pad {d_pad}"
        )
    left = torch.empty((height, width, d_pad), dtype=dtype,
                       device=features_left.device)
    right = torch.empty_like(left)
    code = library().mccnn_band_pair(
        features_left.data_ptr(), features_right.data_ptr(), left.data_ptr(),
        right.data_ptr(), height, width, channels, d_pad, ndisp,
        int(dtype == torch.bfloat16), stream_handle(features_left),
    )
    check(code, "band_pair")
    LAUNCHES.add("band_pair")
    return left, right


def band_pair_scores_plain(features_left: torch.Tensor,
                           features_right: torch.Tensor, d_pad: int,
                           out_dtype: torch.dtype = torch.float32):
    """Both raw score bands, (left, right): f32 correlations, 0 where the
    match falls outside the image, cast to ``out_dtype`` (K6's plain
    version)."""
    width = features_left.shape[1]
    cols = torch.arange(width, device=features_left.device)[:, None]
    disps = torch.arange(d_pad, device=features_left.device)[None, :]
    left = torch.where(
        cols >= disps,
        _scores_matmul(features_left, features_right, d_pad, "left"), 0.0)
    right = torch.where(
        cols + disps < width,
        _scores_matmul(features_right, features_left, d_pad, "right"), 0.0)
    return left.to(out_dtype), right.to(out_dtype)


def band_pair_scores(features_left: torch.Tensor,
                     features_right: torch.Tensor, d_pad: int,
                     out_dtype: torch.dtype = torch.float32):
    """K6 wrapper: one launch writes both raw score bands on CUDA;
    ``band_pair_scores_plain`` on the CPU. Returns (left, right).

    The kernel multiplies f32 descriptors (any other type is cast up) and
    takes any depth; ``out_dtype`` is float32 or bfloat16.
    """
    if out_dtype not in _STORAGE:
        raise ValueError(f"unsupported band dtype {out_dtype}")
    if features_left.device.type == "cpu":
        return band_pair_scores_plain(features_left, features_right, d_pad,
                                      out_dtype)
    features_left = features_left.float().contiguous()
    features_right = features_right.float().contiguous()
    require_cuda("left features", features_left, (torch.float32,))
    require_cuda("right features", features_right, (torch.float32,))
    height, width, channels = features_left.shape
    if (features_right.shape != features_left.shape or channels != 64
            or d_pad < 1):
        raise ValueError(
            f"band kernel takes two (H, W, 64) fields and D_pad >= 1; got "
            f"{tuple(features_left.shape)}, {tuple(features_right.shape)}, "
            f"D_pad {d_pad}")
    left = torch.empty((height, width, d_pad), dtype=out_dtype,
                       device=features_left.device)
    right = torch.empty_like(left)
    code = library().mccnn_band_scores(
        features_left.data_ptr(), features_right.data_ptr(), left.data_ptr(),
        right.data_ptr(), height, width, channels, d_pad,
        int(out_dtype == torch.bfloat16), stream_handle(features_left),
    )
    check(code, "band_scores")
    LAUNCHES.add("band_scores")
    return left, right


def band_pair_pallas(features_left: torch.Tensor,
                     features_right: torch.Tensor, d_pad: int,
                     use_mxu: bool = True, sides: str = "both",
                     out_dtype: torch.dtype | None = None,
                     finalize_ndisp: int | None = None):
    """(H, W, 64) feature pair -> score bands (H, W, d_pad), no border
    fills; the port of ``cost_volume_pallas.band_pair_pallas``.

    ``use_mxu=True`` runs K1 (``sides`` "left" / "right") or K5 ("both");
    ``use_mxu=False`` runs K6, both sides only. With ``finalize_ndisp`` the
    bands come out as pipeline cost volumes (negated, ``BIG_COST`` on the
    lanes d >= ndisp; K1 / K5 only); without it as raw scores. K1 and K5
    write finalized bands, so their raw scores are the negated finalized
    bands of ``ndisp = d_pad``, which is exact. ``out_dtype`` defaults to
    the features' dtype.
    """
    if finalize_ndisp is not None and not use_mxu:
        raise ValueError("finalize_ndisp requires the MXU kernels")
    if sides not in ("left", "right", "both"):
        raise ValueError(
            f"sides must be 'left', 'right' or 'both', got {sides!r}")
    out_dtype = out_dtype or features_left.dtype
    if not use_mxu:
        if sides != "both":
            raise ValueError("single-side bands require the MXU kernel")
        return band_pair_scores(features_left, features_right, d_pad,
                                out_dtype)
    ndisp = d_pad if finalize_ndisp is None else finalize_ndisp
    features_left = features_left.to(out_dtype)
    features_right = features_right.to(out_dtype)
    if sides == "both":
        bands = band_pair(features_left, features_right, ndisp, d_pad,
                          out_dtype)
    elif sides == "left":
        bands = (band_side(features_left, features_right, ndisp, d_pad,
                           "left", out_dtype),)
    else:
        bands = (band_side(features_right, features_left, ndisp, d_pad,
                           "right", out_dtype),)
    if finalize_ndisp is None:
        bands = tuple(-band for band in bands)
    return bands if sides == "both" else bands[0]


def _left_scores_rolldot(features_left: torch.Tensor,
                         features_right: torch.Tensor,
                         d_pad: int) -> torch.Tensor:
    """Scores <fL(h, w), fR(h, w - d)> by per-disparity shifted dot products
    (exact f32; columns w < d wrap and are masked by the caller)."""
    height, width, _ = features_left.shape
    left = features_left.float()
    right = features_right.float()
    volume = torch.zeros((height, width, d_pad), dtype=torch.float32,
                         device=left.device)
    for d in range(d_pad):
        shifted = torch.roll(right, d, dims=1)
        volume[:, :, d] = torch.sum(left * shifted, dim=-1)
    return volume


def _right_from_left(scores_left: torch.Tensor, ndisp: int) -> torch.Tensor:
    """rcv[h, w, d] = lcv[h, w + d, d] for w + d < W and d < ndisp, else 0
    (the dot product is symmetric: the right band is a shift of the left)."""
    height, width, d_pad = scores_left.shape
    device = scores_left.device
    cols = torch.arange(width, device=device)[:, None]
    disps = torch.arange(d_pad, device=device)[None, :]
    src = (cols + disps).clamp(0, width - 1)  # (W, D)
    gathered = torch.gather(scores_left, 1,
                            src.expand(height, width, d_pad))
    valid = (cols + disps < width) & (disps < ndisp)
    return torch.where(valid, gathered, 0.0)


def _cost_volume_pair_xla(features_left, features_right, ndisp, sides, dtype,
                          method):
    """The JAX package's XLA paths: scores, then fills, then negation."""
    width = features_left.shape[1]
    d_pad = pad_disparities(ndisp)
    device = features_left.device
    if method == "matmul":
        scores_left = _scores_matmul(features_left, features_right, d_pad,
                                     "left")
    else:
        scores_left = _left_scores_rolldot(features_left, features_right,
                                           d_pad)
    cols = torch.arange(width, device=device)[:, None]
    disps = torch.arange(d_pad, device=device)[None, :]
    real = disps < ndisp
    # zero the w < d band and the disparity padding before the fills
    scores_left = torch.where((cols >= disps) & real, scores_left,
                              0.0).to(dtype)
    big = torch.tensor(BIG_COST, dtype=dtype, device=device)
    out = []
    if sides != "left":
        scores_right = _right_from_left(scores_left, ndisp)
    if sides != "right":
        scores_left = border_fill(scores_left, ndisp, "left")
        out.append(torch.where(real, -scores_left, big))
    if sides != "left":
        scores_right = border_fill(scores_right, ndisp, "right")
        out.append(torch.where(real, -scores_right, big))
    return tuple(out) if sides == "both" else out[0]


def cost_volume_pair(features_left: torch.Tensor,
                     features_right: torch.Tensor, ndisp: int,
                     sides: str = "both", dtype: torch.dtype = torch.float32,
                     method: str = "auto"):
    """Border-filled, BIG_COST-padded cost volume(s), (H, W, D_pad).

    ``sides`` is "left", "right" or "both" (a (left, right) tuple).
    ``method`` "auto" or "pallas" runs the band kernels (K1 for one side,
    K5 for both; their plain versions on the CPU); "matmul" and "rolldot"
    are torch-op paths on any device.
    """
    width = features_left.shape[1]
    if ndisp > width:
        raise ValueError(f"ndisp ({ndisp}) must be <= image width ({width})")
    if sides not in ("left", "right", "both"):
        raise ValueError(
            f"sides must be 'left', 'right' or 'both', got {sides!r}")
    if method in ("matmul", "rolldot"):
        return _cost_volume_pair_xla(features_left, features_right, ndisp,
                                     sides, dtype, method)
    if method not in ("auto", "pallas"):
        raise ValueError(f"unknown cost-volume method: {method}")
    d_pad = pad_disparities(ndisp)
    if sides == "both":
        left, right = band_pair(features_left, features_right, ndisp, d_pad,
                                dtype)
        return (border_fill(left, ndisp, "left"),
                border_fill(right, ndisp, "right"))
    if sides == "left":
        volume = band_side(features_left, features_right, ndisp, d_pad,
                           "left", dtype)
        return border_fill(volume, ndisp, "left")
    volume = band_side(features_right, features_left, ndisp, d_pad, "right",
                       dtype)
    return border_fill(volume, ndisp, "right")


def _fill_mean(cols: torch.Tensor, count: int, dtype: torch.dtype):
    """Mean of ``count`` gathered columns (H, count, n) in JAX's rounding.

    The sum runs in f32 and is stored in the volume dtype before the f32
    division (jnp.sum of a bf16 block returns bf16). On the card torch
    divides by ``count`` as a product with its f32 reciprocal, which K11
    repeats (``csrc/border_fill.cu``).
    """
    total = cols.float().sum(dim=1)
    if dtype != torch.float32:
        total = total.to(dtype).float()
    return (total / count).to(dtype)


def border_fill_plain(volume: torch.Tensor, ndisp: int,
                      side: str) -> torch.Tensor:
    """In place, for d = ndisp-1 .. 1, on lanes [d, ndisp): "left", column
    d-1 gets the mean of columns d..d+2; "right", column W-d gets the mean
    of columns W-d-3..W-d-1 (clipped at the image edge). ndisp - 1
    dependent steps of torch ops."""
    width = volume.shape[1]
    for d in range(ndisp - 1, 0, -1):
        if side == "left":
            col, lo, hi = d - 1, d, min(d + 3, width)
        else:
            col = width - d
            lo, hi = max(col - 3, 0), col
        volume[:, col, d:ndisp] = _fill_mean(
            volume[:, lo:hi, d:ndisp], hi - lo, volume.dtype)
    return volume


def border_fill(volume: torch.Tensor, ndisp: int, side: str) -> torch.Tensor:
    """K11 wrapper: fills ``volume`` (H, W, D_pad) in place and returns it;
    kernel on CUDA, ``border_fill_plain`` on the CPU."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    if volume.device.type == "cpu":
        return border_fill_plain(volume, ndisp, side)
    require_cuda("volume", volume, _STORAGE)
    height, width, d_pad = volume.shape
    if ndisp < 2 or height == 0:
        return volume  # no step to take
    if ndisp > min(width, d_pad):
        raise ValueError(f"ndisp {ndisp} exceeds the volume's width {width} "
                         f"or depth {d_pad}")
    code = library().mccnn_border_fill(
        volume.data_ptr(), height, width, d_pad, ndisp, int(side == "right"),
        int(volume.dtype == torch.bfloat16), stream_handle(volume))
    check(code, "border_fill")
    LAUNCHES.add("border_fill")
    return volume
