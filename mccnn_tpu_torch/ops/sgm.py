"""Semi-global matching, 4 axis-aligned directions (mccnn_tpu/ops/sgm.py).

Per direction r in (right, left, up, down), a DP sweep

    L(d,p) = C(d,p) + min(L(d,p-r), L(d+-1,p-r) + P1, min_d' L(d',p-r) + P2)
                    - min_d' L(d',p-r)

with the first line in sweep order kept, BIG_COST beyond the disparity
edges, and adaptive penalties: P1 and P2 are divided by Q1 where exactly
one of the gradient tests D1 (own image) and D2 (other image at the
disparity-shifted column) is >= D, by Q2 where both are, and kept where
both are < D. Vertical sweeps use P1/V. Out-of-range D2 probes count as
small.

The default (``sgm_paper_mode=False``) is the reference's chained mode:
the four sweeps run one after another in place. The paper mode averages
four independent sweeps.

``sweep`` is the wrapper of kernel K3 (``csrc/sgm_sweep.cu``, replacing
mccnn_tpu/ops/sgm_pallas.py::_sweep_kernel and the XLA scan of
mccnn_tpu/ops/sgm.py::_sweep): on a CUDA tensor it launches the kernel,
on a CPU tensor it runs ``sweep_plain``, a Python loop over lines. Both
carry the previous line in f32, store each line in the volume dtype, and
add as JAX does: ``(cur + candidate) - min_prev``; pad lanes stay
>= 1e8 (one f32 ulp at 1e9 is 64).

``MatchConfig.sgm_u8`` (mccnn_tpu/ops/sgm_pallas.py::penalty_scale_u8 and
the TPU kernel's own interface, ``sweep_pallas(volume, scale_u8, ...)``):
the penalty scale of every element is precomputed per direction as a uint8
code volume (0, 1, 2 for 1, 1/Q1, 1/Q2) in the sweep-leading (S, P, D)
layout, and the sweep reads one byte per element instead of deriving the
scale from the two gradient planes. The predicate is the same, so the swept
volume is the same bit for bit. A code volume is as large as an int8 cost
volume; it is built and freed per direction.

A vertical sweep may run on a column shard of the volume (the sharded
matcher, ``parallel/sgm.py``): ``col0`` names the image column of the
volume's first column, and the images stay whole, so D1 is cut from the
sweep image's planes and every D2 probe reads the other image at its global
column with the global width's out-of-range test. ``col0 = 0`` with a volume
as wide as the images is the whole-image sweep, bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mccnn_tpu_torch.kernels.build import (
    LAUNCHES,
    check,
    library,
    require_cuda,
    stream_handle,
)
from mccnn_tpu_torch.ops.common import BIG_COST
from mccnn_tpu_torch.utils.config import MatchConfig

# sweep order matters in the chained mode: right, left, up, down
_DIRECTIONS = ((0, 1), (0, -1), (-1, 0), (1, 0))


def _penalty_bits(left_image: torch.Tensor, right_image: torch.Tensor,
                  choice: str, direction: Tuple[int, int], sgm_d: float):
    """(D1 < sgm_d) plane of the sweep image and (grad < sgm_d) plane of
    the other image, both bool (H, W).

    The gradients are wrapped differences with the previous pixel along
    the sweep, ``|I(h, w) - I(h - rh, w - rw)|`` (JAX's ``jnp.roll``); the
    wrapped line is the sweep's first, which is never updated.
    """
    rh, rw = direction
    self_image = left_image if choice == "L" else right_image
    other_image = right_image if choice == "L" else left_image

    def small(image):
        grad = torch.abs(image - torch.roll(image, (rh, rw), dims=(0, 1)))
        return grad < sgm_d

    return small(self_image), small(other_image)


def _probe(width: int, d_pad: int, choice: str, rw: int, device,
           col0: int = 0, image_width: int | None = None):
    """(W, D) probe columns w -+ d, clamped, and their out-of-range mask,
    for the volume columns ``col0 .. col0 + W - 1`` of an image
    ``image_width`` (default W) wide; both in image columns."""
    image_width = width if image_width is None else image_width
    cols = torch.arange(col0, col0 + width, device=device)[:, None]
    disps = torch.arange(d_pad, device=device)[None, :]
    if choice == "L":
        probe = cols - disps
        oor = probe < max(0, rw)
    else:
        probe = cols + disps
        oor = probe >= image_width + min(0, rw)
    return probe.clamp(0, image_width - 1), oor


def _columns(left_image: torch.Tensor, direction: Tuple[int, int],
             col0: int, width: int) -> None:
    """Check that a volume of ``width`` columns from ``col0`` on lies in
    the images, and that only a vertical sweep runs on a column shard."""
    image_width = left_image.shape[1]
    if col0 < 0 or col0 + width > image_width:
        raise ValueError(f"volume columns [{col0}, {col0 + width}) outside "
                         f"an image {image_width} wide")
    if direction[0] == 0 and (col0, width) != (0, image_width):
        raise ValueError("a horizontal sweep runs on whole rows only")


def _b2_line(small_other: torch.Tensor, index: torch.Tensor,
             oor: torch.Tensor, vertical: bool, line: int) -> torch.Tensor:
    """(perp, D) D2-small bits of one sweep line (see ``_probe``).

    A vertical sweep's line is row h (positions w, probes (h, w -+ d)); a
    horizontal sweep's line is column w (positions h, probes (h, w -+ d)).
    """
    if vertical:
        return oor | small_other[line][index]
    return oor[line][None, :] | small_other[:, index[line]]


def penalty_scale_u8(left_image: torch.Tensor, right_image: torch.Tensor,
                     choice: str, direction: Tuple[int, int], d_pad: int,
                     sgm_d: float, col0: int = 0,
                     width: int | None = None) -> torch.Tensor:
    """(S, P, D) uint8 penalty codes of one sweep direction: 0 where both
    gradient tests are small, 2 where neither is, 1 otherwise; the
    predicate of ``sweep_plain`` and of K3 (an out-of-range D2 probe counts
    as small). Vertical sweeps give (H, W, D), horizontal ones (W, H, D),
    the sweep axis leading. ``col0`` and ``width`` (default: the images')
    select the volume's columns of a column shard.
    """
    rh, rw = direction
    image_width = left_image.shape[1]
    width = image_width if width is None else width
    _columns(left_image, direction, col0, width)
    small_d1, small_other = _penalty_bits(left_image, right_image, choice,
                                          direction, sgm_d)
    small_d1 = small_d1[:, col0:col0 + width]
    index, oor = _probe(width, d_pad, choice, rw, left_image.device, col0,
                        image_width)
    b2 = oor | small_other[:, index]  # (H, W, D)
    codes = (~small_d1)[:, :, None].to(torch.uint8) + (~b2).to(torch.uint8)
    if rh == 0:
        codes = codes.transpose(0, 1)
    return codes.contiguous()


def _sweep_params(direction, config: MatchConfig):
    rh, rw = direction
    vertical = rh != 0
    forward = (rh == 1) if vertical else (rw == 1)
    p1 = config.sgm_p1 / config.sgm_v if vertical else config.sgm_p1
    return vertical, forward, p1, config.sgm_p2


def sweep_plain(vol_in: torch.Tensor, vol_out: torch.Tensor,
                left_image: torch.Tensor, right_image: torch.Tensor,
                choice: str, direction: Tuple[int, int],
                config: MatchConfig,
                codes: torch.Tensor | None = None, col0: int = 0) -> None:
    """One DP sweep of vol_in into vol_out (may alias vol_in), line by line.

    With ``codes`` (``penalty_scale_u8`` of this direction) the scale of a
    line is decoded from its codes instead of the gradient planes. A
    vertical sweep's volume may be the column shard from ``col0`` on."""
    vertical, forward, p1_base, p2_base = _sweep_params(direction, config)
    inv_q1 = 1.0 / config.sgm_q1
    inv_q2 = 1.0 / config.sgm_q2
    height, width, d_pad = vol_in.shape
    _columns(left_image, direction, col0, width)
    if codes is None:
        small_d1, small_other = _penalty_bits(left_image, right_image,
                                              choice, direction, config.sgm_d)
        small_d1 = small_d1[:, col0:col0 + width]
        index, oor = _probe(width, d_pad, choice, direction[1],
                            vol_in.device, col0, left_image.shape[1])
    # lines are rows (vertical) or columns (horizontal): views, no copies
    src = vol_in if vertical else vol_in.transpose(0, 1)
    dst = vol_out if vertical else vol_out.transpose(0, 1)
    size, perp = src.shape[0], src.shape[1]
    order = range(size) if forward else range(size - 1, -1, -1)
    big = torch.full((perp, 1), BIG_COST, dtype=torch.float32,
                     device=vol_in.device)

    first = order[0]
    prev = src[first].float()
    if vol_out.data_ptr() != vol_in.data_ptr():
        dst[first] = src[first]
    for s in order[1:]:
        if codes is None:
            b1 = (small_d1[s] if vertical else small_d1[:, s])[:, None]
            b2 = _b2_line(small_other, index, oor, vertical, s)
            scale = torch.where(b1 & b2, 1.0,
                                torch.where(b1 | b2, inv_q1, inv_q2))
        else:
            scale = torch.where(codes[s] == 0, 1.0,
                                torch.where(codes[s] == 1, inv_q1, inv_q2))
        p1 = p1_base * scale
        p2 = p2_base * scale
        cur = src[s].float()
        min_prev = prev.amin(dim=1, keepdim=True)
        from_below = torch.cat([big, prev[:, :-1]], dim=1)  # L(d-1)
        from_above = torch.cat([prev[:, 1:], big], dim=1)  # L(d+1)
        neighbor = torch.minimum(from_below, from_above) + p1
        candidate = torch.minimum(torch.minimum(prev, neighbor),
                                  min_prev + p2)
        prev = cur + candidate - min_prev
        dst[s] = prev.to(vol_out.dtype)


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def kernel_planes(left_image: torch.Tensor, right_image: torch.Tensor,
                  choice: str, direction: Tuple[int, int], d_pad: int,
                  sgm_d: float, col0: int = 0, width: int | None = None):
    """K3's two uint8 penalty planes, rows padded to multiples of 16 bytes,
    for a volume of ``width`` columns (default: the images') from image
    column ``col0`` on:

    * D1, (H, pitch1): the sweep image's small-gradient bits of the
      volume's columns [0, W);
    * D2, (H, pitch2): the other image's bits at column c + d_pad for probe
      column c (volume column c, image column col0 + c), 1 ("small")
      wherever the probe is out of the image's range (``_probe``), so
      columns -d_pad .. W + d_pad - 1 all read a defined bit.

    The kernel then needs no bounds test on a probe, and its 16-byte copies
    of a probe run stay inside the plane."""
    small_d1, small_other = _penalty_bits(left_image, right_image, choice,
                                          direction, sgm_d)
    height, image_width = small_d1.shape
    width = image_width if width is None else width
    _columns(left_image, direction, col0, width)
    device = small_d1.device
    d1 = torch.zeros((height, _round16(width)), dtype=torch.uint8,
                     device=device)
    d1[:, :width] = small_d1[:, col0:col0 + width]
    d2 = torch.ones((height, _round16(width + 2 * d_pad)), dtype=torch.uint8,
                    device=device)
    rw = direction[1]
    lo, hi = ((max(0, rw), image_width) if choice == "L"
              else (0, image_width + min(0, rw)))
    # the in-range image columns this shard's probes reach
    lo, hi = max(lo, col0 - d_pad), min(hi, col0 + width + d_pad)
    if lo < hi:
        d2[:, d_pad + lo - col0:d_pad + hi - col0] = small_other[:, lo:hi]
    return d1, d2


def sweep_cuda(vol_in: torch.Tensor, vol_out: torch.Tensor,
               left_image: torch.Tensor, right_image: torch.Tensor,
               choice: str, direction: Tuple[int, int],
               config: MatchConfig,
               codes: torch.Tensor | None = None, col0: int = 0) -> None:
    """Launch K3 for one sweep of vol_in into vol_out (may alias vol_in);
    with ``codes`` the kernel reads the penalty codes, else it derives the
    penalties from the images' gradient planes (``kernel_planes``). A
    vertical sweep's volume may be the column shard from ``col0`` on."""
    require_cuda("volume", vol_in, (torch.float32, torch.bfloat16))
    require_cuda("output volume", vol_out, (vol_in.dtype,))
    height, width, d_pad = vol_in.shape
    if vol_out.shape != vol_in.shape or d_pad not in (128, 256, 384, 512):
        raise ValueError(
            f"sgm sweep takes D_pad in 128..512 and matching volumes; got "
            f"{tuple(vol_in.shape)} -> {tuple(vol_out.shape)}")
    if left_image.shape[0] != height:
        raise ValueError("images and volume disagree in H")
    _columns(left_image, direction, col0, width)
    vertical, forward, p1_base, p2_base = _sweep_params(direction, config)
    if codes is None:
        d1, d2 = kernel_planes(left_image, right_image, choice, direction,
                               d_pad, config.sgm_d, col0, width)
        planes = (d1.data_ptr(), d2.data_ptr(), None)
        pitches = (d1.shape[1], d2.shape[1])
    else:
        require_cuda("penalty codes", codes, (torch.uint8,))
        lines = (height, width) if vertical else (width, height)
        if codes.shape != (*lines, d_pad):
            raise ValueError(
                f"penalty codes must be sweep-leading {(*lines, d_pad)}, "
                f"got {tuple(codes.shape)}")
        planes = (None, None, codes.data_ptr())
        pitches = (0, 0)
    code = library().mccnn_sgm_sweep(
        vol_in.data_ptr(), vol_out.data_ptr(), *planes, height, width,
        d_pad, int(vertical), int(forward), int(choice == "L"), *pitches,
        p1_base, p2_base, 1.0 / config.sgm_q1, 1.0 / config.sgm_q2,
        int(vol_in.dtype == torch.bfloat16), stream_handle(vol_in),
    )
    check(code, "sgm_sweep")
    LAUNCHES.add("sgm_sweep")


def sweep(vol_in, vol_out, left_image, right_image, choice, direction,
          config: MatchConfig, col0: int = 0) -> None:
    """K3 wrapper: kernel on CUDA, ``sweep_plain`` on the CPU. With
    ``config.sgm_u8`` the direction's code volume is built first and freed
    on return. A vertical sweep's volume may be the column shard from
    image column ``col0`` on (the images stay whole)."""
    codes = None
    if config.sgm_u8:
        codes = penalty_scale_u8(left_image, right_image, choice, direction,
                                 vol_in.shape[2], config.sgm_d, col0,
                                 vol_in.shape[1])
    fn = sweep_plain if vol_in.device.type == "cpu" else sweep_cuda
    fn(vol_in, vol_out, left_image, right_image, choice, direction, config,
       codes, col0)


def sgm(left_volume: torch.Tensor, right_volume: torch.Tensor,
        left_image: torch.Tensor, right_image: torch.Tensor, ndisp: int,
        config: MatchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """4-direction SGM of both (H, W, D) cost volumes (in place in the
    chained mode, as ``_sgm_one_volume``)."""
    left_out = _sgm_one_volume(left_volume, left_image, right_image, "L",
                               ndisp, config)
    right_out = _sgm_one_volume(right_volume, left_image, right_image, "R",
                                ndisp, config)
    return left_out, right_out


def _sgm_one_volume(volume: torch.Tensor, left_image: torch.Tensor,
                    right_image: torch.Tensor, choice: str, ndisp: int,
                    config: MatchConfig) -> torch.Tensor:
    """4-direction SGM of one (H, W, D) volume.

    The chained mode updates ``volume`` in place and returns it; the paper
    mode leaves it unchanged and returns the average of four new sweeps.
    """
    del ndisp  # the semantics live in the BIG_COST disparity padding
    if config.sgm_paper_mode:
        swept = []
        for direction in _DIRECTIONS:
            out = torch.empty_like(volume)
            sweep(volume, out, left_image, right_image, choice, direction,
                  config)
            swept.append(out)
        return (swept[0] + swept[1] + swept[2] + swept[3]) / 4.0
    for direction in _DIRECTIONS:
        sweep(volume, volume, left_image, right_image, choice, direction,
              config)
    return volume
