"""The plain reference of MC-CNN fast stereo matching, in plain PyTorch.

Zbontar & LeCun, JMLR 17 (2016), arXiv:1510.05970: the fast architecture
and the Middlebury post-processing chain

    features -> cost volume (+ border fills) -> CBCA (n1 rounds) -> SGM
    (4 chained sweeps) -> CBCA (n2 rounds) -> WTA, right volume first, then
    the left -> LR-consistency interpolation -> subpixel -> median ->
    bilateral.

Frozen copies of the plain versions that the port keeps beside its kernels
(band, CBCA round, SGM sweep) and of its torch-op stages (border fills,
arms, WTA, LR check, subpixel, filters), so that the comparison holds the
port to the same arithmetic: f32 sums in a fixed order, every stored volume
value in the configuration's volume type. This module imports torch and
numpy only. It runs in blocks so that it fits on one card beside nothing:
the band in blocks of rows, CBCA in blocks of disparity lanes (aggregation
is independent per disparity); SGM is a loop over lines.

``match(weights, biases, left, right, ndisp, match_config, bucket,
volume_dtype, device)`` takes host arrays and returns the host map.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

BIG_COST = 1e9
LANE = 128
L2_EPS = 1e-12
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# SGM sweep order of the chained mode: right, left, up, down
_DIRECTIONS = ((0, 1), (0, -1), (-1, 0), (1, 0))


# ---- features -------------------------------------------------------------

def features(weights, biases, image: torch.Tensor) -> torch.Tensor:
    """(H, W) image -> (H, W, 64) unit descriptors: VALID 3x3 convs on the
    zero-padded image, ReLU on all but the last, L2 normalization."""
    pad = sum(w.shape[-1] - 1 for w in weights) // 2
    x = F.pad(image, (pad, pad, pad, pad))[None, None]
    last = len(weights) - 1
    for i, (w, b) in enumerate(zip(weights, biases)):
        x = F.conv2d(x, w, b)
        if i < last:
            x = torch.maximum(x, x.new_zeros(()))
    x = x[0].permute(1, 2, 0)
    sq = torch.sum(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(torch.clamp(sq, min=L2_EPS))).contiguous()


# ---- cost volume ----------------------------------------------------------

def band(anchor: torch.Tensor, other: torch.Tensor, ndisp: int, d_pad: int,
         side: str, dtype: torch.dtype, row_chunk: int = 16) -> torch.Tensor:
    """One side's volume: cost[h, w, d] = -<anchor(w), other(w -+ d)> in
    f32, 0 where the match falls outside the image, BIG_COST on the lanes
    d >= ndisp, stored in ``dtype``."""
    height, width, _ = anchor.shape
    device = anchor.device
    cols = torch.arange(width, device=device)[:, None]
    disps = torch.arange(d_pad, device=device)[None, :]
    src = cols - disps if side == "left" else cols + disps
    index = src.clamp(0, width - 1)
    valid = cols >= disps if side == "left" else cols + disps < width
    a = anchor.float()
    o = other.float()
    out = torch.empty((height, width, d_pad), dtype=dtype, device=device)
    for h0 in range(0, height, row_chunk):
        h1 = min(h0 + row_chunk, height)
        corr = torch.bmm(a[h0:h1], o[h0:h1].transpose(1, 2))
        scores = torch.gather(corr, 2, index.expand(h1 - h0, width, d_pad))
        cost = torch.where(valid, -scores, 0.0)
        out[h0:h1] = torch.where(disps < ndisp, cost, BIG_COST).to(dtype)
    return out


def _fill_mean(cols: torch.Tensor, count: int, dtype: torch.dtype):
    total = cols.float().sum(dim=1)
    if dtype != torch.float32:
        total = total.to(dtype).float()
    return (total / count).to(dtype)


def border_fill_left(volume: torch.Tensor, ndisp: int) -> torch.Tensor:
    """In place, d = ndisp-1 .. 1: column d-1 takes, on lanes [d, ndisp),
    the mean of columns d .. d+2 (clipped at the edge)."""
    width = volume.shape[1]
    for d in range(ndisp - 1, 0, -1):
        hi = min(d + 3, width)
        volume[:, d - 1, d:ndisp] = _fill_mean(volume[:, d:hi, d:ndisp],
                                               hi - d, volume.dtype)
    return volume


def border_fill_right(volume: torch.Tensor, ndisp: int) -> torch.Tensor:
    """In place, d = ndisp-1 .. 1: column W-d takes, on lanes [d, ndisp),
    the mean of columns W-d-3 .. W-d-1 (clipped at the edge)."""
    width = volume.shape[1]
    for d in range(ndisp - 1, 0, -1):
        col = width - d
        lo = max(col - 3, 0)
        volume[:, col, d:ndisp] = _fill_mean(volume[:, lo:col, d:ndisp],
                                             col - lo, volume.dtype)
    return volume


# ---- cross-based cost aggregation ------------------------------------------

def compute_arms(image: torch.Tensor, intensity: float, distance: int):
    """(up, down, left, right) int32 arm lengths: grow while the endpoint
    is within ``intensity`` of the centre, at most ``distance - 1``."""

    def arm(dim: int, sign: int) -> torch.Tensor:
        size = image.shape[dim]
        coords = torch.arange(size, device=image.device)
        coords = coords[:, None] if dim == 0 else coords[None, :]
        length = torch.zeros(image.shape, dtype=torch.int32,
                             device=image.device)
        alive = torch.ones(image.shape, dtype=torch.bool, device=image.device)
        for offset in range(1, distance):
            neighbor = torch.roll(image, sign * offset, dims=dim)
            if sign > 0:
                in_bounds = coords - offset >= 0
            else:
                in_bounds = coords + offset < size
            alive = alive & in_bounds & (
                torch.abs(image - neighbor) < intensity)
            length = length + alive.to(torch.int32)
        return length

    return arm(0, +1), arm(0, -1), arm(1, +1), arm(1, -1)


def _arm_sum(volume: torch.Tensor, neg_arm: torch.Tensor,
             pos_arm: torch.Tensor, dim: int, distance: int) -> torch.Tensor:
    """sum over o in [-neg_arm(p), +pos_arm(p)] of volume[p + o along dim],
    in f32, in the order centre, +1, -1, +2, -2, ... (an f32 (H, W) plane
    or (H, W, C) block). A masked term adds 0."""
    radius = distance - 1
    pad = [0, 0] * volume.ndim
    at = 2 * (volume.ndim - 1 - dim)
    pad[at] = pad[at + 1] = radius
    padded = F.pad(volume, pad)
    size = volume.shape[dim]
    acc = volume.clone()
    for offset in range(1, distance):
        for arm, sign in ((pos_arm, +1), (neg_arm, -1)):
            gate = (arm >= offset).to(volume.dtype)
            if volume.ndim == 3:
                gate = gate[..., None]
            acc.addcmul_(padded.narrow(dim, radius + sign * offset, size),
                         gate)
    return acc


def inverse_region(arms, distance: int) -> torch.Tensor:
    """(H, W) f32 1 / |support region|."""
    up, down, left, right = arms
    h_count = (left + right + 1).float()
    return 1.0 / _arm_sum(h_count, up, down, 0, distance)


def cbca(volume: torch.Tensor, arms, iterations: int, distance: int,
         lanes: int = LANE) -> torch.Tensor:
    """``iterations`` rounds over cross regions, in place, ``lanes``
    disparities at a time; each round sums in f32 and stores in the
    volume's type."""
    if iterations == 0:
        return volume
    up, down, left, right = arms
    inv = inverse_region(arms, distance)[..., None]
    for d0 in range(0, volume.shape[2], lanes):
        block = volume[:, :, d0:d0 + lanes]
        for _ in range(iterations):
            horiz = _arm_sum(block.float(), left, right, 1, distance)
            total = _arm_sum(horiz, up, down, 0, distance)
            del horiz
            block = (total * inv).to(volume.dtype)
            del total
        volume[:, :, d0:d0 + lanes] = block
    return volume


# ---- semi-global matching ---------------------------------------------------

def _sweep(volume: torch.Tensor, left_image: torch.Tensor,
           right_image: torch.Tensor, choice: str, direction, cfg) -> None:
    """One DP sweep of ``volume`` in place, line by line:
    L(d,p) = C(d,p) + min(L(d,p-r), L(d+-1,p-r) + P1, min L(p-r) + P2)
    - min L(p-r), with P1, P2 divided by Q1 where one gradient test is
    large and by Q2 where both are; P1 / V on vertical sweeps."""
    rh, rw = direction
    vertical = rh != 0
    forward = (rh == 1) if vertical else (rw == 1)
    p1_base = cfg["sgm_p1"] / cfg["sgm_v"] if vertical else cfg["sgm_p1"]
    p2_base = cfg["sgm_p2"]
    inv_q1 = 1.0 / cfg["sgm_q1"]
    inv_q2 = 1.0 / cfg["sgm_q2"]
    self_image = left_image if choice == "L" else right_image
    other_image = right_image if choice == "L" else left_image

    def small(image):
        grad = torch.abs(image - torch.roll(image, (rh, rw), dims=(0, 1)))
        return grad < cfg["sgm_d"]

    small_d1, small_other = small(self_image), small(other_image)
    height, width, d_pad = volume.shape
    cols = torch.arange(width, device=volume.device)[:, None]
    disps = torch.arange(d_pad, device=volume.device)[None, :]
    if choice == "L":
        probe = cols - disps
        oor = probe < max(0, rw)
    else:
        probe = cols + disps
        oor = probe >= width + min(0, rw)
    index = probe.clamp(0, width - 1)

    lines = volume if vertical else volume.transpose(0, 1)
    size, perp = lines.shape[0], lines.shape[1]
    order = range(size) if forward else range(size - 1, -1, -1)
    big = torch.full((perp, 1), BIG_COST, dtype=torch.float32,
                     device=volume.device)
    prev = lines[order[0]].float()
    for s in order[1:]:
        if vertical:
            b1 = small_d1[s][:, None]
            b2 = oor | small_other[s][index]
        else:
            b1 = small_d1[:, s][:, None]
            b2 = oor[s][None, :] | small_other[:, index[s]]
        scale = torch.where(b1 & b2, 1.0,
                            torch.where(b1 | b2, inv_q1, inv_q2))
        p1 = p1_base * scale
        p2 = p2_base * scale
        cur = lines[s].float()
        min_prev = prev.amin(dim=1, keepdim=True)
        from_below = torch.cat([big, prev[:, :-1]], dim=1)
        from_above = torch.cat([prev[:, 1:], big], dim=1)
        neighbor = torch.minimum(from_below, from_above) + p1
        candidate = torch.minimum(torch.minimum(prev, neighbor),
                                  min_prev + p2)
        prev = cur + candidate - min_prev
        lines[s] = prev.to(volume.dtype)


def sgm(volume: torch.Tensor, left_image: torch.Tensor,
        right_image: torch.Tensor, choice: str, cfg) -> torch.Tensor:
    """The chained mode: four sweeps in place, one after another."""
    if cfg.get("sgm_paper_mode", False):
        raise ValueError("the reference covers the chained SGM mode only")
    for direction in _DIRECTIONS:
        _sweep(volume, left_image, right_image, choice, direction, cfg)
    return volume


# ---- post-processing ----------------------------------------------------------

def wta(volume: torch.Tensor) -> torch.Tensor:
    """The first disparity of least cost, as f32."""
    return torch.argmin(volume, dim=-1).to(torch.float32)


def _nearest_strict(values, seen, dim: int, toward_end: bool, bits=14):
    size = values.shape[dim]
    shape = [1, 1]
    shape[dim] = size
    iota = torch.arange(size, device=values.device).view(shape)
    packed = (iota << bits) | values.to(torch.int64)
    if toward_end:
        none = size << bits
        near = torch.where(seen, packed, none)
        near = torch.flip(torch.cummin(torch.flip(near, (dim,)), dim).values,
                          (dim,))
        near = torch.roll(near, -1, dims=dim)
        flags = (near < none) & (iota < size - 1)
    else:
        near = torch.where(seen, packed, -1)
        near = torch.cummax(near, dim).values
        near = torch.roll(near, 1, dims=dim)
        flags = (near >= 0) & (iota > 0)
    vals = torch.where(flags, near & ((1 << bits) - 1), 0)
    return vals.to(values.dtype), flags


def lr_check(left_disparity: torch.Tensor, right_disparity: torch.Tensor,
             ndisp: int) -> torch.Tensor:
    """Classify (0 match, 1 mismatch, 2 occlusion) and fill: mismatches
    take the median of the nearest matches in the 4 axis directions,
    occlusions the nearest match strictly to the right."""
    height, width = left_disparity.shape
    device = left_disparity.device
    cols = torch.arange(width, device=device)[None, :]
    d_left = left_disparity.to(torch.int64)
    no_corr = cols < d_left
    src = (cols - d_left).clamp(0, width - 1)
    d_right_at = torch.gather(right_disparity, 1, src)
    match = (~no_corr) & (torch.abs(d_left.float() - d_right_at) <= 1.0)
    r = right_disparity.to(torch.int64)
    mismatch = torch.zeros((height, width + 1), dtype=torch.bool,
                           device=device)
    rows = torch.arange(height, device=device)[:, None].expand(height, width)
    for k in (-1, 0, 1):
        d = r + k
        target = cols + d
        hit = (d >= 0) & (d < ndisp) & (target < width)
        mismatch.index_put_((rows, torch.where(hit, target, width)),
                            torch.ones((), dtype=torch.bool, device=device))
    mismatch = mismatch[:, :width]
    status = torch.where(match, 0, torch.where(mismatch, 1, 2))
    status = torch.where(no_corr, 2, status)

    is_match = status == 0
    right_v, right_f = _nearest_strict(left_disparity, is_match, 1, True)
    left_v, left_f = _nearest_strict(left_disparity, is_match, 1, False)
    down_v, down_f = _nearest_strict(left_disparity, is_match, 0, True)
    up_v, up_f = _nearest_strict(left_disparity, is_match, 0, False)
    vals = torch.stack([right_v, left_v, down_v, up_v], dim=-1)
    flags = torch.stack([right_f, left_f, down_f, up_f], dim=-1)
    count = flags.sum(dim=-1)
    ordered = torch.sort(torch.where(flags, vals, torch.inf), dim=-1).values
    lo = ((count - 1) // 2).clamp(0, 3)
    hi = (count // 2).clamp(0, 3)
    median = 0.5 * (torch.gather(ordered, -1, lo[..., None])[..., 0]
                    + torch.gather(ordered, -1, hi[..., None])[..., 0])
    mismatch_fill = torch.where(count > 0, median, left_disparity)
    occlusion_fill = torch.where(right_f, right_v, left_disparity)
    return torch.where(status == 0, left_disparity,
                       torch.where(status == 1, mismatch_fill,
                                   occlusion_fill))


def subpixel(disparity: torch.Tensor, volume: torch.Tensor,
             ndisp: int) -> torch.Tensor:
    """d - (C+ - C-) / (2 (C+ - 2C + C-)) in the volume's type; d kept at
    the range's edges and where the parabola is flat."""
    d_pad = volume.shape[-1]
    idx_minus = (disparity - 1.0).to(torch.int64)
    idx_center = disparity.to(torch.int64)
    idx_plus = (disparity + 1.0).to(torch.int64)
    keep = (idx_minus < 0) | (idx_plus >= ndisp)

    def fiber(idx):
        return torch.gather(volume, -1,
                            idx.clamp(0, d_pad - 1)[..., None])[..., 0]

    c_minus, c_center, c_plus = (fiber(idx_minus), fiber(idx_center),
                                 fiber(idx_plus))
    denom = 2.0 * (c_plus - 2.0 * c_center + c_minus)
    flat = denom == 0.0
    delta = torch.where(flat, 0.0,
                        (c_plus - c_minus) / torch.where(flat, 1.0, denom))
    return torch.where(keep, disparity, disparity - delta)


def _windows(x: torch.Tensor, size: int):
    height, width = x.shape
    rows = torch.arange(height, device=x.device)[:, None]
    cols = torch.arange(width, device=x.device)[None, :]
    r = (size - 1) // 2
    samples, valids = [], []
    for dh in range(-r, size - r):
        for dw in range(-r, size - r):
            samples.append(torch.roll(x, (-dh, -dw), dims=(0, 1)))
            valids.append((rows + dh >= 0) & (rows + dh < height)
                          & (cols + dw >= 0) & (cols + dw < width))
    return torch.stack(samples, dim=-1), torch.stack(valids, dim=-1)


def median(disparity: torch.Tensor, size: int) -> torch.Tensor:
    """The median of the window clipped at the border (an even count
    averages the two middle samples)."""
    samples, valid = _windows(disparity, size)
    k = samples.shape[-1]
    count = valid.sum(dim=-1)
    ordered = torch.sort(torch.where(valid, samples, torch.inf),
                         dim=-1).values
    lo = ((count - 1) // 2).clamp(0, k - 1)
    hi = (count // 2).clamp(0, k - 1)
    return 0.5 * (torch.gather(ordered, -1, lo[..., None])[..., 0]
                  + torch.gather(ordered, -1, hi[..., None])[..., 0])


def bilateral(image: torch.Tensor, disparity: torch.Tensor, size: int,
              sigma: float, threshold: float) -> torch.Tensor:
    """Gaussian of the spatial distance x the intensity mask
    |I(q) - I(p)| < threshold, normalized over the clipped window."""
    r = (size - 1) // 2
    norm1 = 1.0 / (np.sqrt(2.0 * np.pi) * sigma)
    norm2 = -1.0 / (2.0 * sigma * sigma)
    gauss = torch.tensor(
        [norm1 * np.exp(norm2 * (np.sqrt(dh * dh + dw * dw) ** 2))
         for dh in range(-r, size - r) for dw in range(-r, size - r)],
        dtype=torch.float32).to(disparity.device)
    disp_samples, valid = _windows(disparity, size)
    image_samples, _ = _windows(image, size)
    ok = torch.abs(image_samples - image[..., None]) < threshold
    weights = torch.where(valid & ok, gauss, 0.0)
    return (weights * disp_samples).sum(dim=-1) / weights.sum(dim=-1)


# ---- the pair -----------------------------------------------------------------

def _padded(image: np.ndarray, bucket: int) -> np.ndarray:
    height, width = image.shape
    pad = ((0, -height % bucket), (0, -width % bucket))
    return np.pad(image, pad, mode="edge") if any(p[1] for p in pad) else (
        image)


def match(weights, biases, left: np.ndarray, right: np.ndarray, ndisp: int,
          cfg: dict, bucket: int, volume_dtype: str, device) -> np.ndarray:
    """Standardized (H, W) host pair -> (H, W) host disparity map.

    The pair is edge-padded up to multiples of ``bucket`` and the map
    cropped back; ``cfg`` holds the MatchConfig fields. With a bf16 volume
    the descriptors are rounded to bf16 before the dot products.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    height, width = left.shape
    vdtype = _DTYPES[volume_dtype]
    d_pad = -(-ndisp // LANE) * LANE
    distance = int(cfg["cbca_distance"])
    with torch.no_grad():
        li = torch.from_numpy(_padded(left, bucket)).to(device)
        ri = torch.from_numpy(_padded(right, bucket)).to(device)
        if ndisp > li.shape[1]:
            raise ValueError("ndisp exceeds the image width")
        fl = features(weights, biases, li)
        fr = features(weights, biases, ri)
        if vdtype == torch.bfloat16:
            fl, fr = fl.to(torch.bfloat16), fr.to(torch.bfloat16)

        def process(volume, image, choice):
            arms = compute_arms(image, cfg["cbca_intensity"], distance)
            volume = cbca(volume, arms, cfg["cbca_num_iterations_1"],
                          distance)
            volume = sgm(volume, li, ri, choice, cfg)
            return cbca(volume, arms, cfg["cbca_num_iterations_2"], distance)

        right_volume = border_fill_right(
            band(fr, fl, ndisp, d_pad, "right", vdtype), ndisp)
        right_disparity = wta(process(right_volume, ri, "R"))
        del right_volume
        left_volume = border_fill_left(
            band(fl, fr, ndisp, d_pad, "left", vdtype), ndisp)
        left_volume = process(left_volume, li, "L")
        left_disparity = wta(left_volume)
        del fl, fr
        disparity = lr_check(left_disparity, right_disparity, ndisp)
        disparity = subpixel(disparity, left_volume, ndisp)
        del left_volume
        disparity = median(disparity, cfg["median_filter_size"])
        disparity = bilateral(li, disparity, cfg["bilateral_filter_size"],
                              cfg["blur_sigma"], cfg["blur_threshold"])
    return disparity.cpu().numpy()[:height, :width]
