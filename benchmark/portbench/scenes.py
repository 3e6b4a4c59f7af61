"""The scene pool: synthetic rectified pairs made from the seed.

A frozen copy of the port's scene families (``utils/scenes.py::make_scene``:
``translation``, ``slanted``, ``occlusion``, ``textureless``), rewritten in
torch so that the textures are drawn on the device in a few large calls.
The right view is a band-limited texture (three octaves of bilinearly
upsampled noise); the left view samples ``right(y, x - d(y, x))`` with
linear interpolation. Only the images are made: the benchmark compares
the program with the plain reference, not with the ground truth, so no
occlusion mask is built.

Each pair is standardized over the whole image, ``(x - mean) / std``, and
handed out as a host float32 array, as a user of ``MatchPipeline`` hands it.
"""

from __future__ import annotations

import numpy as np
import torch

FAMILIES = ("translation", "slanted", "occlusion", "textureless")


def _texture(gen: torch.Generator, height: int, width: int,
             device) -> torch.Tensor:
    """Values in [0, 1]: octaves of smoothed noise, coarse ones strongest."""
    img = torch.zeros((height, width), dtype=torch.float32, device=device)
    for scale, amp in ((1, 0.15), (3, 0.35), (9, 0.5)):
        rows, cols = height // scale + 2, width // scale + 2
        noise = torch.randn((rows, cols), generator=gen, device=device)
        yy = torch.linspace(0, rows - 1.001, height, device=device)
        xx = torch.linspace(0, cols - 1.001, width, device=device)
        y0 = yy.long()
        x0 = xx.long()
        fy = (yy - y0)[:, None]
        fx = (xx - x0)[None, :]
        up = (noise[y0][:, x0] * (1 - fy) * (1 - fx)
              + noise[y0 + 1][:, x0] * fy * (1 - fx)
              + noise[y0][:, x0 + 1] * (1 - fy) * fx
              + noise[y0 + 1][:, x0 + 1] * fy * fx)
        img += amp * up
    img -= img.min()
    peak = img.max()
    return img / torch.clamp(peak, min=1e-12)


def _sample_right(right: torch.Tensor, disparity: torch.Tensor):
    """left(y, x) = right(y, x - d(y, x)), linear interpolation, clamped."""
    height, width = right.shape
    xs = torch.arange(width, dtype=torch.float32,
                      device=right.device)[None, :] - disparity
    xs = torch.clamp(xs, 0.0, width - 1.001)
    x0 = xs.long()
    frac = xs - x0
    return (torch.gather(right, 1, x0) * (1 - frac)
            + torch.gather(right, 1, x0 + 1) * frac)


def _standardize(image: torch.Tensor) -> np.ndarray:
    image = image.double()
    return ((image - image.mean()) / image.std(correction=0)).float().cpu(
    ).numpy()


def make_pair(family: str, seed: int, index: int, height: int, width: int,
              max_disparity: int, device) -> tuple[np.ndarray, np.ndarray]:
    """One standardized (left, right) host pair of ``family``; the same
    seed and index give the same pair."""
    rng = np.random.default_rng([seed, index])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(2**62)))
    right = _texture(gen, height, width, device)
    xx = torch.arange(width, dtype=torch.float32,
                      device=device)[None, :] / max(1, width - 1)
    yy = torch.arange(height, dtype=torch.float32,
                      device=device)[:, None] / max(1, height - 1)
    shift = float(max(2, max_disparity - 2))
    if family == "translation":
        disparity = torch.full((height, width), shift, device=device)
    elif family == "slanted":
        disparity = 2.0 + (max_disparity - 4) * xx + 1.5 * yy
    elif family == "occlusion":
        disparity = torch.full((height, width), 2.0, device=device)
        for _ in range(3):
            h0 = int(rng.integers(0, height * 3 // 4))
            w0 = int(rng.integers(width // 8, width * 3 // 4))
            hh = int(rng.integers(height // 6, height // 3))
            ww = int(rng.integers(width // 6, width // 3))
            fg = float(rng.integers(max_disparity - 4, max_disparity - 1))
            disparity[h0:h0 + hh, w0:w0 + ww] = fg
            patch = _texture(gen, hh, ww, device)
            right[h0:h0 + hh, w0:w0 + ww] = patch[:min(hh, height - h0),
                                                  :min(ww, width - w0)]
    elif family == "textureless":
        disparity = torch.full((height, width), shift, device=device)
        for _ in range(3):
            h0 = int(rng.integers(0, height * 3 // 4))
            w0 = int(rng.integers(0, width * 3 // 4))
            hh = int(rng.integers(height // 6, height // 3))
            ww = int(rng.integers(width // 5, width // 2))
            right[h0:h0 + hh, w0:w0 + ww] = float(rng.uniform(0.3, 0.7))
    else:
        raise ValueError(f"unknown scene family {family!r}")
    left = _sample_right(right, disparity.expand(height, width))
    return _standardize(left), _standardize(right)
