"""Synthetic stereo scenes with exact ground truth, in five families.

(The port's own copy of mccnn_tpu/utils/scenes.py: the same arrays for the
same seed.)

No Middlebury data ships with the repository, so parity and quality
evaluation run on generated scenes. Beyond uniform ``np.roll``
translations, these families add the structures that stress the pipeline
the way real scenes do:

  * ``translation``  — fronto-parallel textured plane (the baseline case).
  * ``slanted``      — disparity varies linearly across the image
                       (stresses subpixel enhancement and SGM's P1 small-
                       slope penalty; no piecewise-constant shortcut works).
  * ``occlusion``    — textured background plus foreground rectangles at
                       higher disparity; background pixels next to each
                       foreground object's left edge are genuinely occluded
                       in the right view (stresses the LR consistency
                       classify/fill paths, reference:
                       src/process_functional.py:279-378).
  * ``textureless``  — textured plane with flat-intensity patches
                       (stresses CBCA arm growth at the full distance-14
                       crosses and SGM's propagation across ambiguity,
                       reference: src/process_functional.py:571-657).
  * ``photo``        — REAL photographic texture (photographs bundled with
                       installed packages — sklearn's china/flower,
                       matplotlib's grace_hopper) on a slanted plane with
                       occluding foreground boxes. The band-limited noise
                       octaves above approximate natural-image statistics;
                       this family uses actual camera images, so edge/
                       gradient statistics (which drive the CBCA intensity
                       test and SGM's D1/D2 penalty scaling, reference:
                       src/process_functional.py:503-541,571-657) are the
                       real thing. Falls back to synthetic texture if no
                       bundled photo can be found (flagged in the result).

Construction: the right view is the "world" texture; the left view samples
``left(y, x) = right(y, x - d(y, x))`` with linear subpixel interpolation,
so the left-view ground-truth disparity is exact by construction. For
occlusion scenes a z-buffer along each row marks left pixels whose
correspondence is hidden by a nearer surface; their ground truth is kept
(the reference's Middlebury GT also covers occluded pixels — they are what
the occlusion-fill path exists for) and the mask is returned separately.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

SCENE_FAMILIES = ("translation", "slanted", "occlusion", "textureless",
                  "photo")

# Real photographs that ship inside installed packages (no network, no
# Middlebury data in the repository). Loaded lazily, cached decoded.
_PHOTO_CACHE: Dict[str, np.ndarray] = {}


def _photo_paths() -> Tuple[str, ...]:
    import os

    paths = []
    try:
        import sklearn.datasets as _skd

        img_dir = os.path.join(os.path.dirname(_skd.__file__), "images")
        paths += [os.path.join(img_dir, "china.jpg"),
                  os.path.join(img_dir, "flower.jpg")]
    except Exception:  # pragma: no cover - environment-dependent
        pass
    try:
        import matplotlib

        paths.append(os.path.join(matplotlib.get_data_path(),
                                  "sample_data", "grace_hopper.jpg"))
    except Exception:  # pragma: no cover - environment-dependent
        pass
    return tuple(p for p in paths if os.path.exists(p))


def _load_photo(path: str) -> np.ndarray:
    """Decode to grayscale float32 in [0, 1] (cached)."""
    if path not in _PHOTO_CACHE:
        from PIL import Image

        with Image.open(path) as im:
            arr = np.asarray(im.convert("L"), np.float32) / 255.0
        _PHOTO_CACHE[path] = arr
    return _PHOTO_CACHE[path]


def _photo_texture(
    rng: np.random.Generator, height: int, width: int
) -> np.ndarray:
    """Real photographic texture of the requested size, or None.

    Mirror-tiles one bundled photograph (so tile seams are gradient-
    continuous — no fake step edges) to cover (height, width), then takes
    a random crop. The mirror period (2x the photo size, >= 854 px) is far
    beyond any disparity search range used here, so the repetition cannot
    create matching ambiguity inside a search window.
    """
    paths = _photo_paths()
    if not paths:
        return None
    photo = _load_photo(paths[int(rng.integers(len(paths)))])
    block = np.block([[photo, photo[:, ::-1]],
                      [photo[::-1, :], photo[::-1, ::-1]]])
    reps_y = -(-(height + block.shape[0]) // block.shape[0])
    reps_x = -(-(width + block.shape[1]) // block.shape[1])
    tiled = np.tile(block, (reps_y, reps_x))
    y0 = int(rng.integers(0, tiled.shape[0] - height + 1))
    x0 = int(rng.integers(0, tiled.shape[1] - width + 1))
    return tiled[y0: y0 + height, x0: x0 + width].astype(np.float32)


def _texture(rng: np.random.Generator, height: int, width: int) -> np.ndarray:
    """Band-limited texture with photographic-ish statistics.

    A sum of smoothed noise octaves: strong low-frequency structure (so
    CBCA intensity tests pass over real distances) plus fine detail (so
    matching is well-posed). Values roughly in [0, 1].
    """
    img = np.zeros((height, width), np.float32)
    for scale, amp in ((1, 0.15), (3, 0.35), (9, 0.5)):
        noise = rng.normal(size=(height // scale + 2, width // scale + 2))
        # bilinear upsample of coarse noise = smooth octave
        yy = np.linspace(0, noise.shape[0] - 1.001, height)
        xx = np.linspace(0, noise.shape[1] - 1.001, width)
        y0 = yy.astype(int)
        x0 = xx.astype(int)
        fy = (yy - y0)[:, None]
        fx = (xx - x0)[None, :]
        up = (
            noise[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
            + noise[np.ix_(y0 + 1, x0)] * fy * (1 - fx)
            + noise[np.ix_(y0, x0 + 1)] * (1 - fy) * fx
            + noise[np.ix_(y0 + 1, x0 + 1)] * fy * fx
        )
        img += amp * up.astype(np.float32)
    img -= img.min()
    peak = img.max()
    if peak > 0:
        img /= peak
    return img


def _sample_right(right: np.ndarray, disparity: np.ndarray) -> np.ndarray:
    """left(y, x) = right(y, x - d(y, x)), linear interp, edge clamp."""
    height, width = right.shape
    xs = np.arange(width, dtype=np.float32)[None, :] - disparity
    xs = np.clip(xs, 0.0, width - 1.001)
    x0 = xs.astype(int)
    frac = xs - x0
    rows = np.arange(height)[:, None]
    return (
        right[rows, x0] * (1 - frac) + right[rows, x0 + 1] * frac
    ).astype(np.float32)


def _occlusion_mask(disparity: np.ndarray) -> np.ndarray:
    """True where the left pixel's correspondence is hidden in the right
    view: another left pixel in the same row with strictly larger disparity
    maps to the same right column (z-buffer over x - d)."""
    height, width = disparity.shape
    mask = np.zeros((height, width), bool)
    for y in range(height):
        target = np.rint(np.arange(width) - disparity[y]).astype(int)
        best = {}
        for x in range(width):
            t = target[x]
            if t < 0:
                continue
            if t in best and abs(disparity[y, best[t]] - disparity[y, x]) > 0.5:
                if disparity[y, x] > disparity[y, best[t]]:
                    mask[y, best[t]] = True
                    best[t] = x
                else:
                    mask[y, x] = True
            else:
                best[t] = x
    return mask


def make_scene(
    family: str,
    rng: np.random.Generator,
    height: int = 64,
    width: int = 96,
    max_disparity: int = 10,
) -> Dict[str, np.ndarray]:
    """Build one scene; returns dict(left, right, gt, occluded, ndisp).

    ``left``/``right`` are unstandardized float32 (H, W) images in ~[0, 1]
    (callers standardize, matching reference: src/match.py:120-121);
    ``gt`` is the exact left-view disparity; ``occluded`` marks left pixels
    with no visible correspondence; ``ndisp`` is a valid search range
    (> max gt disparity).
    """
    if family == "photo":
        photo = _photo_texture(rng, height, width)
        right = photo if photo is not None else _texture(rng, height, width)
    else:
        right = _texture(rng, height, width)
    if family == "translation":
        shift = max(2, max_disparity - 2)
        disparity = np.full((height, width), float(shift), np.float32)
    elif family == "slanted":
        # disparity plane: left-to-right and slight top-to-bottom slope
        xx = np.arange(width, dtype=np.float32)[None, :] / max(1, width - 1)
        yy = np.arange(height, dtype=np.float32)[:, None] / max(1, height - 1)
        disparity = (2.0 + (max_disparity - 4) * xx + 1.5 * yy).astype(
            np.float32
        )
    elif family == "occlusion":
        disparity = np.full((height, width), 2.0, np.float32)
        for _ in range(3):
            h0 = int(rng.integers(0, height * 3 // 4))
            w0 = int(rng.integers(width // 8, width * 3 // 4))
            hh = int(rng.integers(height // 6, height // 3))
            ww = int(rng.integers(width // 6, width // 3))
            fg = float(rng.integers(max_disparity - 4, max_disparity - 1))
            disparity[h0: h0 + hh, w0: w0 + ww] = fg
            # foreground objects get their own texture so they are
            # matchable surfaces, not cutouts of the background
            right[h0: h0 + hh, w0: w0 + ww] = _texture(rng, hh, ww)[
                : min(hh, height - h0), : min(ww, width - w0)
            ]
    elif family == "photo":
        # slanted base plane (subpixel everywhere) + two occluding
        # foreground boxes, all textured with real photograph content
        xx = np.arange(width, dtype=np.float32)[None, :] / max(1, width - 1)
        yy = np.arange(height, dtype=np.float32)[:, None] / max(1, height - 1)
        disparity = (2.0 + (max_disparity - 6) * xx + 1.5 * yy).astype(
            np.float32
        )
        for _ in range(2):
            h0 = int(rng.integers(0, height * 3 // 4))
            w0 = int(rng.integers(width // 4, width * 3 // 4))
            hh = int(rng.integers(height // 6, height // 3))
            ww = int(rng.integers(width // 6, width // 3))
            hh = min(hh, height - h0)
            ww = min(ww, width - w0)
            lo = float(disparity[h0: h0 + hh, w0: w0 + ww].max()) + 2.0
            fg = float(rng.uniform(min(lo, max_disparity - 2.0),
                                   max_disparity - 1.0))
            disparity[h0: h0 + hh, w0: w0 + ww] = fg
            patch = _photo_texture(rng, hh, ww)
            right[h0: h0 + hh, w0: w0 + ww] = (
                patch if patch is not None else _texture(rng, hh, ww)
            )
    elif family == "textureless":
        shift = max(2, max_disparity - 2)
        disparity = np.full((height, width), float(shift), np.float32)
        for _ in range(3):
            h0 = int(rng.integers(0, height * 3 // 4))
            w0 = int(rng.integers(0, width * 3 // 4))
            hh = int(rng.integers(height // 6, height // 3))
            ww = int(rng.integers(width // 5, width // 2))
            right[h0: h0 + hh, w0: w0 + ww] = float(rng.uniform(0.3, 0.7))
    else:
        raise ValueError(f"unknown scene family: {family}")

    left = _sample_right(right, disparity)
    occluded = (
        _occlusion_mask(disparity)
        if family in ("occlusion", "photo")
        else np.zeros((height, width), bool)
    )
    # the left border (x < d) has no correspondence either
    xs = np.arange(width, dtype=np.float32)[None, :]
    occluded |= xs - disparity < 0
    ndisp = int(np.ceil(disparity.max())) + 2
    return {
        "left": left,
        "right": right.astype(np.float32),
        "gt": disparity,
        "occluded": occluded,
        "ndisp": ndisp,
    }


def standardize(image: np.ndarray) -> np.ndarray:
    """(x - mean) / std (reference: src/match.py:120-121)."""
    image = image.astype(np.float32)
    return (image - image.mean()) / image.std()


def scene_pair(
    family: str,
    rng: np.random.Generator,
    height: int = 64,
    width: int = 96,
    max_disparity: int = 10,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Standardized (left, right, gt, occluded, ndisp) tuple."""
    s = make_scene(family, rng, height, width, max_disparity)
    return (
        standardize(s["left"]),
        standardize(s["right"]),
        s["gt"],
        s["occluded"],
        s["ndisp"],
    )
