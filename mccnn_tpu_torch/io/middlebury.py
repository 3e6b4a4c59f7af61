"""Middlebury-v3 submission artifacts and dataset path derivation (copy of
mccnn_tpu/io/middlebury.py).

Keeps the reference's file contracts (reference: src/match.py:46-54,94-110 and
src/util.py:50-86): per-scene output names ``disp0MCCNN.pfm`` /
``disp0MCCNN.pgm`` / ``timeMCCNN.txt``, right-image/GT/calib paths derived from
the left-image path by suffix substitution, and recursive output dirs.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

# dataset-layout suffix constants (reference: src/match.py:46-54)
LEFT_IMAGE_SUFFIX = "im0.png"
RIGHT_IMAGE_SUFFIX = "im1.png"
LEFT_GT_SUFFIX = "disp0GT.pfm"
RIGHT_GT_SUFFIX = "disp1GT.pfm"
CALIB_SUFFIX = "calib.txt"

OUT_PFM_FILE = "disp0MCCNN.pfm"
OUT_IMG_FILE = "disp0MCCNN.pgm"
OUT_TIME_FILE = "timeMCCNN.txt"


@dataclass(frozen=True)
class ScenePaths:
    """All input/output paths for one Middlebury scene."""

    left: str
    right: str
    calib: str
    gt_left: str
    out_pfm: str
    out_pgm: str
    out_time: str


def derive_scene_paths(
    left_path: str, data_dir: str, save_dir: str, tag: str
) -> ScenePaths:
    """Derive every per-scene path from the left-image path.

    Mirrors the suffix-substitution contract of the reference
    (reference: src/match.py:94-110): results land under
    ``{save_dir}/submit_{tag}/...`` and images under
    ``{save_dir}/submit_{tag}_imgs/...``, preserving the scene's relative
    directory structure below ``data_dir``.
    """
    left_path = left_path.strip()
    right = left_path.replace(LEFT_IMAGE_SUFFIX, RIGHT_IMAGE_SUFFIX)
    calib = left_path.replace(LEFT_IMAGE_SUFFIX, CALIB_SUFFIX)
    gt_left = left_path.replace(LEFT_IMAGE_SUFFIX, LEFT_GT_SUFFIX)

    save_res_dir = os.path.join(save_dir, f"submit_{tag}")
    save_img_dir = os.path.join(save_dir, f"submit_{tag}_imgs")

    res_dir = left_path.replace(data_dir, save_res_dir)
    img_dir = left_path.replace(data_dir, save_img_dir)
    res_dir = res_dir[: res_dir.rfind(LEFT_IMAGE_SUFFIX) - 1]
    img_dir = img_dir[: img_dir.rfind(LEFT_IMAGE_SUFFIX) - 1]

    return ScenePaths(
        left=left_path,
        right=right,
        calib=calib,
        gt_left=gt_left,
        out_pfm=os.path.join(res_dir, OUT_PFM_FILE),
        out_pgm=os.path.join(img_dir, OUT_IMG_FILE),
        out_time=os.path.join(res_dir, OUT_TIME_FILE),
    )


def ensure_dir(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def ensure_dirs(paths: ScenePaths) -> None:
    ensure_dir(os.path.dirname(paths.out_pfm))
    ensure_dir(os.path.dirname(paths.out_pgm))


def save_disparity_pgm(disparity: np.ndarray, path: str) -> None:
    """Save a disparity map as an 8-bit binary PGM image.

    The reference delegates to ``cv2.imwrite`` (reference: src/util.py:50-52),
    which clips+rounds float input to uint8 for PGM. We emit the same bytes
    without the cv2 dependency on this path.
    """
    if disparity.ndim != 2:
        raise ValueError(f"disparity map must be 2D, got {disparity.shape}")
    img = np.clip(np.rint(np.nan_to_num(disparity)), 0, 255).astype(np.uint8)
    height, width = img.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{width} {height}\n255\n".encode())
        f.write(img.tobytes())


def save_time_file(seconds: float, path: str) -> None:
    """Write the per-scene runtime file (Middlebury submission requirement)."""
    with open(path, "w") as f:
        f.write(f"{seconds}")
