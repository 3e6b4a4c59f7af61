"""Stereo training dataset: image lists, loading, standardization
(the port's own copy of mccnn_tpu/data/dataset.py).

The list file holds left-image paths, one per line; right and GT paths
are derived by suffix substitution; all pairs are loaded into RAM as
grayscale, scaled by 1/255 and standardized per image; shuffling permutes
the pair order each epoch (reference: src/datagenerator.py:12-134).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from mccnn_tpu_torch.io.pfm import read_pfm


def load_grayscale(path: str) -> np.ndarray:
    """Read an image file as float32 grayscale (H, W) in [0, 255].

    Uses OpenCV when available (the reference's reader,
    reference: src/datagenerator.py:85) and PIL otherwise — cv2's grayscale
    conversion (BT.601) matches PIL's 'L' mode weights.
    """
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(path)
        return img.astype(np.float32)
    except ImportError:
        from PIL import Image

        with Image.open(path) as img:
            return np.asarray(img.convert("L"), dtype=np.float32)


def standardize(image: np.ndarray) -> np.ndarray:
    return (image - image.mean()) / image.std()


class StereoDataset:
    """Prefetched (left, right, gt) triplets with epoch shuffling."""

    def __init__(
        self,
        left_list_file: str,
        shuffle: bool = False,
        left_suffix: str = "im0.png",
        right_suffix: str = "im1.png",
        gt_suffix: str = "disp0GT.pfm",
        seed: Optional[int] = None,
        scale_255: bool = True,
    ):
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

        with open(left_list_file) as f:
            left_paths = [line.strip() for line in f if line.strip()]
        self.left_paths = left_paths
        self.right_paths = [p.replace(left_suffix, right_suffix)
                            for p in left_paths]
        self.gt_paths = [p.replace(left_suffix, gt_suffix) for p in left_paths]

        self._lefts: List[np.ndarray] = []
        self._rights: List[np.ndarray] = []
        self._gts: List[np.ndarray] = []
        scale = 255.0 if scale_255 else 1.0
        for lp, rp, gp in zip(self.left_paths, self.right_paths,
                              self.gt_paths):
            self._lefts.append(standardize(load_grayscale(lp) / scale))
            self._rights.append(standardize(load_grayscale(rp) / scale))
            self._gts.append(read_pfm(gp))

        self._order = np.arange(len(left_paths))
        if self.shuffle:
            self._order = self._rng.permutation(len(left_paths))
        self._pointer = 0

    def __len__(self) -> int:
        return len(self.left_paths)

    def get(self, index: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        i = int(self._order[index])
        return self._lefts[i], self._rights[i], self._gts[i]

    def reshuffle(self) -> None:
        """New epoch order (reference: src/datagenerator.py:127-134)."""
        if self.shuffle:
            self._order = self._rng.permutation(len(self.left_paths))
        self._pointer = 0

    def next_pair(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Sequential (left, right, gt) iteration with an internal pointer;
        raises IndexError past the end, ``reshuffle()`` resets it."""
        if self._pointer >= len(self):
            raise IndexError("dataset exhausted; call reshuffle()")
        triple = self.get(self._pointer)
        self._pointer += 1
        return triple
