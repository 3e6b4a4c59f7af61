"""Triplet patch sampling for Siamese training (the port's own copy of
mccnn_tpu/data/sampler.py).

Behavioral spec (reference: src/datagenerator.py:137-216):
  * Every batch comes from ONE image pair; the anchor pixel set starts as
    distinct rows x distinct columns (permutations) and each invalid anchor
    (GT disparity inf, or occluded: int(gt) > col) is resampled uniformly
    until valid.
  * Images are zero-padded by (patch-1)/2 so patches at borders exist.
  * positive column = (col - int(gt)) + U(-pos, pos), truncated to int,
    resampled while outside [0, W);
  * negative column = (col - int(gt)) +- U(neg_low, neg_high) (random
    sign), truncated, resampled while outside [0, W).

The per-sample loops of the reference are vectorized masked resampling
rounds over the batch. The numpy generator's draws are those of the JAX
package's sampler, call for call, so one seed gives the same batches bit
for bit; the native backend draws one seed per batch from that generator
and hands it to the same C++ library.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from mccnn_tpu_torch import native
from mccnn_tpu_torch.data.dataset import StereoDataset


class TripletSampler:
    """Draws (left, right_pos, right_neg) patch batches from a dataset."""

    def __init__(
        self,
        dataset: StereoDataset,
        patch_size: int = 11,
        dataset_pos: float = 0.5,
        dataset_neg_low: float = 1.5,
        dataset_neg_high: float = 6.0,
        seed: Optional[int] = None,
        backend: str = "numpy",
    ):
        """``backend``: "numpy" (default; vectorized host path), "native"
        (the C++ sampler in the repository's native/), or "auto" (native when
        the library is built). Both backends use the reference's
        permutation-proposal scheme (distinct initial rows/cols, uniform
        rejection resampling) — same sampling distribution, different RNG
        streams."""
        self.dataset = dataset
        self.patch_size = patch_size
        self.pos = dataset_pos
        self.neg_low = dataset_neg_low
        self.neg_high = dataset_neg_high
        self._rng = np.random.default_rng(seed)
        self._pointer = 0
        if backend == "auto":
            backend = "native" if native.available() else "numpy"
        elif backend == "native":
            if not native.ensure_built():
                raise RuntimeError("native sampler requested but not buildable")
        self.backend = backend

    def reset(self) -> None:
        self._pointer = 0
        self.dataset.reshuffle()

    def _valid_anchors(self, gt, rows, cols, height, width):
        """Resample invalid anchors until every one is valid.

        Unlike the reference (which loops forever on a GT map with no
        valid pixels), this raises once resampling clearly can't succeed.
        """
        rounds = 0
        while True:
            invalid = ~np.isfinite(gt[rows, cols])
            gt_int = np.where(invalid, 0, gt[rows, cols]).astype(np.int64)
            invalid |= gt_int > cols
            if not invalid.any():
                return rows, cols
            rounds += 1
            if rounds > 16 * height * width:
                raise ValueError(
                    "no valid (finite, non-occluded) anchor pixels in the "
                    "ground-truth disparity map"
                )
            rows = np.where(invalid, self._rng.integers(0, height, size=rows.shape), rows)
            cols = np.where(invalid, self._rng.integers(0, width, size=cols.shape), cols)

    def _jittered_columns(self, base, width, low, high, signed):
        """base + jitter, truncated toward zero, rejected outside [0, W)."""
        out = np.full(base.shape, -1, dtype=np.int64)
        todo = np.ones(base.shape, dtype=bool)
        while todo.any():
            jitter = self._rng.uniform(low, high, size=base.shape)
            if signed:
                sign = np.where(self._rng.integers(0, 2, size=base.shape) == 0, -1.0, 1.0)
                jitter = jitter * sign
            candidate = (base + jitter).astype(np.int64)
            ok = todo & (candidate >= 0) & (candidate < width)
            out = np.where(ok, candidate, out)
            todo &= ~ok
        return out

    def next_batch(self, batch_size: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        left, right, gt = self.dataset.get(self._pointer)
        self._pointer = (self._pointer + 1) % len(self.dataset)
        height, width = left.shape
        if self.backend == "native":
            return self._next_batch_native(left, right, gt, batch_size)
        if height < batch_size or width < batch_size:
            raise ValueError(
                f"image {height}x{width} smaller than batch size {batch_size} "
                "(anchor rows/cols are drawn as permutations)"
            )

        rows = self._rng.permutation(height)[:batch_size]
        cols = self._rng.permutation(width)[:batch_size]
        rows, cols = self._valid_anchors(gt, rows, cols, height, width)

        base = cols - gt[rows, cols].astype(np.int64)
        pos_cols = self._jittered_columns(base, width, -self.pos, self.pos, False)
        neg_cols = self._jittered_columns(
            base, width, self.neg_low, self.neg_high, True
        )

        radius = (self.patch_size - 1) // 2
        left_pad = np.pad(left, radius)
        right_pad = np.pad(right, radius)

        offsets = np.arange(self.patch_size)
        row_idx = rows[:, None, None] + offsets[None, :, None]
        col_idx_l = cols[:, None, None] + offsets[None, None, :]
        col_idx_p = pos_cols[:, None, None] + offsets[None, None, :]
        col_idx_n = neg_cols[:, None, None] + offsets[None, None, :]

        patches_left = left_pad[row_idx, col_idx_l][..., None].astype(np.float32)
        patches_pos = right_pad[row_idx, col_idx_p][..., None].astype(np.float32)
        patches_neg = right_pad[row_idx, col_idx_n][..., None].astype(np.float32)
        return patches_left, patches_pos, patches_neg

    def _next_batch_native(self, left, right, gt, batch_size):
        seed = int(self._rng.integers(0, 2**63 - 1))
        rows, cols, pos_cols, neg_cols = native.sample_triplets(
            gt, batch_size, seed, self.pos, self.neg_low, self.neg_high
        )
        patches_left = native.extract_patches(left, rows, cols, self.patch_size)
        patches_pos = native.extract_patches(right, rows, pos_cols, self.patch_size)
        patches_neg = native.extract_patches(right, rows, neg_cols, self.patch_size)
        return (
            patches_left[..., None],
            patches_pos[..., None],
            patches_neg[..., None],
        )
