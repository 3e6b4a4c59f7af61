"""ctypes binding of the native host sampler (mccnn_tpu/native/__init__.py).

Triplet sampling and patch extraction, the per-step host work of training,
have a C++ implementation in the repository's ``native/`` directory
(``host_sampler.cc``, built by ``native/Makefile`` into
``native/libmccnn_host.so``). The library lies outside both packages, so
the port loads it itself. ``ensure_built`` runs ``make -C native`` at first
use; ``available`` is False while the library is missing, and callers that
asked for the native backend explicitly raise then
(``data/sampler.py``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_LIB_NAME = "libmccnn_host.so"
_lib: Optional[ctypes.CDLL] = None


def _lib_path() -> str:
    return os.path.join(_NATIVE_DIR, _LIB_NAME)


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_lib_path()):
        return None
    lib = ctypes.CDLL(_lib_path())
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.mccnn_sample_triplets.restype = ctypes.c_int
    lib.mccnn_sample_triplets.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_uint64,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        i64p, i64p, i64p, i64p,
    ]
    lib.mccnn_extract_patches.restype = None
    lib.mccnn_extract_patches.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int64,
        i64p, i64p, ctypes.c_int64, ctypes.c_int64, f32p,
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def ensure_built() -> bool:
    """Compile the library if it is missing; returns availability."""
    if os.path.exists(_lib_path()):
        return available()
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError):
        return False
    return available()


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built; call ensure_built()")
    return lib


def sample_triplets(
    gt: np.ndarray,
    batch: int,
    seed: int,
    pos_dev: float,
    neg_low: float,
    neg_high: float,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Anchor rows and columns, positive and negative columns (the
    reference's rejection rules)."""
    lib = _require()
    gt = np.ascontiguousarray(gt, dtype=np.float32)
    height, width = gt.shape
    rows, cols, pos_cols, neg_cols = (np.empty(batch, dtype=np.int64)
                                      for _ in range(4))
    status = lib.mccnn_sample_triplets(
        _f32p(gt), height, width, batch, seed,
        pos_dev, neg_low, neg_high,
        _i64p(rows), _i64p(cols), _i64p(pos_cols), _i64p(neg_cols),
    )
    if status == 2:
        raise ValueError(
            f"batch {batch} exceeds image dims {height}x{width} (anchor "
            "proposals are drawn as distinct row/column permutations)")
    if status != 0:
        raise ValueError("no valid anchor pixels in ground-truth map")
    return rows, cols, pos_cols, neg_cols


def extract_patches(image: np.ndarray, rows: np.ndarray, cols: np.ndarray,
                    patch: int) -> np.ndarray:
    """Zero-padded patches centred on (rows, cols) -> (B, patch, patch)
    float32."""
    lib = _require()
    image = np.ascontiguousarray(image, dtype=np.float32)
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    if rows.shape != cols.shape or rows.ndim != 1:
        raise ValueError("rows and cols must be 1-D of one length")
    height, width = image.shape
    out = np.empty((len(rows), patch, patch), dtype=np.float32)
    lib.mccnn_extract_patches(
        _f32p(image), height, width,
        _i64p(rows), _i64p(cols), len(rows), patch, _f32p(out),
    )
    return out
