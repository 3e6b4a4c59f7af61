"""Image loading (mccnn_tpu/data/dataset.py).

Only ``load_grayscale`` so far: the training samplers wait for the training
slice of the port.
"""

from __future__ import annotations

import numpy as np


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
