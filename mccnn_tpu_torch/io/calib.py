"""Middlebury-v3 ``calib.txt`` parsing (copy of mccnn_tpu/io/calib.py).

The reference parser (reference: src/util.py:27-43) reads fixed line numbers
4/5/6 for ``width=``, ``height=`` and ``ndisp=``. We parse by key instead —
robust to line order — but fall back to the same fixed-line behavior when the
expected keys are absent, so every file the reference accepts, we accept.
"""

from __future__ import annotations

from typing import Tuple


def parse_calib(path: str) -> Tuple[int, int, int]:
    """Return ``(height, width, ndisp)`` from a Middlebury calib file."""
    with open(path) as f:
        lines = f.readlines()

    values = {}
    for line in lines:
        line = line.strip()
        if "=" not in line:
            continue
        key, _, val = line.partition("=")
        values[key.strip()] = val.strip()

    try:
        width = int(values["width"])
        height = int(values["height"])
        ndisp = int(values["ndisp"])
    except (KeyError, ValueError):
        # fixed-line fallback: lines 4/5/6 hold width/height/ndisp
        def after_eq(line: str) -> int:
            return int(line.strip()[line.strip().find("=") + 1:])

        width = after_eq(lines[4])
        height = after_eq(lines[5])
        ndisp = after_eq(lines[6])
    return height, width, ndisp
