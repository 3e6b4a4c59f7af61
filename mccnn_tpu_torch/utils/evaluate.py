"""Disparity-map evaluation (Middlebury bad-N metric); the port's own copy
of mccnn_tpu/utils/evaluate.py, unchanged in behaviour.

The reference has no quantitative evaluation (correctness was judged by
submitting artifacts, reference: README.md:31); BASELINE.md defines bad-2.0
parity as this build's correctness north-star, so the metric lives here.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def bad_n(
    disparity: np.ndarray, ground_truth: np.ndarray, threshold: float = 2.0
) -> float:
    """Fraction of valid-GT pixels whose error exceeds ``threshold``."""
    valid = np.isfinite(ground_truth)
    if not valid.any():
        return float("nan")
    err = np.abs(disparity - ground_truth)[valid]
    return float((err > threshold).mean())


def evaluate_counts(
    disparity: np.ndarray,
    ground_truth: np.ndarray,
    thresholds=(0.5, 1.0, 2.0, 4.0),
    mask: np.ndarray | None = None,
) -> Dict[str, object]:
    """Raw error counts for one scene, aggregable across scenes.

    ``mask`` (bool, same shape), when given, restricts scoring to True
    pixels — e.g. Middlebury's non-occluded mask (``mask0nocc.png == 255``).
    Invalid GT (inf/nan, the Middlebury "unknown" encoding) is always
    excluded. Returns pixel counts so a dataset aggregate can be
    pixel-weighted exactly (sum counts, then divide) instead of averaging
    per-scene rates.
    """
    valid = np.isfinite(ground_truth)
    if mask is not None:
        valid &= mask
    err = np.abs(disparity - ground_truth)[valid]
    return {
        "n_valid": int(err.size),
        "n_total": int(ground_truth.size),
        "bad": {float(t): int((err > t).sum()) for t in thresholds},
        "abs_sum": float(err.sum()),
        "sq_sum": float((err ** 2).sum()),
    }


def summarize_counts(counts: Dict[str, object]) -> Dict[str, float]:
    """Counts (one scene's, or an element-wise sum over scenes) -> rates."""
    n = counts["n_valid"]
    if n == 0:
        return {"coverage": 0.0}
    out = {f"bad_{t:g}": bad / n for t, bad in counts["bad"].items()}
    out["avg_err"] = counts["abs_sum"] / n
    out["rms_err"] = float(np.sqrt(counts["sq_sum"] / n))
    out["coverage"] = n / counts["n_total"]
    return out


def merge_counts(total: Dict[str, object], counts: Dict[str, object]) -> None:
    """Accumulate one scene's counts into a running total, in place."""
    if not total:
        total.update({"n_valid": 0, "n_total": 0, "abs_sum": 0.0,
                      "sq_sum": 0.0, "bad": dict.fromkeys(counts["bad"], 0)})
    total["n_valid"] += counts["n_valid"]
    total["n_total"] += counts["n_total"]
    total["abs_sum"] += counts["abs_sum"]
    total["sq_sum"] += counts["sq_sum"]
    for t, bad in counts["bad"].items():
        total["bad"][t] += bad


def evaluate_pair(
    disparity: np.ndarray, ground_truth: np.ndarray
) -> Dict[str, float]:
    valid = np.isfinite(ground_truth)
    err = np.abs(disparity - ground_truth)[valid]
    return {
        "bad_0.5": float((err > 0.5).mean()),
        "bad_1.0": float((err > 1.0).mean()),
        "bad_2.0": float((err > 2.0).mean()),
        "bad_4.0": float((err > 4.0).mean()),
        "avg_err": float(err.mean()),
        "rms_err": float(np.sqrt((err ** 2).mean())),
        "coverage": float(valid.mean()),
    }
