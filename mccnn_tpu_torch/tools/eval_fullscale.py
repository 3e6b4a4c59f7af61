"""Per-family matching quality at full scale (mccnn_tpu's
tools/eval_fullscale.py on PyTorch).

Scores the port's matching pipeline at 1000 x 1504 (Middlebury half
resolution) on the five synthetic scene families of ``utils/scenes.py``
(translation, slanted plane, textureless patches, occlusion geometry and
photograph texture), whose ground truth is exact. Occluded pixels are not
scored (Middlebury's "nonocc" convention). Every family is matched at one
search range, ndisp = max-disparity + 2.

Two schedules: the serving path's fast one (bf16 volumes: the band kernel
K1, the CBCA round K2 and the SGM sweep K3 on the card) on every family,
and, on the first family, the exact one (f32 volumes built by matrix
products, K2 in f32, K3) as a cross-check that the fast schedule's quality
holds at scale.

Weights: ``--weights PATH`` reads any file ``models/params.py::load_any``
reads (either package's npz layouts, the reference's npy dict); ``--weights
random`` is ``init_params(0)``. A file that cannot be read raises: there is
no silent fallback to random weights.

Scoring: a non-finite predicted pixel counts as bad at every threshold
(``score``); ``utils/evaluate.py::evaluate_pair`` alone would score a NaN as
good. The ``photo`` family needs the photographs bundled with sklearn or
matplotlib; without them it is synthetic texture, and its row is labelled
``photo (synthetic)``.

    python -m mccnn_tpu_torch.tools.eval_fullscale --weights random \\
        [--height 1000 --width 1504 --max-disparity 160] [--noise 0.25] \\
        [--families translation,slanted] [--no-exact-crosscheck] \\
        [--device cpu]

Prints one line per scored run, then one JSON line with the weights, the
shape, the photo source and a row per run (family, mode, bad-0.5 to
bad-4.0, avg_err, the count of non-finite pixels).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

FAMILIES = ("translation", "slanted", "textureless", "occlusion", "photo")
THRESHOLDS = (0.5, 1.0, 2.0, 4.0)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description="per-family bad-N of the port at full scale")
    parser.add_argument("--height", type=int, default=1000)
    parser.add_argument("--width", type=int, default=1504)
    parser.add_argument("--max-disparity", type=int, default=160)
    parser.add_argument("--families", type=str, default=",".join(FAMILIES))
    parser.add_argument("--weights", type=str, required=True,
                        help="a weights file models.params.load_any reads, "
                             "or 'random' for init_params(0)")
    parser.add_argument("--no-exact-crosscheck", action="store_true")
    parser.add_argument("--noise", type=float, default=0.0,
                        help="gaussian image noise added to the scenes (the "
                             "training distribution of train_fullscale)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; a CUDA request with no card fails")
    return parser


def load_weights(spec: str):
    """``--weights`` -> (numpy params tree, label); 'random' is
    ``init_params(0)``. Raises when the file cannot be read."""
    from mccnn_tpu_torch.models.net import init_params
    from mccnn_tpu_torch.models.params import load_any

    if spec == "random":
        return init_params(0), "random init (init_params(0))"
    return load_any(spec), spec


def photo_source() -> str:
    """The bundled photographs the ``photo`` family reads, or why none."""
    from mccnn_tpu_torch.utils.scenes import _photo_paths

    paths = _photo_paths()
    return ", ".join(paths) if paths else "none: synthetic texture"


def eval_scene(family: str, index: int, height: int, width: int,
               max_disparity: int, noise: float):
    """The ``index``-th family's scene, standardized and with noise ->
    (left, right, gt) with gt ``inf`` where a pixel is occluded."""
    from mccnn_tpu_torch.utils.scenes import scene_pair

    rng = np.random.default_rng(1000 + index)
    left, right, gt, occluded, scene_ndisp = scene_pair(
        family, rng, height, width, max_disparity=max_disparity)
    if scene_ndisp > max_disparity + 2:
        raise ValueError(f"{family}: the scene needs ndisp {scene_ndisp}")
    if noise:
        left = (left + noise * rng.normal(size=left.shape)).astype(np.float32)
        right = (right + noise * rng.normal(size=right.shape)).astype(
            np.float32)
    gt_eval = gt.copy()
    gt_eval[occluded] = np.inf
    return left, right, gt_eval


def match_fast(net, left, right, ndisp: int):
    """The serving path's schedule: bf16 volumes, band kernel, K2, K3."""
    from mccnn_tpu_torch.pipeline.match import match_pair

    return match_pair(net, left, right, ndisp, volume_dtype="bfloat16")


def match_exact(net, left, right, ndisp: int):
    """The exact schedule: f32 volumes by matrix products, K2 in f32, K3."""
    from mccnn_tpu_torch.pipeline.match import match_pair

    return match_pair(net, left, right, ndisp, cbca_impl="xla",
                      cost_volume_method="matmul")


def score(disparity: np.ndarray, gt_eval: np.ndarray) -> dict:
    """``evaluate_pair``'s metrics with every non-finite prediction bad at
    every threshold (its error is set to twice the largest threshold), plus
    the count of such pixels under ``nonfinite``."""
    from mccnn_tpu_torch.utils.evaluate import evaluate_pair

    finite = np.isfinite(disparity)
    if not finite.all():
        beyond = np.where(np.isfinite(gt_eval),
                          gt_eval + 2 * max(THRESHOLDS), 0.0)
        disparity = np.where(finite, disparity, beyond).astype(np.float32)
    metrics = evaluate_pair(disparity, gt_eval)
    metrics["nonfinite"] = int((~finite).sum())
    return metrics


def evaluate(params, families, height: int, width: int, max_disparity: int,
             noise: float = 0.0, exact_crosscheck: bool = True,
             device: str = "cuda") -> list:
    """Score ``params`` on each family -> a list of result rows (dicts).

    The fast schedule runs on every family, the exact one on the first.
    ``photo`` is labelled ``photo (synthetic)`` when no bundled photograph
    is found.
    """
    import torch

    from mccnn_tpu_torch.models.net import params_from_numpy

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but CUDA is not "
                           "available")
    net = params_from_numpy(params).to(device)
    ndisp = max_disparity + 2  # one search range for every family
    synthetic_photo = photo_source().startswith("none")

    def run(schedule, left, right):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        start = time.perf_counter()
        disparity = schedule(net, left, right, ndisp).cpu().numpy()
        return disparity, time.perf_counter() - start

    rows = []
    for i, family in enumerate(families):
        left, right, gt_eval = eval_scene(family, i, height, width,
                                          max_disparity, noise)
        left, right = (torch.from_numpy(x).to(device) for x in (left, right))
        label = ("photo (synthetic)" if family == "photo" and synthetic_photo
                 else family)
        modes = [("fast-bf16", match_fast)]
        if i == 0 and exact_crosscheck:
            modes.append(("exact-f32", match_exact))
        for mode, schedule in modes:
            disparity, seconds = run(schedule, left, right)
            m = score(disparity, gt_eval)
            rows.append({"family": label, "mode": mode, **{
                key: m[key] for key in ("bad_0.5", "bad_1.0", "bad_2.0",
                                        "bad_4.0", "avg_err", "nonfinite")},
                "seconds": seconds})
            print(f"{label:>17} {mode}  bad2 {m['bad_2.0']:.4f}  bad1 "
                  f"{m['bad_1.0']:.4f}  avg {m['avg_err']:.3f}  non-finite "
                  f"{m['nonfinite']}  ({seconds:.2f} s incl. any first use)",
                  flush=True)
        if len(modes) == 2:
            delta = abs(rows[-1]["bad_2.0"] - rows[-2]["bad_2.0"])
            print(f"{label:>17} |bad2 delta| fast vs exact {delta:.4f}",
                  flush=True)
    return rows


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    params, weights = load_weights(args.weights)
    photos = photo_source()
    print(f"weights: {weights}", flush=True)
    print(f"photo source: {photos}", flush=True)
    rows = evaluate(params, args.families.split(","), args.height,
                    args.width, args.max_disparity, args.noise,
                    not args.no_exact_crosscheck, args.device)
    result = {
        "weights": weights,
        "shape": [args.height, args.width, args.max_disparity + 2],
        "device": args.device,
        "photo_source": photos,
        "results": rows,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
