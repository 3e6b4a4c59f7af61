"""The port's matching pipeline against the reference-semantics oracle
chain on synthetic scenes with known disparity (mccnn_tpu's
tools/parity_eval.py on PyTorch).

The oracle chain is the loop-based NumPy re-implementation of every stage
of the reference's pipeline in ``tests/oracles.py`` (checked against the
executed reference, PARITY.md); it is loaded from the checkout by path, so
this tool runs from a checkout of the repository. For each scene it
scores three disparity maps against the ground truth: the oracle chain on
the port's features (``oracle``), the port with exact f32 CBCA
(``ours-exact``: K2 and K3 on the card) and with the banded-matrix CBCA
(``ours-mxu``). Three textured shifts at 28 x 44 and four synthetic
families at 48 x 64, weights ``init_params(3)``; the pass mark is a bad-2.0
within 0.005 of the oracle's for both of the port's rows on every scene.

    python -m mccnn_tpu_torch.tools.parity_eval [--device cpu]

The oracles run on the host (about a second a scene); the port on
``--device`` (default cuda). Exits 1 when a delta exceeds the mark.
"""

from __future__ import annotations

import argparse
import importlib.util
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUDGET = 0.005  # max |bad-2.0 delta| against the oracle chain
SHIFTS = (2, 3, 5)
FAMILIES = ("translation", "slanted", "textureless", "occlusion")
PIPELINES = ("oracle", "ours-exact", "ours-mxu")


def parity_config():
    """The small-radius configuration of the JAX package's oracle tests
    (tests/test_pipeline.py's CFG)."""
    from mccnn_tpu_torch.utils.config import MatchConfig

    return MatchConfig(cbca_intensity=0.4, cbca_distance=3,
                       cbca_num_iterations_1=1, cbca_num_iterations_2=2,
                       sgm_d=0.4)


def load_oracles():
    """``tests/oracles.py`` of this checkout, loaded by path."""
    path = os.path.join(ROOT, "tests", "oracles.py")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path}: the oracle chain lives in the repository's tests; run "
            "this tool from a checkout")
    spec = importlib.util.spec_from_file_location("mccnn_oracles", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def textured_pair(rng, height=24, width=40, shift=3):
    """A translated textured pair with a constant known disparity; the
    left border (no correspondence) has gt ``inf``."""
    base = rng.normal(size=(height, width + shift)).astype(np.float32)
    kernel = np.ones(3) / 3.0
    base = np.apply_along_axis(
        lambda r: np.convolve(r, kernel, mode="same"), 1, base)
    # left[w] = base[w] = right[w - shift]
    left = base[:, :-shift] if shift else base
    right = base[:, shift:] if shift else base

    def std(x):
        return ((x - x.mean()) / x.std()).astype(np.float32)

    gt = np.full((height, width), float(shift), dtype=np.float32)
    gt[:, :shift] = np.inf
    return std(left), std(right), gt


def oracle_pipeline(net, left, right, ndisp, config, oracles=None):
    """The whole reference pipeline in the oracles, on the port's features
    (computed on the net's device, TF32 off)."""
    import torch

    from mccnn_tpu_torch.models.net import disable_tf32, extract_features

    o = oracles or load_oracles()
    disable_tf32()
    device = next(net.parameters()).device
    with torch.no_grad():
        feat_l, feat_r = (
            extract_features(net, torch.from_numpy(x).to(device)).cpu().numpy()
            for x in (left, right))
    lcv, rcv = o.cost_volume_oracle(feat_l, feat_r, ndisp)

    distance = int(config.cbca_distance)
    regions_l = o.cross_regions_oracle(left, config.cbca_intensity, distance)
    regions_r = o.cross_regions_oracle(right, config.cbca_intensity, distance)
    lcv = o.cbca_oracle(lcv, regions_l, config.cbca_num_iterations_1)
    rcv = o.cbca_oracle(rcv, regions_r, config.cbca_num_iterations_1)
    lcv, rcv = o.sgm_average_oracle(
        lcv, rcv, left, right, config.sgm_p1, config.sgm_p2, config.sgm_q1,
        config.sgm_q2, config.sgm_d, config.sgm_v)
    lcv = o.cbca_oracle(lcv, regions_l, config.cbca_num_iterations_2)
    rcv = o.cbca_oracle(rcv, regions_r, config.cbca_num_iterations_2)

    disp_l = o.wta_oracle(lcv)
    disp_r = o.wta_oracle(rcv)
    _, disp = o.interpolation_oracle(disp_l, disp_r, ndisp)
    disp = o.subpixel_oracle(disp, lcv)
    disp = o.median_oracle(disp, config.median_filter_size,
                           config.median_filter_size)
    return o.bilateral_oracle(
        left, disp, config.bilateral_filter_size,
        config.bilateral_filter_size, 0.0, config.blur_sigma,
        config.blur_threshold)


def compare_scene(net, left, right, gt, ndisp, config, oracles=None) -> dict:
    """bad-2.0 and avg_err of the three pipelines on one scene ->
    {pipeline: (bad_2.0, avg_err)}."""
    import torch

    from mccnn_tpu_torch.pipeline.match import match_pair
    from mccnn_tpu_torch.utils.evaluate import evaluate_pair

    device = next(net.parameters()).device
    lt, rt = (torch.from_numpy(x).to(device) for x in (left, right))
    maps = {
        "oracle": oracle_pipeline(net, left, right, ndisp, config, oracles),
        "ours-exact": match_pair(net, lt, rt, ndisp, config,
                                 cbca_impl="xla").cpu().numpy(),
        "ours-mxu": match_pair(net, lt, rt, ndisp, config,
                               cbca_impl="mxu").cpu().numpy(),
    }
    out = {}
    for name, disparity in maps.items():
        if not np.isfinite(disparity).all():
            raise AssertionError(f"{name}: non-finite disparity")
        m = evaluate_pair(disparity, gt)
        out[name] = (m["bad_2.0"], m["avg_err"])
    return out


def worst_delta(scores: dict) -> float:
    """The larger |bad-2.0 delta| of the port's two rows to the oracle's."""
    return max(abs(scores[name][0] - scores["oracle"][0])
               for name in ("ours-exact", "ours-mxu"))


def run(device: str = "cuda", shifts=SHIFTS, families=FAMILIES,
        log=print) -> dict:
    """Every scene through the three pipelines -> {scene: scores}; the
    scenes are ``shift N`` (28 x 44, ndisp 8) and the families (48 x 64,
    max disparity 6)."""
    import torch

    from mccnn_tpu_torch.models.net import init_params, params_from_numpy
    from mccnn_tpu_torch.utils.scenes import scene_pair

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but CUDA is not "
                           "available")
    net = params_from_numpy(init_params(3)).to(device)
    config = parity_config()
    oracles = load_oracles()
    results = {}

    def report(scene, scores):
        results[scene] = scores
        for name in PIPELINES:
            bad2, avg = scores[name]
            log(f"{scene:>12} {name:>12} {bad2:>9.4f} {avg:>9.4f}")

    log(f"{'scene':>12} {'pipeline':>12} {'bad-2.0':>9} {'avg_err':>9}")
    rng = np.random.default_rng(42)
    for shift in shifts:
        left, right, gt = textured_pair(rng, height=28, width=44, shift=shift)
        report(f"shift {shift}", compare_scene(net, left, right, gt, 8,
                                               config, oracles))
    for i, family in enumerate(FAMILIES):
        if family not in families:
            continue
        left, right, gt, occluded, ndisp = scene_pair(
            family, np.random.default_rng(100 + i), 48, 64, max_disparity=6)
        gt_eval = gt.copy()
        gt_eval[occluded] = np.inf  # Middlebury's nonocc scoring
        report(family, compare_scene(net, left, right, gt_eval, ndisp,
                                     config, oracles))
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="the port against the oracle chain, per scene")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; a CUDA request with no card fails")
    args = parser.parse_args(argv)
    results = run(args.device, log=lambda line: print(line, flush=True))
    worst = max(worst_delta(scores) for scores in results.values())
    print(f"\nmax |bad-2.0 delta| vs oracle: {worst:.4f} (budget {BUDGET})",
          flush=True)
    return 0 if worst <= BUDGET else 1


if __name__ == "__main__":
    raise SystemExit(main())
