"""Per-stage profile of the matching pipeline (the JAX repo's
tools/profile_pipeline.py on PyTorch).

Times each stage as its own call on f32 volumes, with a device sync
around every timed stage: the features of both images, both volumes (K1
per side on the card), the arms, one CBCA round of one volume (the
``CBCA_IMPL`` environment variable names the impl, the matcher's names;
default "auto", K2), one horizontal and one vertical SGM sweep (K3), WTA,
the LR check, subpixel, median and bilateral filters; then their sum at a
pair's counts (2 arms, 36 rounds, 4 sweeps of each axis). Stages timed in
isolation allocate what the pipeline reuses: the sum is an attribution,
not the pair's time.

    python -m mccnn_tpu_torch.tools.profile_pipeline [H W NDISP]
        [--device cpu]

Prints a line per stage and one JSON line with the device (``nvidia-smi``'s
name and power limit, or "cpu").
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


class StageTable:
    """Times stages with ``bench.timed`` and prints a line for each."""

    def __init__(self, device: torch.device, iters: int):
        self.device = device
        self.iters = iters
        self.ms = {}

    def __call__(self, name: str, fn, *args):
        from mccnn_tpu_torch.bench import timed

        out, seconds = timed(fn, *args, device=self.device, iters=self.iters)
        self.ms[name] = seconds * 1e3
        print(f"{name:42s} {seconds * 1e3:9.1f} ms", flush=True)
        return out


def setup(shape, default, device_name: str):
    """(H, W, ndisp), the device, its label, the ``init_params(0)`` net
    and two seeded random images on the device; the kernels are built
    first on the card."""
    from mccnn_tpu_torch.bench import device_label, resolve_device
    from mccnn_tpu_torch.models.net import (
        disable_tf32,
        init_params,
        params_from_numpy,
    )

    if shape and len(shape) != 3:
        raise ValueError(f"give H W NDISP, got {shape}")
    height, width, ndisp = shape or default
    device = resolve_device(device_name)
    if device.type == "cuda":
        from mccnn_tpu_torch.kernels import build

        build.build()
        build.library()
    disable_tf32()
    net = params_from_numpy(init_params(0)).to(device)
    rng = np.random.default_rng(0)
    left, right = (torch.from_numpy(rng.normal(size=(height, width)).astype(
        np.float32)).to(device) for _ in range(2))
    return (height, width, ndisp), device, device_label(device), net, left, right


def build_parser(description: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("shape", nargs="*", type=int, help="H W NDISP")
    parser.add_argument("--device", default="cuda",
                        help="torch device; a CUDA request with no card fails")
    return parser


def main(argv=None) -> dict:
    from mccnn_tpu_torch.models.net import extract_features
    from mccnn_tpu_torch.ops.cbca import compute_arms
    from mccnn_tpu_torch.ops.cost_volume import cost_volume_pair
    from mccnn_tpu_torch.ops.filters import bilateral_filter, median_filter
    from mccnn_tpu_torch.ops.lr_check import lr_consistency_interpolate
    from mccnn_tpu_torch.ops.sgm import sweep
    from mccnn_tpu_torch.ops.subpixel import subpixel_enhance
    from mccnn_tpu_torch.ops.wta import wta_disparity
    from mccnn_tpu_torch.pipeline.match import _cbca_aggregate
    from mccnn_tpu_torch.utils.config import MatchConfig

    args = build_parser(__doc__.splitlines()[0]).parse_args(argv)
    (height, width, ndisp), device, label, net, left, right = setup(
        args.shape, (1000, 1504, 200), args.device)
    config = MatchConfig()
    distance = int(config.cbca_distance)
    impl = os.environ.get("CBCA_IMPL", "auto")
    aggregate = _cbca_aggregate(impl)
    rounds = 2 * (config.cbca_num_iterations_1 + config.cbca_num_iterations_2)
    stage = StageTable(device, iters=3)
    with torch.no_grad():
        fl, fr = stage("features x2", lambda a, b: (
            extract_features(net, a), extract_features(net, b)), left, right)
        volume, right_volume = stage(
            "cost_volume_pair (one call a side)", lambda a, b: tuple(
                cost_volume_pair(a, b, ndisp, sides=side)
                for side in ("left", "right")), fl, fr)
        del fl, fr, right_volume
        arms = stage("arms (one image)", lambda image: compute_arms(
            image, config.cbca_intensity, distance), left)
        stage(f"cbca x1 iter (one volume, {impl})",
              lambda v: aggregate(v, arms, 1, distance), volume)
        swept = torch.empty_like(volume)
        for axis, direction in (("horizontal", (0, 1)), ("vertical", (1, 0))):
            stage(f"sgm {axis} sweep", lambda v, d=direction: sweep(
                v, swept, left, right, "L", d, config), volume)
        del swept
        dl, dr = stage("wta x2", lambda v: (wta_disparity(v),
                                            wta_disparity(v)), volume)
        disp = stage("lr_check+interpolate", lambda a, b:
                     lr_consistency_interpolate(a, b, ndisp), dl, dr)
        disp = stage("subpixel", lambda d, v: subpixel_enhance(d, v, ndisp),
                     disp, volume)
        disp = stage("median 5x5", lambda d: median_filter(d, 5, 5), disp)
        stage("bilateral 5x5", lambda image, d: bilateral_filter(
            image, d, 5, 5, 0.0, config.blur_sigma, config.blur_threshold),
            left, disp)
    counts = {"arms (one image)": 2, "sgm horizontal sweep": 4,
              "sgm vertical sweep": 4}
    counts[f"cbca x1 iter (one volume, {impl})"] = rounds
    total = sum(ms * counts.get(name, 1) for name, ms in stage.ms.items())
    print(f"{'SUM (a pair, stage-isolated)':42s} {total:9.1f} ms", flush=True)
    record = {"tool": "profile_pipeline", "shape": [height, width, ndisp],
              "volume_dtype": "float32", "cbca_impl": impl,
              "stages_ms": stage.ms, "counts_per_pair": counts,
              "sum_ms_isolated": total, "device": label}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
