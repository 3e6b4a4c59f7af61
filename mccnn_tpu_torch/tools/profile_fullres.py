"""Per-stage profile of the full-resolution schedule (the JAX repo's
tools/profile_fullres.py on PyTorch).

The stages of ``bench --config full`` at 2000 x 3072, ndisp 400 (D_pad
512), timed one by one with a device sync around each: the features of
both images, ONE bf16 volume (K1 on bf16 descriptors, as the pipeline casts
them), the arms, one CBCA round (K2) over the whole depth and on the
pipeline's 256-lane chunks (``cbca_chunk_d``: each chunk copied out and
back), one horizontal and one vertical SGM sweep in place (K3 on bf16 at
D_pad 512), WTA, the LR check, subpixel, median and bilateral filters.

    python -m mccnn_tpu_torch.tools.profile_fullres [H W NDISP]
        [--device cpu]

Prints a line per stage and one JSON line with the device (``nvidia-smi``'s
name and power limit, or "cpu").
"""

from __future__ import annotations

import json

import torch

from mccnn_tpu_torch.tools.profile_pipeline import (
    StageTable,
    build_parser,
    setup,
)

CHUNK_D = 256  # bench --config full's cbca_chunk_d


def main(argv=None) -> dict:
    from mccnn_tpu_torch.models.net import extract_features
    from mccnn_tpu_torch.ops.cbca import compute_arms
    from mccnn_tpu_torch.ops.cbca_fused import cbca_fused
    from mccnn_tpu_torch.ops.cost_volume import cost_volume_pair
    from mccnn_tpu_torch.ops.filters import bilateral_filter, median_filter
    from mccnn_tpu_torch.ops.lr_check import lr_consistency_interpolate
    from mccnn_tpu_torch.ops.sgm import sweep
    from mccnn_tpu_torch.ops.subpixel import subpixel_enhance
    from mccnn_tpu_torch.ops.wta import wta_disparity
    from mccnn_tpu_torch.pipeline.match import _run_cbca
    from mccnn_tpu_torch.utils.config import MatchConfig

    args = build_parser(__doc__.splitlines()[0]).parse_args(argv)
    (height, width, ndisp), device, label, net, left, right = setup(
        args.shape, (2000, 3072, 400), args.device)
    config = MatchConfig()
    distance = int(config.cbca_distance)
    rounds = 2 * (config.cbca_num_iterations_1 + config.cbca_num_iterations_2)
    stage = StageTable(device, iters=2)
    with torch.no_grad():
        fl, fr = stage("features x2", lambda a, b: (
            extract_features(net, a), extract_features(net, b)), left, right)
        fl, fr = fl.to(torch.bfloat16), fr.to(torch.bfloat16)
        volume = stage("cost_volume single side (bf16)", lambda a, b:
                       cost_volume_pair(a, b, ndisp, sides="left",
                                        dtype=torch.bfloat16), fl, fr)
        del fl, fr
        arms = stage("arms (one image)", lambda image: compute_arms(
            image, config.cbca_intensity, distance), left)
        stage("cbca_fused 1 round (full D)",
              lambda v: cbca_fused(v, arms, 1, distance), volume)
        stage(f"cbca_fused 1 round ({CHUNK_D}-lane chunks)",
              lambda v: _run_cbca(cbca_fused, v, arms, 1, distance, CHUNK_D),
              volume)
        for axis, direction in (("horizontal", (0, 1)), ("vertical", (1, 0))):
            stage(f"sgm {axis} sweep (bf16, in place)",
                  lambda v, d=direction: sweep(v, v, left, right, "L", d,
                                               config), volume)
        disp = stage("wta (one volume)", wta_disparity, volume)
        disp = stage("lr_check+interpolate", lambda a, b:
                     lr_consistency_interpolate(a, b, ndisp), disp, disp)
        disp = stage("subpixel", lambda d, v: subpixel_enhance(d, v, ndisp),
                     disp, volume)
        disp = stage("median 5x5", lambda d: median_filter(d, 5, 5), disp)
        stage("bilateral 5x5", lambda image, d: bilateral_filter(
            image, d, 5, 5, 0.0, config.blur_sigma, config.blur_threshold),
            left, disp)
    ms = stage.ms
    totals = {
        "cbca_full_d": ms["cbca_fused 1 round (full D)"] * rounds,
        "cbca_chunked": ms[f"cbca_fused 1 round ({CHUNK_D}-lane chunks)"]
        * rounds,
        "sgm": 4 * (ms["sgm horizontal sweep (bf16, in place)"]
                    + ms["sgm vertical sweep (bf16, in place)"]),
    }
    for name, total in totals.items():
        print(f"{'  -> ' + name + ' (a pair)':42s} {total:9.1f} ms", flush=True)
    record = {"tool": "profile_fullres", "shape": [height, width, ndisp],
              "volume_dtype": "bfloat16", "cbca_chunk_d": CHUNK_D,
              "stages_ms": ms, "pair_totals_ms": totals, "device": label}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
