"""Batch matching CLI on PyTorch (mccnn_tpu/cli/match.py).

Flag-compatible with the JAX package's matcher (and through it with the
reference's match.py): a left-image list file, ``--data_dir`` /
``--save_dir`` / ``--tag`` output derivation, ``--start/--end`` index
slicing, all CBCA/SGM/blur hyperparameters, and Middlebury-v3 artifacts
(``disp0MCCNN.pfm`` / ``.pgm``, ``timeMCCNN.txt``) per scene. ``--device``
picks the device (default ``cuda``; ``cpu`` runs the plain versions).
Every ``--cbca_impl`` of the JAX matcher and ``--cbca_joint_regions`` run;
TF1 checkpoints (``--resume`` of a ``.ckpt``) are what the port does not
read, and raise. ``--multihost`` keeps only this process's scenes of the
``--start/--end`` range, every ``WORLD_SIZE``-th from ``RANK`` on
(``parallel/multihost.py::process_slice``: the started process group's
rank and size, else those variables, else all scenes), so N processes
started with ``RANK`` 0 .. N-1 write each scene once.

Usage:

    python -m mccnn_tpu_torch.cli.match --list_file scenes.txt \
        --resume weights.npz --data_dir data --save_dir out -t run \
        -s 0 -e 99 [--device cuda] [--cbca_impl rolling] [--stage_times]
"""

from __future__ import annotations

import argparse
import time

from mccnn_tpu_torch.utils.config import MatchConfig


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description="stereo matching based on trained model and "
                    "post-processing (PyTorch / CUDA)",
    )
    parser.add_argument("-g", "--gpu", type=str, default="0",
                        help="accepted for reference compatibility; see "
                             "--device")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; cpu runs the plain versions")
    parser.add_argument("-ps", "--patch_size", type=int, default=11)
    parser.add_argument("--list_file", type=str, required=True)
    parser.add_argument("--resume", type=str, required=True,
                        help="weights: native .npz or reference .npy dict")
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--save_dir", type=str, required=True)
    parser.add_argument("-t", "--tag", type=str, required=True)
    parser.add_argument("-s", "--start", type=int, required=True)
    parser.add_argument("-e", "--end", type=int, required=True)

    parser.add_argument("--cbca_intensity", type=float, default=0.02)
    parser.add_argument("--cbca_distance", type=float, default=14)
    parser.add_argument("--cbca_num_iterations1", type=float, default=2)
    parser.add_argument("--cbca_num_iterations2", type=float, default=16)
    parser.add_argument("--sgm_P1", type=float, default=2.3)
    parser.add_argument("--sgm_P2", type=float, default=55.9)
    parser.add_argument("--sgm_Q1", type=float, default=4)
    parser.add_argument("--sgm_Q2", type=float, default=8)
    parser.add_argument("--sgm_D", type=float, default=0.08)
    parser.add_argument("--sgm_V", type=float, default=1.5)
    parser.add_argument("--blur_sigma", type=float, default=6)
    parser.add_argument("--blur_threshold", type=float, default=2)
    parser.add_argument("--cbca_joint_regions", action="store_true",
                        help="the paper's disparity-conditioned joint-region "
                             "CBCA (disabled in the reference as impractical;"
                             " torch ops, slow)")
    parser.add_argument("--sgm_paper_mode", action="store_true",
                        help="independent-direction SGM average instead of the "
                             "reference's chained in-place sweeps")
    parser.add_argument("--cost_volume_method", type=str, default="auto",
                        choices=["auto", "pallas", "matmul", "rolldot"],
                        help="'auto' and 'pallas' run the band kernels; "
                             "'matmul' and 'rolldot' are torch-op paths")
    parser.add_argument("--cbca_impl", type=str, default="auto",
                        choices=["auto", "mxu", "fused", "fused16", "fused8",
                                 "fused2", "fused2_16", "pallas", "xla",
                                 "rolling", "rolling16"],
                        help="CBCA aggregation backend. 'auto', 'fused' and "
                             "'xla' run the two-pass f32-sum kernel; "
                             "'pallas' is the exact-f32 single-pass kernel "
                             "(float32 volumes only); 'fused8' is the "
                             "int8-storage memory mode; 'rolling' rolls the "
                             "rows through a ring (each volume row read once "
                             "per column strip); 'fused2' runs two rounds per "
                             "pass; 'fused16', 'rolling16' and 'fused2_16' "
                             "keep float32 storage and round the rounds' "
                             "operands to bfloat16; 'mxu' is banded 0/1 "
                             "matrix products with bfloat16-rounded operands "
                             "(float32 volumes only)")
    parser.add_argument("--volume_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="cost-volume storage dtype; bfloat16 halves "
                             "the volume memory (DP/aggregation math stays "
                             "f32), a documented numerical deviation")
    parser.add_argument("--cbca_chunk_d", type=int, default=0,
                        help="aggregate the disparity axis in chunks of this "
                             "many lanes (0 = off); bounds the CBCA buffers "
                             "for full-resolution scenes")
    parser.add_argument("--bucket", type=int, default=1,
                        help="pad images (edge-replicated) to multiples of "
                             "this. Values >1 change SGM/CBCA numerics in "
                             "the padded band, so outputs deviate slightly "
                             "from the reference; 1 (default) is strict "
                             "parity")
    parser.add_argument("--multihost", action="store_true",
                        help="shard scenes across processes (strided by the "
                             "process group's rank, else RANK / WORLD_SIZE) "
                             "inside the --start/--end range")
    parser.add_argument("--stage_times", action="store_true",
                        help="print per-stage wall-clock for every scene. "
                             "Runs the pipeline as ten steps with a device "
                             "sync after each and both volumes live; for "
                             "observability, not throughput")
    return parser


def config_from_args(args) -> MatchConfig:
    return MatchConfig(
        cbca_intensity=args.cbca_intensity,
        cbca_distance=int(args.cbca_distance),
        cbca_num_iterations_1=int(args.cbca_num_iterations1),
        cbca_num_iterations_2=int(args.cbca_num_iterations2),
        sgm_p1=args.sgm_P1,
        sgm_p2=args.sgm_P2,
        sgm_q1=args.sgm_Q1,
        sgm_q2=args.sgm_Q2,
        sgm_d=args.sgm_D,
        sgm_v=args.sgm_V,
        blur_sigma=args.blur_sigma,
        blur_threshold=args.blur_threshold,
        sgm_paper_mode=args.sgm_paper_mode,
        cbca_joint_regions=args.cbca_joint_regions,
    )


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    config = config_from_args(args)

    from mccnn_tpu_torch.data.dataset import load_grayscale
    from mccnn_tpu_torch.io.calib import parse_calib
    from mccnn_tpu_torch.io.middlebury import (
        derive_scene_paths,
        ensure_dirs,
        save_disparity_pgm,
        save_time_file,
    )
    from mccnn_tpu_torch.io.pfm import write_pfm
    from mccnn_tpu_torch.models.params import load_any
    from mccnn_tpu_torch.pipeline.match import MatchPipeline, standardize_image
    from mccnn_tpu_torch.utils.metrics import MetricsLogger

    pipeline = MatchPipeline(
        load_any(args.resume), config,
        cost_volume_method=args.cost_volume_method,
        bucket=args.bucket,
        cbca_impl=args.cbca_impl,
        volume_dtype=args.volume_dtype,
        cbca_chunk_d=args.cbca_chunk_d,
        device=args.device,
    )
    logger = MetricsLogger(None)

    with open(args.list_file) as f:
        scene_paths = [line.strip() for line in f if line.strip()]

    owned = None
    if args.multihost:
        from mccnn_tpu_torch.parallel.multihost import process_slice

        owned = set(process_slice(len(scene_paths)))

    try:
        from tqdm import tqdm
    except ImportError:  # pragma: no cover
        tqdm = lambda x: x  # noqa: E731

    for index, left_path in enumerate(tqdm(scene_paths)):
        if index < args.start or index > args.end:
            continue
        if owned is not None and index not in owned:
            continue
        paths = derive_scene_paths(left_path, args.data_dir, args.save_dir,
                                   args.tag)
        ensure_dirs(paths)
        height, width, ndisp = parse_calib(paths.calib)
        logger.log(event="scene", index=index, left=paths.left,
                   height=height, width=width, ndisp=ndisp)

        left_image = standardize_image(load_grayscale(paths.left))
        right_image = standardize_image(load_grayscale(paths.right))
        if left_image.shape != (height, width):
            raise ValueError(
                f"{paths.left}: image shape {left_image.shape} != calib "
                f"({height}, {width})"
            )

        start_time = time.time()
        if args.stage_times:
            disparity, stage_seconds = pipeline.stage_times(
                left_image, right_image, ndisp
            )
            for stage, seconds in stage_seconds.items():
                print(f"  {stage:16s} {seconds * 1e3:9.1f} ms", flush=True)
            logger.log(event="stage_times", index=index,
                       **{k: round(v, 4) for k, v in stage_seconds.items()})
        else:
            disparity = pipeline(left_image, right_image, ndisp)
        # the result is on the host here, so the device has finished
        elapsed = time.time() - start_time

        save_disparity_pgm(disparity, paths.out_pgm)
        write_pfm(disparity, paths.out_pfm)
        save_time_file(elapsed, paths.out_time)
        logger.log(event="done", index=index, seconds=elapsed,
                   mpix_per_s=height * width / 1e6 / elapsed)


if __name__ == "__main__":
    main()
