"""Evaluation CLI: score matched disparity maps against ground truth
(the port's NumPy-only counterpart of mccnn_tpu/cli/eval.py, on the port's
own ``utils/evaluate.py``; it imports neither torch nor JAX).

The reference has NO quantitative evaluation — correctness was judged by
submitting Middlebury artifacts and eyeballing (reference: README.md:31,
src/match.py:52-54). This closes that loop: point it at the same
``--list_file/--data_dir/--save_dir/--tag`` a ``cli.match`` run used and it
scores every produced ``disp0MCCNN.pfm`` against the scene's ``disp0GT.pfm``
(derivation contract: reference src/match.py:46-54), printing per-scene and
pixel-weighted aggregate bad-N / avg / RMS error, Middlebury-style.

    python -m mccnn_tpu_torch.cli.eval --list_file list.txt --data_dir D \
        --save_dir S --tag t0 [--thresholds 0.5,1,2,4] [--nonocc] \
        [--report report.jsonl]

``--nonocc`` restricts scoring to non-occluded pixels via the scene's
``mask0nocc.png`` (Middlebury convention: 255 = valid non-occluded); scenes
without the mask fall back to all-valid-GT with a warning. A direct mode
(``--pred x.pfm --gt y.pfm``) scores one map without the dataset layout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from mccnn_tpu_torch.io.middlebury import LEFT_IMAGE_SUFFIX, derive_scene_paths
from mccnn_tpu_torch.io.pfm import read_pfm
from mccnn_tpu_torch.utils.evaluate import (
    evaluate_counts,
    merge_counts,
    summarize_counts,
)

NONOCC_MASK_SUFFIX = "mask0nocc.png"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description="score disparity maps against ground truth (bad-N, "
                    "avg/RMS error; Middlebury-style)",
    )
    parser.add_argument("--list_file", type=str, default=None,
                        help="left-image list of the scenes to score "
                             "(same file a cli.match run used)")
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--save_dir", type=str, default=None,
                        help="cli.match --save_dir holding submit_{tag}/")
    parser.add_argument("-t", "--tag", type=str, default=None)
    parser.add_argument("-s", "--start", type=int, default=0)
    parser.add_argument("-e", "--end", type=int, default=10 ** 9)
    parser.add_argument("--pred", type=str, default=None,
                        help="direct mode: a single predicted .pfm")
    parser.add_argument("--gt", type=str, default=None,
                        help="direct mode: its ground-truth .pfm")
    parser.add_argument("--thresholds", type=str, default="0.5,1,2,4",
                        help="comma-separated bad-N thresholds (pixels)")
    parser.add_argument("--nonocc", action="store_true",
                        help="score only non-occluded pixels "
                             f"({NONOCC_MASK_SUFFIX} == 255)")
    parser.add_argument("--report", type=str, default=None,
                        help="also write one JSON line per scene (plus the "
                             "aggregate) to this file")
    return parser


def _load_mask(left_path: str):
    """The scene's non-occlusion mask as bool, or None if absent."""
    mask_path = left_path.replace(LEFT_IMAGE_SUFFIX, NONOCC_MASK_SUFFIX)
    if not os.path.exists(mask_path):
        return None
    from mccnn_tpu_torch.data.dataset import load_grayscale

    return load_grayscale(mask_path) == 255


def _score_scenes(args):
    """Yield (scene_name, counts) for every scored scene."""
    thresholds = tuple(float(t) for t in args.thresholds.split(","))
    if args.pred or args.gt:
        if not (args.pred and args.gt):
            raise SystemExit("direct mode needs both --pred and --gt")
        disparity = read_pfm(args.pred)
        ground_truth = read_pfm(args.gt)
        yield args.pred, evaluate_counts(disparity, ground_truth, thresholds)
        return

    required = (args.list_file, args.data_dir, args.save_dir, args.tag)
    if any(v is None for v in required):
        raise SystemExit("scene mode needs --list_file --data_dir "
                         "--save_dir --tag (or use --pred/--gt)")
    with open(args.list_file) as f:
        scene_paths = [line.strip() for line in f if line.strip()]
    for index, left_path in enumerate(scene_paths):
        if index < args.start or index > args.end:
            continue
        paths = derive_scene_paths(
            left_path, args.data_dir, args.save_dir, args.tag)
        if not os.path.exists(paths.out_pfm):
            print(f"skip {left_path}: no {paths.out_pfm} (not matched yet?)",
                  file=sys.stderr, flush=True)
            continue
        if not os.path.exists(paths.gt_left):
            print(f"skip {left_path}: no ground truth {paths.gt_left}",
                  file=sys.stderr, flush=True)
            continue
        disparity = read_pfm(paths.out_pfm)
        ground_truth = read_pfm(paths.gt_left)
        if disparity.shape != ground_truth.shape:
            print(f"skip {left_path}: pred {disparity.shape} != "
                  f"gt {ground_truth.shape}", file=sys.stderr, flush=True)
            continue
        mask = _load_mask(left_path) if args.nonocc else None
        if args.nonocc and mask is None:
            print(f"warn {left_path}: --nonocc but no {NONOCC_MASK_SUFFIX}; "
                  "scoring all valid-GT pixels", file=sys.stderr, flush=True)
        scene = os.path.dirname(left_path)
        yield scene, evaluate_counts(disparity, ground_truth, thresholds,
                                     mask)


def main(argv=None, stdout=None) -> None:
    args = build_parser().parse_args(argv)
    stdout = stdout if stdout is not None else sys.stdout
    thresholds = tuple(float(t) for t in args.thresholds.split(","))

    header = (f"{'scene':<40} "
              + " ".join(f"{'bad-' + format(t, 'g'):>9}" for t in thresholds)
              + f" {'avg_err':>9} {'rms_err':>9} {'valid%':>7}")
    print(header, file=stdout, flush=True)

    report = open(args.report, "w") if args.report else None
    total: dict = {}
    n_scenes = 0
    try:
        for scene, counts in _score_scenes(args):
            n_scenes += 1
            merge_counts(total, counts)
            rates = summarize_counts(counts)
            row = (f"{scene[-40:]:<40} "
                   + " ".join(f"{rates.get(f'bad_{t:g}', float('nan')):>9.4f}"
                              for t in thresholds)
                   + f" {rates.get('avg_err', float('nan')):>9.4f}"
                     f" {rates.get('rms_err', float('nan')):>9.4f}"
                     f" {100 * rates['coverage']:>6.1f}%")
            print(row, file=stdout, flush=True)
            if report:
                report.write(json.dumps(
                    {"scene": scene, "n_valid": counts["n_valid"], **rates}
                ) + "\n")
        if n_scenes == 0:
            raise SystemExit("no scenes scored")
        rates = summarize_counts(total)
        row = (f"{f'ALL ({n_scenes} scenes, pixel-weighted)':<40} "
               + " ".join(f"{rates.get(f'bad_{t:g}', float('nan')):>9.4f}"
                          for t in thresholds)
               + f" {rates.get('avg_err', float('nan')):>9.4f}"
                 f" {rates.get('rms_err', float('nan')):>9.4f}"
                 f" {100 * rates['coverage']:>6.1f}%")
        print(row, file=stdout, flush=True)
        if report:
            report.write(json.dumps(
                {"scene": "ALL", "n_scenes": n_scenes,
                 "n_valid": total["n_valid"], **rates}) + "\n")
    finally:
        if report:
            report.close()


if __name__ == "__main__":
    main()
