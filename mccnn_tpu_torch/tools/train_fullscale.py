"""Train on synthetic scenes, then score the result per family at full
scale (mccnn_tpu's tools/train_fullscale.py on PyTorch).

The reference's training recipe shape (2000 epochs of one 128-triplet
batch per scene; with 15 scenes, 30k steps) through the port's product
path: scene files in the Middlebury layout -> ``cli/train.py`` (the
dataset in RAM, the triplet sampler, the prefetch thread, checkpoints and
validation) -> ``model_epochN.npz`` -> ``tools/eval_fullscale.py``'s
per-family bad-2.0 at 1000 x 1504, for the trained weights and for random
init (``init_params(0)``).

The 15 training scenes (256 x 384) cycle through the five families, with
two validation scenes; every image gets gaussian noise of 0.25 (on clean
synthetic texture every feature wins), and the evaluation adds the same
noise, so the table asks whether the trained features match better than
random ones on the training distribution. It exits 1 when a family's
trained score is worse than random init's by more than 0.005.

    python -m mccnn_tpu_torch.tools.train_fullscale [--epochs 2000] \\
        [--out build/train_fullscale] [--device cpu]

The evaluation runs in this process after the trainer has returned (its
prefetch thread joined, its tensors released). Prints the trainer's
steps/s and wall seconds beside the card's name and power limit, both
evaluations and the table.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time

import numpy as np

VAL_FAMILIES = ("translation", "occlusion")
WORSE_BY = 0.005  # bad-2.0 a family may lose to random init


def write_png(pixels: np.ndarray, path: str) -> None:
    """Save a uint8 image as a grayscale PNG (PIL, else OpenCV)."""
    try:
        from PIL import Image
    except ImportError:
        import cv2

        if not cv2.imwrite(path, pixels):
            raise RuntimeError(f"could not write {path}")
    else:
        Image.fromarray(pixels).save(path)


def write_scene_files(scene_dir: str, family: str, rng: np.random.Generator,
                      height: int, width: int, max_disparity: int,
                      noise: float) -> None:
    """One scene in the Middlebury layout: im0.png / im1.png with gaussian
    noise, truncated to uint8, and disp0GT.pfm. Occluded pixels keep their
    disparity in the GT, as Middlebury's do (the sampler rejects gt > col,
    not occlusion)."""
    from mccnn_tpu_torch.io.pfm import write_pfm
    from mccnn_tpu_torch.utils.scenes import make_scene

    scene = make_scene(family, rng, height, width, max_disparity)
    os.makedirs(scene_dir, exist_ok=True)
    for name, img in (("im0.png", scene["left"]), ("im1.png", scene["right"])):
        noisy = img + noise * rng.normal(size=img.shape).astype(np.float32)
        write_png(np.clip(noisy * 255.0, 0, 255).astype(np.uint8),
                  os.path.join(scene_dir, name))
    write_pfm(scene["gt"].astype(np.float32),
              os.path.join(scene_dir, "disp0GT.pfm"))


def card() -> str:
    """``nvidia-smi``'s name and power limit of the card, or why none."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description="train on synthetic scenes, then score per family")
    parser.add_argument("--epochs", type=int, default=2000)
    parser.add_argument("--scenes", type=int, default=15)
    parser.add_argument("--height", type=int, default=256)
    parser.add_argument("--width", type=int, default=384)
    parser.add_argument("--max-disparity", type=int, default=40)
    parser.add_argument("--noise", type=float, default=0.25,
                        help="gaussian image noise in [0, 1] intensity units")
    parser.add_argument("--out", type=str, default="build/train_fullscale")
    parser.add_argument("--eval-height", type=int, default=1000)
    parser.add_argument("--eval-width", type=int, default=1504)
    parser.add_argument("--eval-max-disparity", type=int, default=160,
                        help="the evaluation's search range less 2 (its "
                             "--max-disparity)")
    parser.add_argument("--skip-train", action="store_true",
                        help="reuse an existing checkpoint in --out")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; a CUDA request with no card fails")
    return parser


def run(argv=None) -> dict:
    """Train and evaluate as ``main`` does -> {"results": {label: the
    evaluation's result}, "worse": families worse than random init,
    "steps", "steps_per_s", "train_seconds" (the last two None with
    --skip-train)}."""
    args = build_parser().parse_args(argv)

    from mccnn_tpu_torch.cli.train import main as train_main
    from mccnn_tpu_torch.tools import eval_fullscale

    data_dir = os.path.join(args.out, "data")
    list_dir = os.path.join(args.out, "lists")
    ckpt = os.path.join(args.out, "ckpt", f"model_epoch{args.epochs}.npz")
    os.makedirs(list_dir, exist_ok=True)

    # the dataset: N training scenes and 2 validation scenes
    rng = np.random.default_rng(42)
    lines = {"train": [], "val": []}
    families = eval_fullscale.FAMILIES
    scenes = [("train", i, families[i % len(families)])
              for i in range(args.scenes)]
    scenes += [("val", i, family) for i, family in enumerate(VAL_FAMILIES)]
    for split, i, family in scenes:
        scene_dir = os.path.join(data_dir, f"{split}_{i:02d}_{family}")
        if not args.skip_train:
            write_scene_files(scene_dir, family, rng, args.height,
                              args.width, args.max_disparity, args.noise)
        lines[split].append(os.path.join(scene_dir, "im0.png"))
    for split, paths in lines.items():
        with open(os.path.join(list_dir, f"{split}.txt"), "w") as f:
            f.write("\n".join(paths) + "\n")

    steps = args.epochs * args.scenes
    seconds = steps_per_s = None
    if not args.skip_train:
        start = time.perf_counter()
        train_main([
            "--list_dir", list_dir,
            "--tensorboard_dir", os.path.join(args.out, "metrics"),
            "--checkpoint_dir", os.path.dirname(ckpt),
            "--end_epoch", str(args.epochs),
            "--print_freq", "100",
            "--save_freq", str(max(1, args.epochs // 4)),
            "--val_freq", str(max(1, args.epochs // 8)),
            "--sampler_backend", "auto",
            "--prefetch_batches", "4",
            "--device", args.device,
        ])
        seconds = time.perf_counter() - start
        steps_per_s = steps / seconds
        print(f"training: {steps} steps in {seconds:.1f} s wall "
              f"({steps_per_s:.1f} steps/s with host sampling and the "
              f"dataset's load) on {args.device}; {card()}", flush=True)
    if not os.path.exists(ckpt):
        raise FileNotFoundError(f"checkpoint missing: {ckpt}")

    results = {}
    for label, weights in (("self-trained", ckpt), ("random-init", "random")):
        print(f"--- {label} ---", flush=True)
        results[label] = eval_fullscale.main([
            "--weights", weights,
            "--height", str(args.eval_height),
            "--width", str(args.eval_width),
            "--max-disparity", str(args.eval_max_disparity),
            "--noise", str(args.noise),
            "--no-exact-crosscheck",
            "--device", args.device,
        ])

    print("\n| family | self-trained bad-2.0 | random-init bad-2.0 |",
          flush=True)
    print("|---|---|---|", flush=True)
    worse = 0
    for mine, theirs in zip(results["self-trained"]["results"],
                            results["random-init"]["results"]):
        flag = ("" if mine["bad_2.0"] <= theirs["bad_2.0"] + WORSE_BY
                else "  <-- WORSE")
        worse += bool(flag)
        print(f"| {mine['family']} | {mine['bad_2.0']:.4f} | "
              f"{theirs['bad_2.0']:.4f} |{flag}", flush=True)
    print("SELF-TRAINED >= RANDOM INIT" if not worse
          else f"{worse} families worse than random init", flush=True)
    return {"results": results, "worse": worse, "steps": steps,
            "steps_per_s": steps_per_s, "train_seconds": seconds}


def main(argv=None) -> int:
    return 1 if run(argv)["worse"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
