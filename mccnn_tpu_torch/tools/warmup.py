"""Warm the matching pipeline for a scene list's shape buckets (the JAX
repo's tools/warmup.py on PyTorch).

What a serving process pays before it takes traffic in eager PyTorch: the
kernels' nvcc build (reused when the library for these sources exists),
loading the library, the weights onto the card, and per shape bucket the
first pair, which carries cuDNN's algorithm choice and the allocator's
first growth. Reads each scene's calib.txt, collects the bucketed (H, W,
ndisp) set with ``cli/serve.py``'s bucket function and runs
``MatchPipeline`` once per bucket on zero images.

    python -m mccnn_tpu_torch.tools.warmup --list_file scenes.txt
        [--bucket 64] [--resume weights] [--cbca_impl auto]
        [--volume_dtype float32] [--cbca_chunk_d 0] [--device cpu]

Without ``--resume`` the weights are ``init_params(0)``: weights change
values, not what is built or chosen. Prints a line per part and one JSON
line with the seconds of each and the device (``nvidia-smi``'s name and
power limit, or "cpu").
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--list_file", type=str, required=True,
                        help="left-image list; calib.txt next to each image")
    parser.add_argument("--resume", type=str, default=None)
    parser.add_argument("--bucket", type=int, default=64)
    parser.add_argument("--cost_volume_method", type=str, default="auto")
    parser.add_argument("--cbca_impl", type=str, default="auto")
    parser.add_argument("--volume_dtype", type=str, default="float32")
    parser.add_argument("--cbca_chunk_d", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; a CUDA request with no card fails")
    args = parser.parse_args(argv)

    import torch

    from mccnn_tpu_torch.bench import device_label, resolve_device
    from mccnn_tpu_torch.cli.serve import warmup_buckets
    from mccnn_tpu_torch.models.net import init_params
    from mccnn_tpu_torch.models.params import load_any
    from mccnn_tpu_torch.pipeline.match import MatchPipeline

    started = time.perf_counter()
    device = resolve_device(args.device)
    record = {"tool": "warmup", "device": device_label(device),
              "kernel_build_s": None, "kernel_library_s": None}
    if device.type == "cuda":
        from mccnn_tpu_torch.kernels import build

        path, record["kernel_build_s"] = build.build()
        t0 = time.perf_counter()
        build.library()
        record["kernel_library_s"] = time.perf_counter() - t0
        print(f"kernels: nvcc {record['kernel_build_s']:.1f}s (0 when "
              f"{path.name} exists), loaded in "
              f"{record['kernel_library_s']:.2f}s", flush=True)

    t0 = time.perf_counter()
    params = load_any(args.resume) if args.resume else init_params(0)
    pipeline = MatchPipeline(
        params, bucket=args.bucket, volume_dtype=args.volume_dtype,
        cbca_impl=args.cbca_impl, cbca_chunk_d=args.cbca_chunk_d,
        device=args.device, cost_volume_method=args.cost_volume_method)
    record["pipeline_setup_s"] = time.perf_counter() - t0
    print(f"weights on {device}: {record['pipeline_setup_s']:.2f}s",
          flush=True)

    with open(args.list_file) as f:
        record["scenes"] = sum(1 for line in f if line.strip())
    buckets = warmup_buckets(pipeline, args.list_file)
    record["buckets"] = []
    for bucket, (height, width, ndisp) in sorted(buckets.items()):
        zeros = np.zeros((height, width), dtype=np.float32)
        t0 = time.perf_counter()
        pipeline(zeros, zeros, ndisp)  # waits for the result on the host
        seconds = time.perf_counter() - t0
        record["buckets"].append({"bucket": list(bucket), "seconds": seconds})
        print(f"warmed {bucket}: {seconds:.1f}s", flush=True)
    record["reserved_device_gb"] = (
        torch.cuda.memory_reserved(device) / 1e9
        if device.type == "cuda" else None)
    record["total_s"] = time.perf_counter() - started
    print(f"warmup complete: {len(buckets)} buckets of {record['scenes']} "
          f"scenes in {record['total_s']:.1f}s", flush=True)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
