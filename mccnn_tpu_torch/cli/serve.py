"""Long-lived matching server on PyTorch (mccnn_tpu/cli/serve.py).

Protocol: newline-delimited requests on stdin, one JSON result per line on
stdout (logs go to stderr). Each request is

    <scene_dir> <out_dir>

where ``scene_dir`` holds the Middlebury-layout ``im0.png im1.png
calib.txt`` and ``out_dir`` receives ``disp0MCCNN.pfm`` /
``disp0MCCNN.pgm`` / ``timeMCCNN.txt``. An empty line or EOF shuts the
server down. After the warm-up phase the server prints
``{"event": "ready", "warmed": N}``; each response reads

    {"scene": ..., "seconds": ..., "mpix_per_s": ..., "t": ...,
     "warm": true, "ok": true}

Responses come in request order. Scene N is dispatched (enqueued on the
device, no sync) before scene N-1 is finalized (copied back and written),
so host I/O overlaps device work; when no further request is readable the
in-flight scene is finalized before the server blocks on stdin, so a
synchronous client gets each response as soon as the device finishes.

Usage:

    python -m mccnn_tpu_torch.cli.serve --resume weights.npz \
        [--device cuda] [--warmup_list scenes.txt] \
        [--warmup_shapes HxWxD,...] [--bucket 64] [--volume_dtype bfloat16]
"""

from __future__ import annotations

import argparse
import json
import os
import select
import sys
import time

import numpy as np


class _RequestReader:
    """Line reader that reports whether a request is immediately available.

    Reads raw bytes from the stream's fd when it has one, so Python-level
    readline buffering never hides pending lines from ``select``; fd-less
    streams (``io.StringIO``) use their own ``readline`` and never block.
    """

    def __init__(self, stream):
        self._stream = stream
        self._buf = b""
        self._eof = False
        try:
            self._fd = stream.fileno()
        except (AttributeError, OSError, ValueError):
            self._fd = None  # io.StringIO raises UnsupportedOperation

    def poll(self) -> bool:
        """True if ``readline`` would return without blocking."""
        if self._fd is None:
            return True
        while b"\n" not in self._buf and not self._eof:
            if not select.select([self._fd], [], [], 0)[0]:
                return False
            chunk = os.read(self._fd, 65536)
            if not chunk:
                self._eof = True
            self._buf += chunk
        return True

    def readline(self):
        """Next line without its newline, or ``None`` at EOF (blocking)."""
        if self._fd is None:
            line = self._stream.readline()
            return None if line == "" else line.rstrip("\n")
        while b"\n" not in self._buf and not self._eof:
            chunk = os.read(self._fd, 65536)
            if not chunk:
                self._eof = True
            self._buf += chunk
        if b"\n" in self._buf:
            raw, self._buf = self._buf.split(b"\n", 1)
        elif self._buf:
            raw, self._buf = self._buf, b""
        else:
            return None
        return raw.decode("utf-8", "replace")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description="long-lived stereo matching server (PyTorch port)",
    )
    parser.add_argument("--resume", type=str, required=True,
                        help="weights: native .npz or reference .npy dict")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; a CUDA request with no card fails")
    parser.add_argument("--warmup_list", type=str, default=None,
                        help="left-image list; warms each scene's shape bucket")
    parser.add_argument("--warmup_shapes", type=str, default=None,
                        help="comma-separated HxWxNDISP triples to warm")
    parser.add_argument("--bucket", type=int, default=64,
                        help="pad images to multiples of this")
    parser.add_argument("--cbca_impl", type=str, default="auto",
                        help="auto, fused or xla run kernel K2 on CUDA; "
                             "pallas is the exact-f32 single-pass kernel K7, "
                             "fused8 the int8 kernel K4, rolling the "
                             "row-rolling kernel K8, fused2 the two-round "
                             "kernel K9; fused16, rolling16 and fused2_16 "
                             "round the operands to bfloat16 on float32 "
                             "storage; mxu is torch matrix products")
    parser.add_argument("--volume_dtype", type=str, default="float32")
    parser.add_argument("--cbca_chunk_d", type=int, default=0)
    return parser


def bucket_of(pipeline, height: int, width: int, ndisp: int) -> tuple:
    """The shape a scene runs at: H and W padded to the pipeline's
    bucket, and its ndisp."""
    return (pipeline._bucketed(height), pipeline._bucketed(width), ndisp)


def warmup_buckets(pipeline, warmup_list=None, warmup_shapes=None) -> dict:
    """{bucket: a raw (H, W, ndisp) in it} of the scenes a left-image list
    names (each scene's calib.txt beside its image) and of the ``HxWxNDISP``
    triples of a comma-separated string."""
    from mccnn_tpu_torch.io.calib import parse_calib

    shapes = {}
    if warmup_list:
        with open(warmup_list) as f:
            for line in f:
                left_path = line.strip()
                if not left_path:
                    continue
                calib = os.path.join(os.path.dirname(left_path), "calib.txt")
                height, width, ndisp = parse_calib(calib)
                shapes[bucket_of(pipeline, height, width, ndisp)] = (
                    height, width, ndisp)
    if warmup_shapes:
        for triple in warmup_shapes.split(","):
            height, width, ndisp = (int(v) for v in triple.lower().split("x"))
            shapes[bucket_of(pipeline, height, width, ndisp)] = (
                height, width, ndisp)
    return shapes


def main(argv=None, stdin=None, stdout=None) -> None:
    args = build_parser().parse_args(argv)
    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout

    from mccnn_tpu_torch.data.dataset import load_grayscale
    from mccnn_tpu_torch.io.calib import parse_calib
    from mccnn_tpu_torch.io.middlebury import (
        save_disparity_pgm,
        save_time_file,
    )
    from mccnn_tpu_torch.io.pfm import write_pfm
    from mccnn_tpu_torch.models.params import load_any
    from mccnn_tpu_torch.pipeline.match import MatchPipeline, standardize_image

    pipeline = MatchPipeline(
        load_any(args.resume),
        bucket=args.bucket,
        volume_dtype=args.volume_dtype,
        cbca_impl=args.cbca_impl,
        cbca_chunk_d=args.cbca_chunk_d,
        device=args.device,
    )

    # ---- warm-up: run every announced shape bucket once (kernel build,
    # cuDNN algorithm choice, allocator pools) ----
    shapes = warmup_buckets(pipeline, args.warmup_list, args.warmup_shapes)
    warmed = set()
    for bucketed, (height, width, ndisp) in sorted(shapes.items()):
        zeros = np.zeros((height, width), dtype=np.float32)
        t0 = time.time()
        pipeline(zeros, zeros, ndisp)
        warmed.add(bucketed)
        print(f"warmed {bucketed}: {time.time() - t0:.1f}s",
              file=sys.stderr, flush=True)
    print(json.dumps({"event": "ready", "warmed": len(warmed)}),
          file=stdout, flush=True)

    # ---- serve loop: double-buffered dispatch / finalize ----
    pending = None  # (scene_dir, out_dir, t0, warm, height, width, handle)
    served = [0, 0.0]  # scenes finalized, wall seconds of the serve phase
    t_serve0 = time.time()

    def finalize():
        nonlocal pending
        if pending is None:
            return
        scene_dir, out_dir, t0, warm, height, width, handle = pending
        pending = None
        try:
            disparity = pipeline.fetch(handle)
            elapsed = time.time() - t0
            os.makedirs(out_dir, exist_ok=True)
            write_pfm(disparity, os.path.join(out_dir, "disp0MCCNN.pfm"))
            save_disparity_pgm(
                disparity, os.path.join(out_dir, "disp0MCCNN.pgm"))
            save_time_file(elapsed, os.path.join(out_dir, "timeMCCNN.txt"))
            served[0] += 1
            print(json.dumps({
                "scene": scene_dir,
                "seconds": round(elapsed, 4),
                "mpix_per_s": round(height * width / 1e6 / elapsed, 4),
                # completion time since the serve loop started: differences
                # between consecutive scenes are the overlapped throughput
                "t": round(time.time() - t_serve0, 4),
                "warm": warm,
                "ok": True,
            }), file=stdout, flush=True)
        except Exception as exc:  # noqa: BLE001 — a failed scene is reported
            print(json.dumps({"scene": scene_dir, "ok": False,
                              "error": str(exc)[:300]}),
                  file=stdout, flush=True)

    reader = _RequestReader(stdin)
    while True:
        if pending is not None and not reader.poll():
            # nothing readable: answer the in-flight scene before blocking
            finalize()
        line = reader.readline()
        if line is None:
            break
        line = line.strip()
        if not line:
            break
        try:
            scene_dir, out_dir = line.split()
            height, width, ndisp = parse_calib(
                os.path.join(scene_dir, "calib.txt"))
            warm = bucket_of(pipeline, height, width, ndisp) in warmed
            left = standardize_image(
                load_grayscale(os.path.join(scene_dir, "im0.png")))
            right = standardize_image(
                load_grayscale(os.path.join(scene_dir, "im1.png")))
            t0 = time.time()
            handle = pipeline.dispatch(left, right, ndisp)
            warmed.add(bucket_of(pipeline, height, width, ndisp))
            nxt = (scene_dir, out_dir, t0, warm, height, width, handle)
        except Exception as exc:  # noqa: BLE001 — a bad scene must not kill
            # the server; finalize the pending scene first (request order)
            finalize()
            print(json.dumps({"scene": line, "ok": False,
                              "error": str(exc)[:300]}),
                  file=stdout, flush=True)
            continue
        finalize()  # overlaps the freshly dispatched scene's device run
        pending = nxt
    finalize()
    if served[0]:
        served[1] = time.time() - t_serve0
        print(f"served {served[0]} scenes in {served[1]:.2f}s "
              f"({served[0] / served[1]:.2f} pairs/s)",
              file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
