"""Serving throughput through the real serve loop (the JAX repo's
tools/bench_serve.py on PyTorch).

Writes N synthetic Middlebury-layout scenes (``utils/scenes.py``'s
translation, slanted, textureless and occlusion families in turn, 8-bit
PNGs and calib.txt) and ``init_params(0)`` weights, then drives
``mccnn_tpu_torch.cli.serve`` in-process: its warm-up runs the shape
bucket once, then the serve loop streams the scenes through the
double-buffered dispatch / finalize path (scene N's device work overlaps
scene N-1's artifact writes and scene N+1's PNG decode). Reports each
scene's latency (dispatch to written) and the steady-state pairs/s
(completion to completion, the first scene dropped).

    python -m mccnn_tpu_torch.tools.bench_serve [--scenes 16]
        [--height 1000 --width 1504 --ndisp 200] [--client pipelined]
        [--device cpu] [--root build/bench_serve]

``--client pipelined`` (default) writes every request up front; ``sync``
waits for each response before sending the next request (request /
response latency). Both use real OS pipes, the fd / select path that
production stdin takes. The steady rate is taken over the gaps between
completions, 15 by default: a handful of gaps leaves it to a few host
stalls. Prints one JSON line with the device (``nvidia-smi``'s name
and power limit, or "cpu"); exits 1 unless every scene is answered ok and
its three artifacts are written.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FAMILIES = ("translation", "slanted", "textureless", "occlusion")
ARTIFACTS = ("disp0MCCNN.pfm", "disp0MCCNN.pgm", "timeMCCNN.txt")
SERVER_JOIN_S = 120.0


def write_scenes(root: str, count: int, height: int, width: int,
                 ndisp: int) -> list:
    """``count`` scenes under ``root/data``; the serve requests for them
    (outputs under ``root/out``)."""
    from mccnn_tpu_torch.tools.train_fullscale import write_png
    from mccnn_tpu_torch.utils.scenes import make_scene

    requests = []
    rng = np.random.default_rng(7)
    for i in range(count):
        scene_dir = os.path.join(root, "data", f"s{i:02d}")
        os.makedirs(scene_dir, exist_ok=True)
        scene = make_scene(FAMILIES[i % len(FAMILIES)], rng, height, width,
                           max_disparity=max(1, ndisp - 40))
        for name, image in (("im0.png", scene["left"]),
                            ("im1.png", scene["right"])):
            write_png(np.clip(image * 255.0, 0, 255).astype(np.uint8),
                      os.path.join(scene_dir, name))
        with open(os.path.join(scene_dir, "calib.txt"), "w") as f:
            f.write("cam0=[1 0 0]\ncam1=[1 0 0]\ndoffs=0\nbaseline=100\n"
                    f"width={width}\nheight={height}\nndisp={ndisp}\n")
        requests.append(
            f"{scene_dir} {os.path.join(root, 'out', f's{i:02d}')}\n")
    return requests


def drive_over_pipes(serve_main, serve_args, requests, sync: bool) -> list:
    """Run the server in a thread on real OS pipes; its output lines.

    ``sync=False`` writes every request up front (the pipe buffer holds
    them); ``sync=True`` waits for each scene's response before sending
    the next request. The server's end of the response pipe is closed when
    it returns or raises, so a failed server ends the read instead of
    hanging it, and its exception is raised here.
    """
    req_r, req_w = os.pipe()
    res_r, res_w = os.pipe()
    failure = []

    def serve():
        with os.fdopen(req_r, "r") as stdin, os.fdopen(res_w, "w") as stdout:
            try:
                serve_main(serve_args, stdin=stdin, stdout=stdout)
            except Exception as exc:  # noqa: BLE001 — raised again below
                failure.append(exc)

    server = threading.Thread(target=serve, daemon=True)
    server.start()
    lines, buf = [], b""

    def next_line():
        nonlocal buf
        while b"\n" not in buf:
            chunk = os.read(res_r, 65536)
            if not chunk:
                return None
            buf += chunk
        raw, buf = buf.split(b"\n", 1)
        lines.append(raw.decode())
        return lines[-1]

    try:
        try:
            with os.fdopen(req_w, "w") as writer:
                if next_line() is not None:  # the ready event (warmed up)
                    if sync:
                        for request in requests:
                            writer.write(request)
                            writer.flush()
                            if next_line() is None:
                                break
                    else:
                        writer.write("".join(requests))
        except BrokenPipeError:
            pass  # the server ended early: its exception is raised below
        while next_line() is not None:  # the rest, until the server ends
            pass
        server.join(timeout=SERVER_JOIN_S)
    finally:
        os.close(res_r)
    if failure:
        raise failure[0]
    if server.is_alive():
        raise RuntimeError(f"the server did not end within {SERVER_JOIN_S} s")
    return lines


def measure(requests: list, weights: str, args) -> dict:
    """Serve ``requests`` with one client; the record."""
    from mccnn_tpu_torch.bench import device_label, resolve_device
    from mccnn_tpu_torch.cli.serve import main as serve_main

    label = device_label(resolve_device(args.device))
    serve_args = ["--resume", weights, "--device", args.device,
                  "--bucket", str(args.bucket),
                  "--volume_dtype", args.volume_dtype,
                  "--warmup_shapes", f"{args.height}x{args.width}x{args.ndisp}"]
    t0 = time.perf_counter()
    lines = drive_over_pipes(serve_main, serve_args, requests,
                             sync=args.client == "sync")
    total = time.perf_counter() - t0
    responses = [json.loads(line) for line in lines]
    ready, scenes = responses[0], responses[1:]
    if ready.get("event") != "ready" or ready.get("warmed") != 1:
        raise RuntimeError(f"no warm-up event: {ready}")
    ok = [r for r in scenes if r.get("ok")]
    missing = [os.path.join(request.split()[1], name)
               for request in requests for name in ARTIFACTS
               if not os.path.exists(os.path.join(request.split()[1], name))]
    latencies = [r["seconds"] for r in ok]
    steady = ((len(ok) - 1) / (ok[-1]["t"] - ok[0]["t"])
              if len(ok) > 1 and ok[-1]["t"] > ok[0]["t"] else None)
    return {
        "metric": "serve_throughput_pairs_per_s",
        "value": steady,
        "unit": "pairs/s",
        "client": args.client,
        "scenes": len(requests),
        "answered_ok": len(ok),
        "missing_artifacts": len(missing),
        "latencies_s": latencies,
        "median_latency_s": (float(np.median(latencies)) if latencies
                             else None),
        "bucket": [args.height, args.width, args.ndisp],
        "volume_dtype": args.volume_dtype,
        "total_wall_s": total,
        "device": label,
    }


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description="serving throughput through cli.serve")
    parser.add_argument("--scenes", type=int, default=16)
    parser.add_argument("--height", type=int, default=1000)
    parser.add_argument("--width", type=int, default=1504)
    parser.add_argument("--ndisp", type=int, default=200)
    parser.add_argument("--bucket", type=int, default=64)
    parser.add_argument("--root", type=str,
                        default=os.path.join(ROOT, "build", "bench_serve"))
    parser.add_argument("--volume_dtype", type=str, default="bfloat16")
    parser.add_argument("--client", type=str, default="pipelined",
                        choices=["pipelined", "sync"],
                        help="pipelined: every request up front over a real "
                             "pipe; sync: each response before the next "
                             "request")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; a CUDA request with no card fails")
    return parser


def run(argv=None) -> dict:
    """Write the scenes and weights, serve them; the record (printed as
    one JSON line)."""
    from mccnn_tpu_torch.models.net import init_params
    from mccnn_tpu_torch.models.params import save_params

    args = build_parser().parse_args(argv)
    shutil.rmtree(args.root, ignore_errors=True)
    requests = write_scenes(args.root, args.scenes, args.height, args.width,
                            args.ndisp)
    weights = os.path.join(args.root, "weights.npz")
    save_params(init_params(0), weights)
    record = measure(requests, weights, args)
    print(json.dumps(record), flush=True)
    return record


def main(argv=None) -> int:
    record = run(argv)
    failed = (record["answered_ok"] != record["scenes"]
              or record["missing_artifacts"])
    if failed:
        print(f"served {record['answered_ok']}/{record['scenes']} ok, "
              f"{record['missing_artifacts']} artifacts missing",
              file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
