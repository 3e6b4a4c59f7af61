"""Run every bench config and append its record to one JSONL log (the JAX
repo's tools/bench_all.py on PyTorch).

Each config runs in a fresh process (``python -m mccnn_tpu_torch.bench
--config C``; ``serve`` is ``python -m mccnn_tpu_torch.tools.bench_serve``),
so each starts with an empty allocator and its own cuDNN choices; the
kernel library is built by the first and reused by the rest. Each record
gets the config, whether it ran, the host, the device (``nvidia-smi``'s
name and power limit, or "cpu"), the commit, its wall seconds and the
time, and is appended to ``BENCH_torch_full.jsonl`` at the checkout root
(``BENCH_full.jsonl`` is the JAX bench's log).

    python -m mccnn_tpu_torch.tools.bench_all
        [--configs half,halfexact,quarter,full,train,serve]
        [--out BENCH_torch_full.jsonl] [--device cpu] [--commit SHA]

Exits 1 if any config failed (its record says why).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CONFIGS = ("half", "halfexact", "quarter", "full", "train", "serve")


def command(config: str, device: str) -> list:
    if config == "serve":
        return [sys.executable, "-m", "mccnn_tpu_torch.tools.bench_serve",
                "--device", device]
    return [sys.executable, "-m", "mccnn_tpu_torch.bench", "--config",
            config, "--device", device]


def run_config(config: str, device: str,
               timeout: float) -> subprocess.CompletedProcess:
    """One config in a fresh process; raises ``TimeoutExpired``."""
    return subprocess.run(command(config, device), capture_output=True,
                          text=True, timeout=timeout, cwd=ROOT)


def checkout_commit():
    """HEAD of the checkout, or None where it is no git repository."""
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                              capture_output=True, text=True, timeout=60,
                              check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--configs", default=",".join(DEFAULT_CONFIGS))
    parser.add_argument("--out", default=os.path.join(
        ROOT, "BENCH_torch_full.jsonl"))
    parser.add_argument("--timeout", type=float, default=3600.0,
                        help="seconds a config may take")
    parser.add_argument("--device", default="cuda",
                        help="torch device; a CUDA request with no card fails")
    parser.add_argument("--commit", default=None,
                        help="the commit measured (default: the checkout's "
                             "HEAD where it is a git repository)")
    return parser


def main(argv=None) -> int:
    from mccnn_tpu_torch.bench import device_label, resolve_device

    args = build_parser().parse_args(argv)

    device = device_label(resolve_device(args.device))
    commit = args.commit or checkout_commit()
    host = socket.gethostname()
    failures = 0
    with open(args.out, "a") as log:
        for config in args.configs.split(","):
            print(f"=== {config} ===", flush=True)
            t0 = time.perf_counter()
            try:
                proc = run_config(config, args.device, args.timeout)
            except subprocess.TimeoutExpired as exc:
                proc = subprocess.CompletedProcess(
                    exc.cmd, None, exc.stdout or "", exc.stderr or "")
            stdout = proc.stdout if isinstance(proc.stdout, str) else (
                proc.stdout.decode(errors="replace"))
            stderr = proc.stderr if isinstance(proc.stderr, str) else (
                proc.stderr.decode(errors="replace"))
            sys.stderr.write(stderr[-4000:])
            lines = [line.strip() for line in stdout.splitlines()
                     if line.strip().startswith("{")]
            if proc.returncode != 0 or not lines:
                failures += 1
                record = {"ok": False, "returncode": proc.returncode,
                          "stderr_tail": stderr[-500:]}
            else:
                record = {"ok": True, **json.loads(lines[-1])}
            record = {"config": config, **record}
            record.setdefault("device", device)
            record.update(host=host, commit=commit,
                          wall_seconds=time.perf_counter() - t0,
                          captured_at=time.strftime("%Y-%m-%d %H:%M:%S"))
            log.write(json.dumps(record) + "\n")
            log.flush()
            print(json.dumps(record), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
