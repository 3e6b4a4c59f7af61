"""The port's benchmark: one run of one cell on the card it starts on.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout. The cell, its configuration, its traffic
and its metrics are read from ``BENCHMARK.json`` and the files under
``benchmark/``. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number of the
comparison with the plain reference beside its limit, which also close
standard error. Earlier lines give the set-up's phases, the kernel
launches of the window and, for an open loop, how late the generator ran.

Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), and if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _cache_dirs() -> None:
    """Keep every compiler cache inside the checkout, at fixed paths (the
    kernel library itself is built under ``build/mccnn_tpu_torch/``)."""
    cache = ROOT / "build" / "portbench-cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "cuda"))


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    seed = args.seed % 2**63

    _cache_dirs()
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(ROOT))
    from portbench import harness

    cell = harness.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        log(f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.zeros(1, device="cuda")  # the CUDA context, counted as process
    process_s = harness.process_age()

    run, weights, pool = harness.drive(cell, seed, args.seconds,
                                       bool(args.trace), "cuda")
    run.setup["process_s"] = process_s
    print(json.dumps({"setup": run.setup, "setup_s": run.setup_s,
                      "launches": run.launches}), flush=True)
    if cell.traffic["loop"] == "open":
        lags = sorted(r.t_dispatch - r.due for r in run.requests
                      if r.after_wait and not math.isnan(r.t_dispatch))
        print(json.dumps({"generator_lag_ms": {
            "requests_after_a_wait": len(lags),
            "median": 1e3 * lags[len(lags) // 2] if lags else None,
            "max": 1e3 * lags[-1] if lags else None}}), flush=True)

    numbers = harness.compare(run, weights, pool, seed, "cuda")
    log(f"compared: {json.dumps(numbers)}")
    line = harness.result(run, numbers, bool(args.trace),
                          torch.cuda.get_device_name(0))
    found = harness.forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {', '.join(found)}")
        return 3
    print(json.dumps(line), flush=True)
    for name, check in line["checks"].items():
        log(f"check {name} {check['value']!r} limit {check['limit']!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
