"""Readings for the comparison's limits, on the card, in one process.

    python benchmark/calibrate.py --workload <cell> --seeds 11,12,...
        [--control-seeds 21,22,23]

For each seed of ``--seeds`` the program runs the cell's pool once through
its closed loop and the comparison with the plain reference gives its
numbers: the lower readings. For each seed of ``--control-seeds`` the same
with the control switched on: the program's int8 CBCA storage
(``cbca_impl="fused8"``), the step below the configuration's bf16
volumes. One JSON line a seed; the kernel library is built once.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

# the step below the configurations' bf16 volumes: int8 CBCA storage
CONTROL = {"cbca_impl": "fused8"}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    args = parser.parse_args(argv)
    from portbench import harness

    cell = harness.load_cell(args.workload)
    runs = [(int(s), None) for s in args.seeds.split(",") if s]
    runs += [(int(s), CONTROL) for s in args.control_seeds.split(",") if s]
    for seed, overrides in runs:
        t0 = time.perf_counter()
        run, weights, pool = harness.drive(
            cell, seed, 0.0, False, "cuda",
            pipeline_overrides=overrides, pairs=cell.config["scene_pool"])
        numbers = harness.compare(run, weights, pool, seed, "cuda")
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "control": (overrides or {}).get("cbca_impl"),
            "failed": harness.count_failed(run), **numbers,
            "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
