"""The sweep that fixes an open-loop cell's rate, on the card, in one
process.

    python benchmark/sweep_rate.py --workload half-open-mix --seed 7

The workload may be one of ``benchmark/put_off.json``'s cells.

It measures the closed loop's rate (pairs/s, one pair ahead) over one
window of ``run_seconds`` (``BENCHMARK.json``), then offers the open loop
at each of ``FRACTIONS`` of it, each over one such window, with the
cell's own arrivals: its traffic file's gaps in its ``arrivals_seed``
order, scaled to the rate. A line a rate: the latency's median and 95th
percentile, the rate answered over the span from the first arrival to the
last answer, and the mean latency of the last quarter of requests over the
first quarter's.

A rate is sustained where (a) the answered rate is at least ``KEEPS_UP``
of the offered one, so no backlog is left at the window's end, and (b) the
95th percentile is at most ``TAIL_GROWTH`` times that of the lowest rate,
so the queue's tail has not yet turned up. The knee is the highest rate
that is sustained with every lower one; the last line gives it and the
cell's rate, 80% of it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

FRACTIONS = (0.55, 0.60, 0.65, 0.70, 0.75, 0.80, 0.85, 0.90)
KEEPS_UP = 0.97
TAIL_GROWTH = 2.0
CELL_SHARE = 0.8


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, default=7)
    args = parser.parse_args(argv)
    from mccnn_tpu_torch.kernels import build
    from portbench import harness
    from portbench.readers import nearest_rank

    cell = harness.load_cell(args.workload, harness.manifest_with_put_off())
    config, traffic = cell.config, cell.traffic
    seconds = harness.read_json(harness.ROOT / "BENCHMARK.json")[
        "run_seconds"]
    build.library()
    weights, biases = harness.make_weights(args.seed, config["net"], "cuda")
    pipeline = harness._pipeline(harness.params_tree(weights, biases),
                                 config, "cuda", None)
    pool = harness.make_pool(args.seed, config, traffic, "cuda")
    server = harness.Server(pipeline, pool, config["ndisp"])
    harness._warm(server, len(pool), "cuda")

    t0 = time.perf_counter()
    reqs = harness.closed_loop(server, len(pool), seconds)
    capacity = len(reqs) / (max(r.t_done for r in reqs) - t0)
    print(json.dumps({"window_s": seconds,
                      "closed_loop_pairs_per_s": capacity}), flush=True)
    first, lowest_p95, knee, unbroken = len(reqs), None, None, True
    for fraction in FRACTIONS:
        rate = fraction * capacity
        count = max(8, round(rate * seconds))
        dues = harness.due_times(traffic["arrivals_seed"], count,
                                 count / rate)
        reqs = harness.open_loop(server, len(pool), dues, first)
        first += len(reqs)
        lat = [r.t_done - r.due for r in reqs if r.output is not None]
        quarter = max(1, len(lat) // 4)
        start = min(r.due for r in reqs)
        answered = len(lat) / (max(r.t_done for r in reqs) - start)
        p95 = nearest_rank(lat, 0.95)
        lowest_p95 = p95 if lowest_p95 is None else lowest_p95
        sustained = (answered >= KEEPS_UP * rate
                     and p95 <= TAIL_GROWTH * lowest_p95)
        unbroken = unbroken and sustained
        if unbroken:
            knee = {"fraction": fraction, "rate_pairs_per_s": rate}
        print(json.dumps({
            "fraction": fraction, "rate_pairs_per_s": rate,
            "requests": count, "answered": len(lat),
            "answered_per_s": answered,
            "keeps_up": answered / rate,
            "latency_p50_s": statistics.median(lat),
            "latency_p95_s": p95,
            "backlog_growth": statistics.fmean(lat[-quarter:])
            / statistics.fmean(lat[:quarter]),
            "sustained": sustained,
        }), flush=True)
    print(json.dumps({"knee": knee, "cell_rate_pairs_per_s":
                      None if knee is None
                      else CELL_SHARE * knee["rate_pairs_per_s"]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
