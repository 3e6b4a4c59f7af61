"""A CPU rehearsal of each cell's loop at a tiny size: the harness's look
for a card is skipped, the rest of a run is driven through the port's CPU
path and the plain reference. The run on a card is marked ``cuda``."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
# the put-off open cell too: its loop is the harness's for later open cells
CELLS = [w["name"] for w in harness.manifest_with_put_off()["workloads"]]


@pytest.mark.parametrize("trace", [0, 1], ids=["timed", "traced"])
@pytest.mark.parametrize("workload", CELLS)
def test_cpu_rehearsal(tiny, workload, trace):
    cell = tiny(workload)
    seed = 2**31 + 17
    run, weights, pool = harness.drive(cell, seed, 0.5, bool(trace), "cpu")
    assert run.requests and all(r.output is not None for r in run.requests)
    assert all(r.pool < len(pool) for r in run.requests)
    families = {pool[r.pool]["family"] for r in run.requests}
    assert families <= set(cell.traffic["families"])
    numbers = harness.compare(run, weights, pool, seed, "cpu")
    # on the CPU the port runs its plain versions: the same maps
    assert numbers == {"bad_pct": 0.0, "mean_abs_px": 0.0}
    line = harness.result(run, numbers, bool(trace), "cpu")
    assert line["correct"] is True and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == set(cell.config["limits"])
    wanted = {m["name"] for m in (cell.per_layer if trace
                                  else cell.end_to_end)}
    assert set(line["metrics"]) <= wanted
    if trace:
        assert run.stretch and run.trace.spans
        assert "breakdown" in line and line["device"]["window_s"] > 0
        assert any(m.startswith("dispatch_ms") for m in line["metrics"])
    else:
        assert "setup_s" in line["metrics"]
    json.dumps(line, allow_nan=False)


@pytest.mark.cuda
def test_one_short_run_on_the_card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "half-stream-mix",
         "--seed", str(2**31 + 23), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ), check=True).stdout
    line = json.loads(out.splitlines()[-1])
    assert line["correct"] is True and line["device"]["count"] == 1
