"""The benchmark's CPU tests: the harness and the reference importable,
torch on few threads, and the ``cuda`` marker for runs that need a card."""

import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))
torch.set_num_threads(2)

# a size a CPU test run holds: one D_pad of 128 lanes, two 16-column
# buckets across
TINY = {"height": 40, "width": 72, "ndisp": 24, "disparity_margin": 8,
        "scene_pool": 4, "check_pairs": 4, "trace_pairs": 2}


def tiny_cell(workload: str):
    from portbench import harness

    cell = harness.load_cell(workload, harness.manifest_with_put_off(),
                             overrides=TINY)
    cell.config["pipeline"] = dict(cell.config["pipeline"], bucket=8,
                                   cbca_chunk_d=0)
    return cell


@pytest.fixture
def tiny():
    return tiny_cell


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped without one")
