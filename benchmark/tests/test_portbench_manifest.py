"""BENCHMARK.json against its files and the benchmark's contract."""

import json
import re
import statistics  # noqa: F401  (the readers' own imports are exercised)
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
# with the put-off cells of benchmark/put_off.json, whose files are kept
MERGED = harness.manifest_with_put_off()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$"
                    r"|_rank$|head|expansion|per_tok|num_maps|kernel)")


def test_top_level_keys_and_paths():
    assert set(MANIFEST) == KEYS
    assert MANIFEST["paths"] == ["benchmark"]
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert (ROOT / "benchmark" / "run.py").is_file()
    assert 1 <= MANIFEST["run_seconds"] <= 51


def test_run_seconds_fit_the_check_with_24_cells():
    r = MANIFEST["run_seconds"]
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", MERGED["workloads"],
                         ids=lambda c: c["name"])
def test_cell_files_are_found_by_name(cell):
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    assert cell["config"] in configs
    assert (ROOT / configs[cell["config"]]["file"]).is_file()
    assert (ROOT / "benchmark" / "traffic"
            / f"{cell['traffic']}.json").is_file()
    loaded = harness.load_cell(cell["name"], MERGED)
    assert loaded.config["name"] == cell["config"]
    assert cell["chips"] == 1
    assert len(cell["why"]) <= 200 and "\n" not in cell["why"]
    reported = {m["name"] for m in loaded.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert loaded.per_layer
    ref = ROOT / "benchmark" / "reference" / (
        f"{loaded.config['reference']}.py")
    assert ref.is_file()


@pytest.mark.parametrize(
    "metric", MERGED["end_to_end"] + MERGED["per_layer"],
    ids=lambda m: m["name"])
def test_metric_reader_is_found_by_name(metric):
    assert callable(harness.metric_reader(metric["name"]))
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    for cell in metric.get("workloads", []):
        assert cell in {w["name"] for w in MERGED["workloads"]}


def test_bounds():
    for metric in MANIFEST["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    setup = next(m for m in MANIFEST["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25


def test_each_per_layer_metric_moves_what_its_cells_report():
    for metric in MERGED["per_layer"]:
        moved = next(m for m in MERGED["end_to_end"]
                     if m["name"] == metric["moves"])
        cells = metric.get("workloads",
                           [w["name"] for w in MERGED["workloads"]])
        for cell in cells:
            assert harness._applies(moved, cell), (metric["name"], cell)
        assert "\n" not in metric["layer"] and len(metric["layer"]) <= 200


def test_names_unique_and_configs_uncut():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in MERGED[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    metrics = [m["name"] for m in MERGED["end_to_end"]
               + MERGED["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for config in MANIFEST["configs"]:
        assert config["file"].startswith("benchmark/")
        assert not any(WIDTHS.search(k) for k in config["reduced"])
        data = json.loads((ROOT / config["file"]).read_text())
        assert data["reduced"] == config["reduced"]
        assert data["net"]["num_maps"] == 64
        assert data["net"]["num_layers"] == 5
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}


def test_manifest_is_small():
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
