"""BENCHMARK.json against its files and the benchmark's contract."""

import copy
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
                    r"|_rank$|head|expansion|per_tok|num_maps|kernel"
                    r"|fc_units)")
# the paper's nets for Middlebury (arXiv:1510.05970, its table of
# hyperparameters): a configuration's ``net`` states one of them whole
PUBLISHED_NETS = {
    "fast": {"num_layers": 5, "num_maps": 64, "kernel_size": 3,
             "num_fc_layers": 0, "num_fc_units": 0},
    "accurate": {"num_layers": 5, "num_maps": 112, "kernel_size": 3,
                 "num_fc_layers": 3, "num_fc_units": 384},
}


def published_net(net: dict):
    """The name of the published net that ``net`` states on every key of
    the table (absent fully connected keys read 0), or None."""
    return next((name for name, row in PUBLISHED_NETS.items()
                 if all(net.get(k, 0) == v for k, v in row.items())), None)


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
        assert published_net(data["net"]), config["name"]
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}


ACCURATE_NET = {"patch_size": 11, "num_layers": 5, "num_maps": 112,
                "kernel_size": 3, "input_channels": 1, "bias_range": 0.05,
                "num_fc_layers": 3, "num_fc_units": 384}


@pytest.mark.parametrize("change, name", [
    ({}, "fast"),
    ({"num_fc_layers": 0, "num_fc_units": 0}, "fast"),
    ({"num_maps": 112}, None),
    ({"num_fc_layers": 3, "num_fc_units": 384}, None),
    ({"num_maps": 112, "num_fc_layers": 3, "num_fc_units": 384}, "accurate"),
    ({"num_maps": 112, "num_fc_layers": 3, "num_fc_units": 256}, None),
    ({"num_maps": 112, "num_fc_layers": 2, "num_fc_units": 384}, None),
    ({"kernel_size": 5}, None),
])
def test_published_net_is_a_row_of_the_table(change, name):
    fast = json.loads((ROOT / MANIFEST["configs"][0]["file"]).read_text())
    assert published_net(dict(fast["net"], **change)) == name


def test_a_new_architecture_needs_new_files_only(tmp_path):
    """An accurate-net configuration in a file of its own, and a cell on
    it, go through ``load_cell``, ``make_weights``, ``params_tree``,
    ``arith`` and this file's checks with no edit to an existing file: a
    run up to building the program."""
    from portbench import arith

    base = json.loads((ROOT / MANIFEST["configs"][0]["file"]).read_text())
    name = "mccnn-accurate-mb-half-bf16"
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(dict(base, name=name, net=ACCURATE_NET)))
    manifest = copy.deepcopy(MANIFEST)
    manifest["configs"].append({"name": name, "source": "arXiv:1510.05970",
                                "file": str(path), "reduced": [],
                                "why": "MC-CNN accurate"})
    manifest["workloads"].append({"name": "half-accurate-stream-mix",
                                  "config": name, "traffic": "stream-mix",
                                  "chips": 1, "why": "the decision network"})
    cell = harness.load_cell("half-accurate-stream-mix", manifest)
    config = cell.config
    assert config["name"] == name and cell.traffic["loop"] == "closed"
    assert published_net(config["net"]) == "accurate"
    assert not any(WIDTHS.search(k) for k in config["reduced"])

    weights, biases = harness.make_weights(2**31 + 5, config["net"], "cpu")
    tree = harness.params_tree(weights, biases)
    assert list(tree) == [f"conv{i}" for i in range(1, 6)] + [
        f"fc{j}" for j in range(1, 5)]
    assert tree["conv5"]["w"].shape == (3, 3, 112, 112)
    assert tree["fc1"]["w"].shape == (224, 384)
    assert tree["fc4"]["w"].shape == (384, 1)

    stages = arith.pair_stage_flops(config["height"], config["width"],
                                    config["ndisp"], 18, "bfloat16",
                                    config["net"])
    assert "decision" in stages and "band" not in stages
    run = harness.Run(cell=cell)
    run.window = (0.0, 10.0)
    req = harness.Request(0, 0, 0.0, config["height"] * config["width"])
    req.output = object()
    run.requests.append(req)
    mfu = harness.metric_reader("pair_mfu.stream")(run)
    ideal = arith.ideal_pair_seconds(1000, 1504, 200, 18, "bfloat16",
                                     ACCURATE_NET)
    assert mfu == pytest.approx(100 * ideal / 10.0)


def test_manifest_is_small():
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
