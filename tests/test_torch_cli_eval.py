"""``python -m mccnn_tpu_torch.cli.eval`` against ``python -m
mccnn_tpu.cli.eval``: on the same files both print the same table and write
the same report, flag for flag.
"""

import json

import numpy as np
import pytest

pytest.importorskip("torch")

from PIL import Image  # noqa: E402

from mccnn_tpu.cli import eval as jax_eval  # noqa: E402
from mccnn_tpu.io.pfm import write_pfm  # noqa: E402
from mccnn_tpu_torch.cli import eval as port_eval  # noqa: E402

from test_cli import _write_scene  # noqa: E402


@pytest.fixture()
def matched(tmp_path):
    """Three scenes with ground truth and a 'matched' map each (sceneC's is
    missing), sceneA with a non-occlusion mask."""
    rng = np.random.default_rng(4)
    data, save = tmp_path / "data", tmp_path / "out"
    for name in ("sceneA", "sceneB", "sceneC"):
        _write_scene(data / name, rng)
        if name == "sceneC":
            continue
        out = save / "submit_t0" / name
        out.mkdir(parents=True)
        noisy = 3.0 + rng.normal(0, 1.5, (24, 40)).astype(np.float32)
        write_pfm(noisy, str(out / "disp0MCCNN.pfm"))
    mask = np.full((24, 40), 255, np.uint8)
    mask[:, :6] = 128
    Image.fromarray(mask, mode="L").save(data / "sceneA" / "mask0nocc.png")
    (tmp_path / "list.txt").write_text(
        "".join(f"{data}/{n}/im0.png\n" for n in ("sceneA", "sceneB",
                                                  "sceneC")))
    return tmp_path


def _scene_argv(root, report, extra=()):
    return ["--list_file", str(root / "list.txt"), "--data_dir",
            str(root / "data"), "--save_dir", str(root / "out"), "--tag",
            "t0", "--report", str(report), *extra]


@pytest.mark.parametrize("extra", [
    [], ["--nonocc"], ["--thresholds", "1,3", "-s", "1"],
], ids=["all", "nonocc", "thresholds-start"])
def test_scene_mode_prints_what_the_jax_cli_prints(matched, capsys, extra):
    outputs, reports = [], []
    for cli, name in ((jax_eval, "jax.jsonl"), (port_eval, "port.jsonl")):
        capsys.readouterr()
        cli.main(_scene_argv(matched, matched / name, extra))
        captured = capsys.readouterr()
        outputs.append((captured.out, captured.err))
        reports.append([json.loads(line) for line in
                        (matched / name).read_text().splitlines()])
    assert outputs[0] == outputs[1]
    assert reports[0] == reports[1]
    out, err = outputs[1]
    assert "ALL (" in out and "skip" in err  # sceneC has no map yet
    if "--nonocc" in extra:
        assert reports[1][0]["n_valid"] == 24 * 34
        assert "warn" in err  # sceneB has no mask
    if "-s" in extra:
        assert [r["scene"].split("/")[-1] for r in reports[1]] == [
            "sceneB", "ALL"]
        assert set(reports[1][0]) >= {"bad_1", "bad_3"}


def test_direct_mode_and_errors(matched, capsys):
    gt = str(matched / "data" / "sceneA" / "disp0GT.pfm")
    pred = str(matched / "out" / "submit_t0" / "sceneA" / "disp0MCCNN.pfm")
    outs = []
    for cli in (jax_eval, port_eval):
        capsys.readouterr()
        cli.main(["--pred", pred, "--gt", gt, "--thresholds", "1,2"])
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert "ALL (1 scenes" in outs[1]
    for argv in (["--pred", pred], ["--list_file", "x"]):
        with pytest.raises(SystemExit):
            port_eval.main(argv)
    empty = matched / "empty.txt"
    empty.write_text("")
    with pytest.raises(SystemExit, match="no scenes scored"):
        port_eval.main(["--list_file", str(empty), "--data_dir", "d",
                        "--save_dir", "s", "--tag", "t"])


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.type, a.default, a.required,
                     a.nargs) for a in parser._actions if a.dest != "help"}


def test_same_flags_as_the_jax_cli():
    assert _options(port_eval.build_parser()) == _options(
        jax_eval.build_parser())
