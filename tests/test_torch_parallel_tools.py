"""The port's multi-process tools on gloo CPU ranks: the bring-up
(collectives, a sharded CBCA and a sharded match against the unsharded
calls) and the mid-scale comparison at a small size."""

import json

import pytest

pytest.importorskip("torch")

from mccnn_tpu_torch.tools import multichip_midscale  # noqa: E402
from mccnn_tpu_torch.tools import multiprocess_bringup  # noqa: E402


def test_bringup_tool_on_two_cpu_ranks(capsys):
    assert multiprocess_bringup.main(["--device", "cpu", "--ranks", "2",
                                      "--timeout", "120"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == "BRINGUP OK"


def test_midscale_tool_on_two_cpu_ranks(capsys):
    """fused8 (bf16 volumes) bit for bit, with its global amax reduced
    over the ranks; launch counts are 0 on the CPU (no kernel runs)."""
    impl = "fused8"
    assert multichip_midscale.main([
        "--device", "cpu", "--height", "64", "--width", "96", "--ndisp",
        "16", "--impl", impl, "--volume-dtype", "bfloat16", "--iterations",
        "3,1", "--timeout", "120"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "BRINGUP OK"
    results = [json.loads(line) for line in lines[:-1]]
    assert [r["rank"] for r in results] == [0, 1]
    for r in results:
        assert not multichip_midscale.failures(r, exact=impl == "fused8")
        assert set(r["launches"].values()) == {0}
        assert r["traffic"]["halo"] > 0 and r["traffic"]["reshard"] > 0
        if impl == "fused8":
            assert r["left_volume"]["bit_equal"]
            assert r["traffic"]["reduce"] > 0  # the global amax
