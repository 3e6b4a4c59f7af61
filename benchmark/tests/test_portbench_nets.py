"""The weights a configuration's ``net`` draws from the seed, and the
program's weight tree made of them, for the fast and the accurate net."""

import hashlib
import math

import pytest
import torch
from torch.nn import functional as F

from portbench import harness
from portbench.scenes import make_pair

# SHA-256 of the fast net's weights then biases, made on the CPU by the
# harness before it took fully connected layers: the fast cells' weights
# may not change by a bit
FAST_SHA256 = {
    0: "20bb72d2684a3c4e44ffc9811317eefb9242ef56085ed87d442946281af9c9a4",
    7: "01b0099b6003340b31979112c4b15a19db7cd962c28885e57930f41abf4601ca",
}
ACCURATE = {"patch_size": 11, "num_layers": 5, "num_maps": 112,
            "kernel_size": 3, "input_channels": 1, "bias_range": 0.05,
            "num_fc_layers": 3, "num_fc_units": 384}


@pytest.mark.parametrize("seed", sorted(FAST_SHA256))
@pytest.mark.parametrize("workload", ["half-stream-mix", "full-stream-mix"])
def test_fast_weights_are_the_same_bits(workload, seed):
    net = harness.load_cell(workload).config["net"]
    assert "num_fc_layers" not in net
    weights, biases = harness.make_weights(seed, net, "cpu")
    assert [tuple(w.shape) for w in weights] == [(64, 1, 3, 3)] + [
        (64, 64, 3, 3)] * 4
    assert [tuple(b.shape) for b in biases] == [(64,)] * 5
    digest = hashlib.sha256()
    for t in weights + biases:
        digest.update(t.contiguous().numpy().tobytes())
    assert digest.hexdigest() == FAST_SHA256[seed]


def test_accurate_weights_every_layer_in_order_at_its_he_range():
    weights, biases = harness.make_weights(2**31 + 11, ACCURATE, "cpu")
    assert [tuple(w.shape) for w in weights] == (
        [(112, 1, 3, 3)] + [(112, 112, 3, 3)] * 4
        + [(384, 224), (384, 384), (384, 384), (1, 384)])
    assert [tuple(b.shape) for b in biases] == [(112,)] * 5 + [(384,)] * 3 \
        + [(1,)]
    assert sum(b.numel() for b in biases) == 5 * 112 + 3 * 384 + 1
    fans_in = [9] + [112 * 9] * 4 + [224, 384, 384, 384]
    for w, fan_in in zip(weights, fans_in):
        limit = math.sqrt(6.0 / fan_in)
        top = float(w.abs().max())
        assert top <= limit and top > 0.9 * limit
    assert all(float(b.abs().max()) <= 0.05 for b in biases)
    again, _ = harness.make_weights(2**31 + 11, ACCURATE, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(weights, again))


def _accurate_s(weights, biases, left, right, ndisp):
    """The accurate net's s at every pixel and disparity of a pair whose
    columns all hold a right patch, plainly: ReLU after each convolution,
    fc1 on [left ; right], ReLU after each hidden layer, a sigmoid."""
    def descriptors(image):
        x = torch.from_numpy(image)[None, None]
        for w, b in zip(weights[:5], biases[:5]):
            x = F.relu(F.conv2d(x, w, b))
        return x[0]

    left, right = descriptors(left), descriptors(right)
    cols = torch.arange(ndisp - 1, left.shape[2])
    s = []
    for d in range(ndisp):
        x = torch.cat([left[:, :, cols], right[:, :, cols - d]]).permute(
            1, 2, 0)
        for w, b in zip(weights[5:-1], biases[5:-1]):
            x = F.relu(F.linear(x, w, b))
        s.append(torch.sigmoid(F.linear(x, weights[-1], biases[-1]))[..., 0])
    return torch.stack(s, -1)


def _spread_and_ties(weights, biases, family, seed):
    ndisp = 48
    left, right = make_pair(family, seed, 0, 64, 160, ndisp - 8, "cpu")
    s = _accurate_s(weights, biases, left, right, ndisp)
    best = s.bfloat16()
    tied = (best == best.amax(-1, keepdim=True)).sum(-1) > 1
    return float((s.amax(-1) - s.amin(-1)).mean()), float(
        tied.float().mean())


@pytest.mark.parametrize("family", ["translation", "slanted"])
@pytest.mark.parametrize("seed", [0, 7])
def test_accurate_seeded_costs_carry_a_signal(seed, family):
    """He weights spread s over the disparities (0.21-0.36 measured) and
    leave few pixels with a tied best bf16 cost (0.08-0.18)."""
    weights, biases = harness.make_weights(seed, ACCURATE, "cpu")
    spread, tied = _spread_and_ties(weights, biases, family, seed)
    assert spread >= 0.1
    assert tied <= 0.3


def test_accurate_costs_at_the_glorot_limit_are_flat():
    """Why the accurate net draws at the He limit: the same tensors scaled
    to the Glorot limit spread s by less than one bf16 step at 0.5
    (0.0035 measured), and most pixels' best bf16 cost is tied."""
    weights, biases = harness.make_weights(0, ACCURATE, "cpu")
    glorot = []
    for w in weights:
        receptive = math.prod(w.shape[2:])
        fan_in, fan_out = receptive * w.shape[1], receptive * w.shape[0]
        glorot.append(w * math.sqrt(fan_in / (fan_in + fan_out)))
    spread, tied = _spread_and_ties(glorot, biases, "translation", 0)
    assert spread < 2.0**-8
    assert tied > 0.5


def test_params_tree_conv_hwio_and_fc_in_out_left_first():
    weights, biases = harness.make_weights(3, ACCURATE, "cpu")
    tree = harness.params_tree(weights, biases)
    for i in range(5):
        conv = tree[f"conv{i + 1}"]
        assert torch.equal(torch.from_numpy(conv["w"]),
                           weights[i].permute(2, 3, 1, 0))
        assert torch.equal(torch.from_numpy(conv["b"]), biases[i])
    for j in range(4):
        fc = tree[f"fc{j + 1}"]
        assert torch.equal(torch.from_numpy(fc["w"]), weights[5 + j].t())
        assert fc["b"].shape == (weights[5 + j].shape[0],)
    # fc1's first 112 input rows take the left patch's descriptor
    gen = torch.Generator().manual_seed(0)
    left, right = torch.randn(2, 6, 112, generator=gen)
    w1, b1 = (torch.from_numpy(tree["fc1"][k]) for k in ("w", "b"))
    halves = left @ w1[:112] + right @ w1[112:] + b1
    torch.testing.assert_close(
        halves, F.linear(torch.cat([left, right], -1), weights[5], biases[5]))


def test_params_tree_of_the_fast_net_is_convolutions_only():
    weights, biases = harness.make_weights(
        0, harness.load_cell("half-stream-mix").config["net"], "cpu")
    tree = harness.params_tree(weights, biases)
    assert list(tree) == [f"conv{i}" for i in range(1, 6)]
    assert tree["conv2"]["w"].shape == (3, 3, 64, 64)
