"""mccnn_tpu_torch's training checkpoints against mccnn_tpu's.

One archive format for both packages: each loads the other's
``model_epoch{N}.npz`` (params in HWIO, the momentum traces as
``opt_leaf_{i}`` in ``jax.tree.flatten`` order), and the port refuses
archives whose optimizer leaves have a gap or a wrong count.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import optax  # noqa: E402

from mccnn_tpu.models import params as jparams  # noqa: E402
from mccnn_tpu.utils import checkpoint as jckpt  # noqa: E402
from mccnn_tpu.utils.config import TrainConfig  # noqa: E402
from mccnn_tpu_torch.models import net as tnet  # noqa: E402
from mccnn_tpu_torch.pipeline import train as ttrain  # noqa: E402
from mccnn_tpu_torch.utils import checkpoint as tckpt  # noqa: E402

from torch_parity import border_batch, jax_params  # noqa: E402

CONFIG = TrainConfig(batch_size=16)


def _opt_state(momentum):
    """An optax sgd(momentum) state holding ``momentum`` as its trace."""
    state = optax.sgd(CONFIG.learning_rate, momentum=CONFIG.beta).init(
        momentum)
    return (state[0]._replace(trace=momentum),) + tuple(state[1:])


def _scaled(tree, factor):
    return {n: {k: (v * factor).astype(np.float32) for k, v in layer.items()}
            for n, layer in tree.items()}


def _assert_trees_equal(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        assert sorted(got[name]) == sorted(want[name])
        for kind in want[name]:
            np.testing.assert_array_equal(got[name][kind],
                                          np.asarray(want[name][kind]))


def test_port_checkpoint_loads_in_jax(tmp_path):
    params = jax_params()
    momentum = _scaled(params, 0.25)
    path = tckpt.save_checkpoint(str(tmp_path), 4, params, momentum)
    assert path.endswith("model_epoch4.npz")
    restored = jckpt.load_checkpoint(
        path, {"params": params, "opt_state": _opt_state(_scaled(params, 0))})
    _assert_trees_equal(jax.tree.map(np.asarray, restored["params"]), params)
    _assert_trees_equal(
        jax.tree.map(np.asarray, restored["opt_state"][0].trace), momentum)
    _assert_trees_equal(jparams.load_any(path), params)


def test_jax_checkpoint_loads_in_port(tmp_path):
    params = jax_params()
    momentum = _scaled(params, -0.5)
    path = jckpt.save_checkpoint(str(tmp_path), 7, params,
                                 _opt_state(momentum))
    restored = tckpt.load_checkpoint(
        path, {"params": params, "momentum": params})
    _assert_trees_equal(restored["params"], params)
    _assert_trees_equal(restored["momentum"], momentum)
    # weights only: the momentum is not read
    assert tckpt.load_checkpoint(path, {"params": params, "momentum": None})[
        "momentum"] is None
    assert tckpt.epoch_of(path) == 7
    assert tckpt.latest_checkpoint(str(tmp_path)) == path


def test_leaf_order_is_a_string_sort_at_ten_layers(tmp_path):
    """With 10 layers the flatten order puts conv10 before conv2; both
    packages write and read it so."""
    params = {f"conv{i}": {"b": np.full((2 + i,), i, np.float32),
                           "w": np.full((3, 3, 2, 2 + i), i, np.float32)}
              for i in range(1, 11)}
    momentum = _scaled(params, 3.0)
    path = tckpt.save_checkpoint(str(tmp_path / "port"), 1, params, momentum)
    with np.load(path) as data:
        assert int(data["num_opt_leaves"]) == 20
        np.testing.assert_array_equal(data["opt_leaf_2"],
                                      momentum["conv10"]["b"])
    want = jax.tree.leaves(_opt_state(momentum))
    got = jax.tree.leaves(jckpt.load_checkpoint(
        path, {"params": params,
               "opt_state": _opt_state(_scaled(params, 0))})["opt_state"])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    path = jckpt.save_checkpoint(str(tmp_path / "jax"), 1, params,
                                 _opt_state(momentum))
    _assert_trees_equal(tckpt.load_checkpoint(
        path, {"params": params, "momentum": params})["momentum"], momentum)


def test_legacy_leaf_archive_reads_as_jax_reads(tmp_path):
    params = jax_params()
    momentum = _scaled(params, 2.0)
    leaves = jax.tree.leaves({"opt_state": _opt_state(momentum),
                              "params": params})
    path = str(tmp_path / "model_epoch2.npz")
    np.savez(path, num_leaves=np.asarray(len(leaves)),
             **{f"leaf_{i}": np.asarray(v) for i, v in enumerate(leaves)})
    restored = tckpt.load_checkpoint(path, {"params": params,
                                            "momentum": params})
    _assert_trees_equal(restored["params"], params)
    _assert_trees_equal(restored["momentum"], momentum)
    want = jckpt.load_checkpoint(
        path, {"params": params, "opt_state": _opt_state(_scaled(params, 0))})
    _assert_trees_equal(restored["params"],
                        jax.tree.map(np.asarray, want["params"]))


def _rewrite(path, drop=(), **extra):
    with np.load(path) as data:
        payload = {k: data[k] for k in data.files if k not in drop}
    payload.update(extra)
    np.savez(path, **payload)


@pytest.mark.parametrize("fault", ["gap", "count", "no_count_key",
                                   "weights_only", "other_optimizer"])
def test_optimizer_leaves_read_by_index(tmp_path, fault):
    """A gap in ``opt_leaf_*`` or a ``num_opt_leaves`` that differs from the
    leaves present is refused; an archive without the count key whose
    leaves run 0..n-1 is read (as JAX reads it)."""
    params = jax_params()
    momentum = _scaled(params, 0.5)
    path = tckpt.save_checkpoint(str(tmp_path), 1, params, momentum)
    like = {"params": params, "momentum": params}
    if fault == "gap":
        _rewrite(path, drop=("opt_leaf_3", "num_opt_leaves"))
        with pytest.raises(ValueError, match=r"leaves \[3\] missing"):
            tckpt.load_checkpoint(path, like)
    elif fault == "count":
        _rewrite(path, num_opt_leaves=np.asarray(11))
        with pytest.raises(ValueError, match="num_opt_leaves is 11"):
            tckpt.load_checkpoint(path, like)
    elif fault == "no_count_key":
        _rewrite(path, drop=("num_opt_leaves",))
        _assert_trees_equal(tckpt.load_checkpoint(path, like)["momentum"],
                            momentum)
    elif fault == "weights_only":
        path = tckpt.save_checkpoint(str(tmp_path), 2, params)
        with pytest.raises(ValueError, match="no optimizer state"):
            tckpt.load_checkpoint(path, like)
    else:
        with pytest.raises(ValueError, match="optimizer leaves but"):
            tckpt.load_checkpoint(path, {"params": params, "momentum": {
                "conv1": params["conv1"]}})


def test_prune_keeps_the_newest(tmp_path):
    params = {"conv1": {"w": np.zeros(3, np.float32),
                        "b": np.zeros(1, np.float32)}}
    for epoch in range(1, 6):
        tckpt.save_checkpoint(str(tmp_path), epoch, params, max_to_keep=3)
    assert sorted(os.listdir(tmp_path)) == [
        "model_epoch3.npz", "model_epoch4.npz", "model_epoch5.npz"]
    assert tckpt.latest_checkpoint(str(tmp_path / "absent")) is None
    with pytest.raises(ValueError):
        tckpt.epoch_of("weights.npz")


def test_resume_equals_an_unbroken_run(tmp_path):
    """2 steps, save, load into a fresh net and optimizer, 1 step == 3
    steps, bit for bit on the CPU."""
    params = jax_params()
    rng = np.random.default_rng(11)
    batches = [ttrain.batch_to_device(border_batch(rng), "cpu")
               for _ in range(3)]

    def fresh(weights, momentum=None):
        net = tnet.params_from_numpy(weights)
        optimizer = ttrain.make_optimizer(CONFIG, net)
        if momentum is not None:
            ttrain.load_momentum(net, optimizer, momentum)
        return net, optimizer, ttrain.make_train_step(CONFIG, net, optimizer)

    net, optimizer, step = fresh(params)
    unbroken = [float(step(b)) for b in batches]
    want = (tnet.params_to_numpy(net), ttrain.momentum_to_numpy(net,
                                                                optimizer))

    net, optimizer, step = fresh(params)
    losses = [float(step(b)) for b in batches[:2]]
    path = tckpt.save_checkpoint(str(tmp_path), 2, tnet.params_to_numpy(net),
                                 ttrain.momentum_to_numpy(net, optimizer))
    restored = tckpt.load_checkpoint(path, {"params": params,
                                            "momentum": params})
    net, optimizer, step = fresh(restored["params"], restored["momentum"])
    losses.append(float(step(batches[2])))
    assert losses == unbroken
    _assert_trees_equal(tnet.params_to_numpy(net), want[0])
    _assert_trees_equal(ttrain.momentum_to_numpy(net, optimizer), want[1])
