"""mccnn_tpu_torch's training step against mccnn_tpu's, step for step.

Both packages start from the JAX package's seeded weights and take the
same seeded batches, some of whose patches lie partly in the zero padding
of the image borders (``torch_parity.border_batch``). The port runs the
three streams as one batch of 3B, so its gradients sum in another order
than JAX's: losses, weights and momentum traces agree within rtol 1e-4 and
atol 1e-6 (f32 reassociation; the updates are lr = 0.002 times sums of a
few thousand products).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.nn import functional as F  # noqa: E402

from mccnn_tpu.models import net as jnet  # noqa: E402
from mccnn_tpu.pipeline import train as jtrain  # noqa: E402
from mccnn_tpu.utils.config import TrainConfig  # noqa: E402
from mccnn_tpu_torch.models import net as tnet  # noqa: E402
from mccnn_tpu_torch.pipeline import train as ttrain  # noqa: E402

from torch_parity import border_batch, jax_params, jitted  # noqa: E402

CONFIG = TrainConfig(batch_size=16)
RTOL, ATOL = 1e-4, 1e-6


@functools.lru_cache(maxsize=None)
def _jax_step():
    """JAX's jitted step, built (and so compiled) once for the module."""
    optimizer = jtrain.make_optimizer(CONFIG)
    return optimizer, jtrain.make_train_step(CONFIG, optimizer)


def _jax_steps(params, batches):
    """JAX's train step over ``batches``: (losses, params, momentum)."""
    optimizer, step = _jax_step()
    opt_state = optimizer.init(params)
    losses = []
    for batch in batches:
        params, opt_state, loss = step(params, opt_state,
                                       tuple(map(jnp.asarray, batch)))
        losses.append(float(loss))
    momentum = jax.tree.map(np.asarray, opt_state[0].trace)
    return losses, jax.tree.map(np.asarray, params), momentum


def _port_steps(params, batches):
    net = tnet.params_from_numpy(params)
    optimizer = ttrain.make_optimizer(CONFIG, net)
    step = ttrain.make_train_step(CONFIG, net, optimizer)
    losses = [float(step(ttrain.batch_to_device(b, "cpu"))) for b in batches]
    return (losses, tnet.params_to_numpy(net),
            ttrain.momentum_to_numpy(net, optimizer))


@pytest.fixture(scope="module")
def three_steps():
    params = jax_params()
    rng = np.random.default_rng(10)
    batches = [border_batch(rng) for _ in range(3)]
    return params, batches, _jax_steps(params, batches), _port_steps(
        params, batches)


def test_patch_descriptors_match_jax():
    params = jax_params()
    patches = border_batch(np.random.default_rng(4))[0]
    want = np.asarray(jitted(jnet.patch_descriptors)(params, jnp.asarray(patches)))
    got = tnet.patch_descriptors(tnet.params_from_numpy(params),
                                 torch.from_numpy(patches)).numpy()
    assert got.shape == want.shape == (16, 64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)


def test_three_steps_match_jax(three_steps):
    _, _, (want_losses, want_params, want_momentum), (
        losses, params, momentum) = three_steps
    np.testing.assert_allclose(losses, want_losses, rtol=RTOL, atol=ATOL)
    assert len(params) == len(momentum) == 5  # 10 params, 10 traces
    for name in want_params:
        for kind in ("w", "b"):
            np.testing.assert_allclose(params[name][kind],
                                       want_params[name][kind],
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(momentum[name][kind],
                                       want_momentum[name][kind],
                                       rtol=RTOL, atol=ATOL)
            assert params[name][kind].shape == want_params[name][kind].shape


def test_relu_tie_gradient_matches_jax(three_steps):
    """One step on a batch with zero-padded border patches: every bias
    agrees with JAX's. ``F.relu`` sends no gradient through a tie at 0
    (windows wholly in the padding, zero biases) where ``jnp.maximum``
    sends half, which moves conv1's bias off JAX's by far more than the
    tolerance."""
    params, batches, _, _ = three_steps
    _, want, _ = _jax_steps(params, batches[:1])
    _, got, _ = _port_steps(params, batches[:1])
    for name in want:
        np.testing.assert_allclose(got[name]["b"], want[name]["b"],
                                   rtol=RTOL, atol=ATOL)


def test_serving_features_bit_equal_to_relu_forward():
    """The tie repair leaves every forward value as it was: the serving
    features equal those of an ``F.relu`` forward bit for bit."""
    net = tnet.params_from_numpy(jax_params())
    image = np.random.default_rng(5).standard_normal((23, 31)).astype(
        np.float32)
    image[:, :4] = 0.0  # flat regions give exact zeros inside the stack
    x = F.pad(torch.from_numpy(image), (net.pad,) * 4)[None, None]
    for i, conv in enumerate(net.convs):
        x = conv(x)
        if i < len(net.convs) - 1:
            x = F.relu(x)
    want = tnet.l2_normalize(x[0].permute(1, 2, 0), dim=-1)
    got = tnet.extract_features(net, torch.from_numpy(image))
    assert torch.equal(got, want)


def test_eval_step_matches_jax(three_steps):
    params, batches, _, _ = three_steps
    want = float(jtrain.make_eval_step(CONFIG)(
        params, tuple(map(jnp.asarray, batches[2]))))
    net = tnet.params_from_numpy(params)
    eval_step = ttrain.make_eval_step(CONFIG, net)
    got = eval_step(ttrain.batch_to_device(batches[2], "cpu"))
    assert got.shape == () and not got.requires_grad
    np.testing.assert_allclose(float(got), want, rtol=RTOL, atol=ATOL)


def test_momentum_round_trip_and_sgd_semantics(three_steps):
    """``load_momentum`` restores what ``momentum_to_numpy`` wrote, and a
    step is trace = g + beta * trace, p -= lr * trace (optax's sgd)."""
    params, batches, _, _ = three_steps
    net = tnet.params_from_numpy(params)
    optimizer = ttrain.make_optimizer(CONFIG, net)
    zeros = ttrain.momentum_to_numpy(net, optimizer)
    assert not any(v.any() for layer in zeros.values() for v in layer.values())
    trace = {n: {k: np.full_like(v, 0.5) for k, v in layer.items()}
             for n, layer in params.items()}
    ttrain.load_momentum(net, optimizer, trace)
    np.testing.assert_array_equal(
        ttrain.momentum_to_numpy(net, optimizer)["conv2"]["w"],
        trace["conv2"]["w"])
    step = ttrain.make_train_step(CONFIG, net, optimizer)
    batch = ttrain.batch_to_device(batches[0], "cpu")
    ttrain.hinge_loss(net, batch, CONFIG.margin).backward()
    grad = net.convs[0].weight.grad.permute(2, 3, 1, 0).numpy().copy()
    step(batch)
    want_trace = grad + CONFIG.beta * 0.5
    np.testing.assert_allclose(
        ttrain.momentum_to_numpy(net, optimizer)["conv1"]["w"], want_trace,
        rtol=1e-6)
    np.testing.assert_allclose(
        tnet.params_to_numpy(net)["conv1"]["w"],
        params["conv1"]["w"] - CONFIG.learning_rate * want_trace, rtol=1e-6,
        atol=1e-9)
    with pytest.raises(ValueError, match="momentum of shape"):
        ttrain.load_momentum(net, optimizer, {
            **trace, "conv1": {"w": np.zeros((3, 3, 2, 64)),
                               "b": trace["conv1"]["b"]}})
