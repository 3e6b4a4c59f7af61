"""mccnn_tpu_torch.models against mccnn_tpu.models (features, weight files)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mccnn_tpu.models import params as jax_params_io  # noqa: E402
from mccnn_tpu.models.net import extract_features  # noqa: E402
from mccnn_tpu.utils.config import NetConfig  # noqa: E402
from mccnn_tpu_torch.models import net as tnet  # noqa: E402
from mccnn_tpu_torch.models import params as tparams  # noqa: E402

from torch_parity import jax_params  # noqa: E402

# f32 convolutions in another summation order; descriptors are unit
# vectors, so 1e-5 absolute is a few f32 ulps of accumulated error
ATOL = 1e-5


def _features_both(params, image):
    want = np.asarray(extract_features(params, jnp.asarray(image)))
    net = tnet.params_from_numpy(params)
    got = tnet.extract_features(net, torch.from_numpy(image)).numpy()
    return got, want


def test_features_match_jax(rng):
    image = rng.standard_normal((20, 27)).astype(np.float32)
    got, want = _features_both(jax_params(), image)
    assert got.shape == want.shape == (20, 27, 64)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_grouped_features_match_jax(rng):
    config = NetConfig(groups=4)
    params = jax_params(config)
    net = tnet.params_from_numpy(params)
    assert [c.groups for c in net.convs] == [1, 4, 4, 4, 4]
    image = rng.standard_normal((16, 19)).astype(np.float32)
    got, want = _features_both(params, image)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_init_params_layout_matches_jax():
    params = tnet.init_params(seed=3)
    reference = jax_params()
    for name, layer in params.items():
        assert layer["w"].shape == reference[name]["w"].shape
        assert layer["b"].shape == reference[name]["b"].shape
        fan = np.prod(layer["w"].shape[:3]) + 9 * layer["w"].shape[3]
        assert np.abs(layer["w"]).max() <= np.sqrt(6.0 / fan)
        assert not layer["b"].any()
    net = tnet.params_from_numpy(params)
    np.testing.assert_array_equal(
        net.convs[1].weight.numpy(),
        params["conv2"]["w"].transpose(3, 2, 0, 1))  # HWIO -> OIHW


def test_weight_files_cross_load(tmp_path):
    params = jax_params()
    # JAX writes, the port reads
    jax_npz = tmp_path / "jax.npz"
    jax_params_io.save_params(params, str(jax_npz))
    loaded = tparams.load_any(str(jax_npz))
    # the port writes, JAX reads
    port_npz = tmp_path / "port.npz"
    tparams.save_params(loaded, str(port_npz))
    back = jax_params_io.load_params(str(port_npz))
    # training-checkpoint layout and the reference npy dict
    ckpt = tmp_path / "ckpt.npz"
    np.savez(ckpt, **{f"params:{n}/{k}": v for n, layer in params.items()
                      for k, v in layer.items()}, opt_leaf_0=np.zeros(3))
    npy = tmp_path / "ref.npy"
    jax_params_io.save_reference_npy_dict(params, str(npy))
    for other in (loaded, back, tparams.load_any(str(ckpt)),
                  tparams.load_any(str(npy))):
        assert sorted(other) == sorted(params)
        for name in params:
            for kind in ("w", "b"):
                np.testing.assert_array_equal(other[name][kind],
                                              params[name][kind])


def test_unsupported_weight_files_raise(tmp_path):
    # a TF1 checkpoint needs tensorflow: the message names the JAX converter
    with pytest.raises(ValueError, match="mccnn_tpu.cli.convert"):
        tparams.load_any(str(tmp_path / "model_epoch2000.ckpt"))
    # legacy snapshots load now; malformed ones still raise
    odd = tmp_path / "odd.npz"
    np.savez(odd, leaf_0=np.zeros(64), leaf_1=np.zeros((3, 3, 1, 64)),
             leaf_2=np.zeros(64))
    with pytest.raises(ValueError, match="pairs"):
        tparams.load_params(str(odd))
    swapped = tmp_path / "swapped.npz"
    np.savez(swapped, leaf_0=np.zeros((3, 3, 1, 64)), leaf_1=np.zeros(64))
    with pytest.raises(ValueError, match="1-D bias"):
        tparams.load_params(str(swapped))
    adam = tmp_path / "adam.npz"
    np.savez(adam, **{f"leaf_{i}": np.zeros(64 if i % 2 == 0 else
                                            (3, 3, 1, 64))
                      for i in range(6)})
    with pytest.raises(ValueError, match="3-way"):
        tparams.load_params(str(adam))


@pytest.mark.parametrize("with_momentum", [False, True])
def test_legacy_leaf_snapshots_load_as_in_jax(tmp_path, with_momentum):
    """Anonymous ``leaf_{i}`` files: (b, w) pairs in sorted layer-name
    order, optionally after a momentum mirror; both packages agree."""
    config = NetConfig(num_layers=11, num_maps=8)
    params = jax_params(config)
    names = sorted(params)  # conv1 < conv10 < conv11 < conv2 ...
    assert names[1] == "conv10"
    leaves = [params[n][k] for n in names for k in ("b", "w")]
    if with_momentum:
        leaves = [np.zeros_like(x) for x in leaves] + leaves
    path = tmp_path / "legacy.npz"
    np.savez(path, num_leaves=len(leaves),
             **{f"leaf_{i}": x for i, x in enumerate(leaves)})
    got = tparams.load_any(str(path))
    want = jax_params_io.load_params(str(path))
    assert sorted(got) == sorted(want) == names
    for name in names:
        for kind in ("w", "b"):
            np.testing.assert_array_equal(got[name][kind], params[name][kind])
            np.testing.assert_array_equal(got[name][kind], want[name][kind])
