"""mccnn_tpu_torch.parallel on gloo CPU ranks, against mccnn_tpu.parallel.

Each world size is spawned once per module (``parallel/launch.py``) and
runs all of its cases in one go (``tools/multiprocess_bringup.py::
run_cases``); the tests then hold each case's results against the JAX
package on its 8 fake CPU devices, or against the port's unsharded calls,
with the tolerances of tests/test_parallel.py: CBCA rtol/atol 1e-4; match
volumes atol 1e-4 / rtol 1e-6 (one f32 ulp of the 1e9 pad lanes), WTA
maps exact, disparity 1e-5; the DP step's loss rtol 1e-5 and params atol
1e-5. The sharded fused8 hook is bit-equal to the unsharded call.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mccnn_tpu.parallel import cbca as jpcbca  # noqa: E402
from mccnn_tpu.parallel import match as jpmatch  # noqa: E402
from mccnn_tpu.parallel import mesh as jpmesh  # noqa: E402
from mccnn_tpu.parallel import train as jptrain  # noqa: E402
from mccnn_tpu.pipeline import train as jtrain  # noqa: E402
from mccnn_tpu.utils.config import MatchConfig as JaxMatchConfig  # noqa: E402
from mccnn_tpu.utils.config import TrainConfig as JaxTrainConfig  # noqa: E402
from mccnn_tpu_torch.models.net import params_from_numpy  # noqa: E402
from mccnn_tpu_torch.ops.cbca import compute_arms  # noqa: E402
from mccnn_tpu_torch.ops.cbca_fused import cbca_fused  # noqa: E402
from mccnn_tpu_torch.ops.common import BIG_COST  # noqa: E402
from mccnn_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from mccnn_tpu_torch.parallel.cbca import cbca_sharded  # noqa: E402
from mccnn_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from mccnn_tpu_torch.parallel.match import make_sharded_match  # noqa: E402
from mccnn_tpu_torch.parallel.pallas_shard import (  # noqa: E402
    make_sharded_cbca_fn,
)
from mccnn_tpu_torch.pipeline.match import match_pair  # noqa: E402
from mccnn_tpu_torch.pipeline.train import (  # noqa: E402
    batch_to_device,
    make_optimizer,
    make_train_step,
    momentum_to_numpy,
)
from mccnn_tpu_torch.tools import multiprocess_bringup as bringup  # noqa: E402
from mccnn_tpu_torch.utils.config import MatchConfig, TrainConfig  # noqa: E402

from torch_parity import jax_params, jitted, scene_pair  # noqa: E402

jcbca = importlib.import_module("mccnn_tpu.ops.cbca")

TIMEOUT_S = 120.0
# tests/test_parallel.py's configurations
MATCH_CFG = dict(cbca_intensity=0.4, cbca_distance=3,
                 cbca_num_iterations_1=1, cbca_num_iterations_2=1, sgm_d=0.4)
TRAIN_CFG = dict(batch_size=16, learning_rate=0.01)
# the 2-rank match: a radius-13 halo on 32-row shards, ndisp 16
HALO_CFG = dict(cbca_distance=14, cbca_num_iterations_1=1,
                cbca_num_iterations_2=2)
HALO_VARIANTS = {"chained": {}, "paper_mode": {"sgm_paper_mode": True},
                 "sgm_u8": {"sgm_u8": True}}
KERNEL_IMPLS = ("fused", "pallas", "rolling", "fused2")


def _volume(rng, height, width, ndisp, d_pad):
    volume = np.full((height, width, d_pad), BIG_COST, dtype=np.float32)
    volume[:, :, :ndisp] = rng.normal(size=(height, width, ndisp))
    return volume


def _inputs():
    """Every seeded input of the module."""
    rng = np.random.default_rng(0)
    out = {
        # (c): 48 x 20 x 8, distance 4, on 4 ranks (8 fake JAX devices)
        "stencil_image": rng.normal(size=(48, 20)).astype(np.float32),
        "stencil_volume": _volume(rng, 48, 20, 5, 8),
        # (d), (e): 128 x 160 x 128, distance 14, on 2 ranks
        "kernel_image": rng.normal(size=(128, 160)).astype(np.float32),
        "kernel_volume": _volume(rng, 128, 160, 5, 128),
        # (f): 16 x 24, ndisp 4, on 4 ranks
        "small_left": rng.normal(size=(16, 24)).astype(np.float32),
        "small_right": rng.normal(size=(16, 24)).astype(np.float32),
        # (i): four global batches of 16 patch triplets
        "batches": [tuple(rng.normal(size=(16, 11, 11, 1)).astype(np.float32)
                          for _ in range(3)) for _ in range(4)],
    }
    out["halo_left"], out["halo_right"], _, _ = scene_pair(
        "occlusion", 64, 96, seed=1, max_disparity=12)
    return out


INPUTS = _inputs()
PARAMS = jax_params()


def _spawn(world_size, cases):
    return run_ranks(bringup.run_cases, world_size, cases, device="cpu",
                     timeout_s=TIMEOUT_S)


@pytest.fixture(scope="module")
def ranks2():
    """(d), (e), (g) and (i) on one spawn of 2 ranks."""
    cases = [(f"cbca_{impl}", bringup.sharded_cbca, dict(
        volume=INPUTS["kernel_volume"], image=INPUTS["kernel_image"],
        intensity=0.8, distance=14, iterations=3, impl=impl))
        for impl in KERNEL_IMPLS]
    cases.append(("cbca_fused8", bringup.sharded_cbca, dict(
        volume=INPUTS["kernel_volume"], image=INPUTS["kernel_image"],
        intensity=0.8, distance=14, iterations=2, impl="fused8")))
    cases += [(f"halo_{name}", bringup.sharded_match, dict(
        params=PARAMS, left=INPUTS["halo_left"], right=INPUTS["halo_right"],
        ndisp=16, config=MatchConfig(**HALO_CFG, **variant)))
        for name, variant in HALO_VARIANTS.items()]
    cases.append(("dp", bringup.dp_steps, dict(
        params=PARAMS, batches=INPUTS["batches"][:3],
        config=TrainConfig(**TRAIN_CFG))))
    return _spawn(2, cases)


@pytest.fixture(scope="module")
def ranks3():
    """(b) on 3 ranks."""
    return _spawn(3, [("collectives", bringup.collectives,
                       dict(width=7, radius=2))])


@pytest.fixture(scope="module")
def ranks4():
    """(c) and (f) on one spawn of 4 ranks."""
    cases = [("stencil", bringup.sharded_cbca, dict(
        volume=INPUTS["stencil_volume"], image=INPUTS["stencil_image"],
        intensity=0.8, distance=4, iterations=3))]
    cases += [(f"match_{method}_{impl}{'_joint' * joint}",
               bringup.sharded_match, dict(
                   params=PARAMS, left=INPUTS["small_left"],
                   right=INPUTS["small_right"], ndisp=4,
                   config=MatchConfig(**MATCH_CFG,
                                      cbca_joint_regions=joint),
                   cost_volume_method=method, cbca_impl=impl))
              for method, impl in (("pallas", "fused"), ("matmul", "xla"))
              for joint in (False, True)]
    return _spawn(4, cases)


def _jax_cbca(volume, image, intensity, distance, iterations):
    arms = jitted(jcbca.compute_arms, "intensity_threshold",
                  "distance_threshold")(image, intensity, distance)
    return np.asarray(jitted(jcbca.cbca, "num_iterations",
                             "distance_threshold")(
        jnp.asarray(volume), arms, iterations, distance))


# (b) the collectives on 3 ranks


def test_collectives_on_three_ranks(ranks3):
    got = bringup.case(ranks3, "collectives")
    rows, width, radius = 4, 7, 2
    whole = np.arange(3 * rows * width * 3, dtype=np.float32).reshape(
        3 * rows, width, 3)
    padded = np.concatenate([np.zeros((radius, width, 3), np.float32), whole,
                             np.zeros((radius, width, 3), np.float32)])
    starts = [0, 3, 5]  # 7 columns over 3 ranks: 3, 2, 2
    for rank, out in enumerate(got):
        assert out["sum"] == 6.0 and out["max"] == 2.0
        want_halo = padded[rank * rows:rank * rows + rows + 2 * radius]
        np.testing.assert_array_equal(out["halo"], want_halo)
        np.testing.assert_array_equal(out["halo_bf16"], torch.from_numpy(
            want_halo).to(torch.bfloat16).float().numpy())
        assert out["col0"] == starts[rank]
        stop = starts[rank + 1] if rank < 2 else width
        np.testing.assert_array_equal(out["columns"],
                                      whole[:, starts[rank]:stop])
        np.testing.assert_array_equal(out["round_trip"],
                                      whole[rank * rows:(rank + 1) * rows])
        np.testing.assert_array_equal(out["gathered"], whole)


# (c) the torch stencil on 4 ranks against JAX's on 8 devices


def test_cbca_sharded_matches_jax(ranks4):
    volume, image = INPUTS["stencil_volume"], INPUTS["stencil_image"]
    arms = jcbca.compute_arms(jnp.asarray(image), 0.8, 4)
    sharded = jitted(jpcbca.cbca_sharded, "num_iterations",
                     "distance_threshold", "mesh")
    want = np.asarray(sharded(jnp.asarray(volume), arms, 3, 4,
                              jpmesh.make_mesh(8)))
    got = np.concatenate(bringup.case(ranks4, "stencil"))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# (d) the kernel hooks on 2 ranks against JAX's exact CBCA


@pytest.mark.parametrize("impl", KERNEL_IMPLS)
def test_sharded_cbca_fn_matches_jax_exact(ranks2, impl):
    want = _jax_cbca(INPUTS["kernel_volume"], INPUTS["kernel_image"], 0.8,
                     14, 3)
    got = np.concatenate(bringup.case(ranks2, f"cbca_{impl}"))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# (e) fused8: one global scale, bit-equal to the unsharded call


def test_sharded_fused8_bit_equal_to_unsharded(ranks2):
    volume = torch.from_numpy(INPUTS["kernel_volume"])
    arms = compute_arms(torch.from_numpy(INPUTS["kernel_image"]), 0.8, 14)
    want = cbca_fused(volume, arms, 2, 14, int8_storage=True).numpy()
    got = np.concatenate(bringup.case(ranks2, "cbca_fused8"))
    np.testing.assert_array_equal(got, want)


# (f) the sharded matcher on 4 ranks against JAX's on 4 devices


def _jax_sharded_match(joint):
    fn = jpmatch.make_sharded_match(
        4, JaxMatchConfig(**MATCH_CFG, sgm_chunk=1,
                          cbca_joint_regions=joint), jpmesh.make_mesh(4),
        cost_volume_method="matmul", cbca_impl="xla", return_volumes=True)
    out = fn(PARAMS, jnp.asarray(INPUTS["small_left"]),
             jnp.asarray(INPUTS["small_right"]))
    return {key: np.asarray(value) for key, value in out.items()}


@pytest.fixture(scope="module")
def jax_sharded_match():
    return _jax_sharded_match(joint=False)


def _assert_match(got_ranks, want):
    """Each rank's volume rows, and its whole maps, against ``want``."""
    for got in got_ranks:
        rows = slice(*got["rows"])
        for key in ("left_volume", "right_volume"):
            np.testing.assert_allclose(got[key], want[key][rows], atol=1e-4,
                                       rtol=1e-6, err_msg=key)
        for key, tol in (("left_disparity", 0.0), ("right_disparity", 0.0),
                         ("disparity", 1e-5)):
            np.testing.assert_allclose(got[key], want[key], atol=tol,
                                       rtol=1e-6, err_msg=key)


@pytest.mark.parametrize("method,impl", [("pallas", "fused"),
                                         ("matmul", "xla")])
def test_sharded_match_matches_jax(ranks4, jax_sharded_match, method, impl):
    _assert_match(bringup.case(ranks4, f"match_{method}_{impl}"),
                  jax_sharded_match)


def test_sharded_joint_regions_match_jax(ranks4):
    """With ``cbca_impl="xla"`` JAX has no CBCA hook and GSPMD partitions
    ``cbca_joint``; the port runs it per halo-extended block."""
    _assert_match(bringup.case(ranks4, "match_matmul_xla_joint"),
                  _jax_sharded_match(joint=True))


def test_sharded_kernel_hook_does_not_read_the_joint_flag(ranks4):
    """With a kernel impl the hook takes precedence over the joint flag, as
    in JAX: the result equals the unsharded port with the flag off, and the
    sharded run without the flag bit for bit."""
    want = match_pair(params_from_numpy(PARAMS),
                      torch.from_numpy(INPUTS["small_left"]),
                      torch.from_numpy(INPUTS["small_right"]), 4,
                      MatchConfig(**MATCH_CFG), return_volumes=True,
                      cbca_impl="fused", cost_volume_method="pallas")
    got = bringup.case(ranks4, "match_pallas_fused_joint")
    _assert_match(got, {key: value.numpy() for key, value in want.items()})
    for with_flag, without in zip(got,
                                  bringup.case(ranks4, "match_pallas_fused")):
        for key, value in without.items():
            np.testing.assert_array_equal(with_flag[key], value,
                                          err_msg=key)


# (g) a non-degenerate halo and reshard on 2 ranks against match_pair


@pytest.mark.parametrize("variant", HALO_VARIANTS)
def test_sharded_match_matches_unsharded(ranks2, variant):
    config = MatchConfig(**HALO_CFG, **HALO_VARIANTS[variant])
    want = match_pair(params_from_numpy(PARAMS),
                      torch.from_numpy(INPUTS["halo_left"]),
                      torch.from_numpy(INPUTS["halo_right"]), 16, config,
                      return_volumes=True, cbca_impl="fused")
    want = {key: value.numpy() for key, value in want.items()}
    got = bringup.case(ranks2, f"halo_{variant}")
    assert [g["rows"] for g in got] == [(0, 32), (32, 64)]
    _assert_match(got, want)


# (h) shapes that do not shard


def test_rows_that_do_not_divide_raise():
    mesh = tmesh.Mesh(0, 2, torch.device("cpu"), "gloo")
    image = torch.zeros(33, 40)
    arms = compute_arms(image, 0.5, 4)
    with pytest.raises(ValueError, match="divide over 2"):
        make_sharded_cbca_fn(4, mesh, "fused")(torch.zeros(16, 40, 8), arms,
                                               1)
    with pytest.raises(ValueError, match="divide over 2"):
        cbca_sharded(torch.zeros(16, 40, 8), arms, 1, 4, mesh)
    with pytest.raises(ValueError, match="divide over 2"):
        make_sharded_match(4, MatchConfig(), mesh)(
            params_from_numpy(PARAMS), image, image)
    # a shard lower than the halo (radius 13) cannot take one exchange
    tall = compute_arms(torch.zeros(20, 40), 0.5, 14)
    with pytest.raises(ValueError, match="smaller than the halo"):
        make_sharded_cbca_fn(14, mesh, "fused")(torch.zeros(10, 40, 8),
                                                tall, 1)
    with pytest.raises(ValueError, match="unknown cbca_impl"):
        make_sharded_cbca_fn(14, mesh, "joint")


# (i) data-parallel training on 2 ranks


def test_dp_step_matches_jax(ranks2):
    """The first DP step against JAX's DP step on 8 devices; the replicas
    bit-identical."""
    config = JaxTrainConfig(**TRAIN_CFG)
    optimizer = jtrain.make_optimizer(config)
    step = jptrain.make_dp_train_step(config, jpmesh.make_mesh(8),
                                      optimizer=optimizer)
    mesh = jpmesh.make_mesh(8)
    batch = tuple(jnp.asarray(x) for x in INPUTS["batches"][0])
    params, _, loss = step(PARAMS, optimizer.init(PARAMS),
                           jptrain.shard_batch(batch, mesh))
    got = bringup.case(ranks2, "dp")
    np.testing.assert_allclose(got[0]["losses"][0], float(loss), rtol=1e-5)
    want = jax.tree.map(np.asarray, params)
    for layer, leaves in got[0]["params_by_step"][0].items():
        for name, value in leaves.items():
            np.testing.assert_allclose(value, want[layer][name], atol=1e-5)
    assert got[0]["losses"] == got[1]["losses"]
    for tree in ("params_by_step", "momentum"):
        np.testing.assert_equal(got[1][tree], got[0][tree])


def _dp_alone(batches):
    """The port's single-process step over the global ``batches``."""
    from mccnn_tpu_torch.models.net import params_to_numpy

    net = params_from_numpy(PARAMS)
    config = TrainConfig(**TRAIN_CFG)
    optimizer = make_optimizer(config, net)
    step = make_train_step(config, net, optimizer)
    losses = [float(step(batch_to_device(b, "cpu"))) for b in batches]
    return {"losses": losses, "params": params_to_numpy(net),
            "momentum": momentum_to_numpy(net, optimizer)}


def test_dp_steps_match_the_single_step(ranks2):
    """Three DP steps against three steps of the port's single-process
    step on the global batches (rtol 1e-4 / atol 1e-6: the half batches'
    gradients are summed in another order)."""
    want = _dp_alone(INPUTS["batches"][:3])
    got = bringup.case(ranks2, "dp")[0]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4,
                               atol=1e-6)
    for tree in ("params", "momentum"):
        for layer, leaves in want[tree].items():
            for name, value in leaves.items():
                np.testing.assert_allclose(got[tree][layer][name], value,
                                           rtol=1e-4, atol=1e-6,
                                           err_msg=f"{tree} {layer} {name}")


# the SGM inputs of a column shard (the vertical sweeps of parallel/sgm.py)


@pytest.mark.parametrize("choice", ["L", "R"])
def test_column_shard_penalties_cut_the_whole_images(choice):
    """K3's planes and the penalty codes of a column shard are the whole
    image's, cut at the shard's columns: D1 and the codes at its columns,
    D2 at its probe columns -d_pad .. W + d_pad - 1."""
    from mccnn_tpu_torch.ops.sgm import kernel_planes, penalty_scale_u8

    rng = np.random.default_rng(5)
    left, right = (torch.from_numpy(rng.normal(size=(20, 37)).astype(
        np.float32)) for _ in range(2))
    d_pad, sgm_d = 16, 0.5
    for direction in ((-1, 0), (1, 0)):
        d1_whole, d2_whole = kernel_planes(left, right, choice, direction,
                                           d_pad, sgm_d)
        codes_whole = penalty_scale_u8(left, right, choice, direction, d_pad,
                                       sgm_d)
        for col0, width in ((0, 13), (13, 12), (25, 12)):
            d1, d2 = kernel_planes(left, right, choice, direction, d_pad,
                                   sgm_d, col0, width)
            assert torch.equal(d1[:, :width],
                               d1_whole[:, col0:col0 + width])
            span = width + 2 * d_pad
            assert torch.equal(d2[:, :span], d2_whole[:, col0:col0 + span])
            codes = penalty_scale_u8(left, right, choice, direction, d_pad,
                                     sgm_d, col0, width)
            assert torch.equal(codes, codes_whole[:, col0:col0 + width])
    with pytest.raises(ValueError, match="whole rows"):
        kernel_planes(left, right, choice, (0, 1), d_pad, sgm_d, 13, 12)
