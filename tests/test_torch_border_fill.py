"""The border fills: ``ops/cost_volume.py::border_fill`` (kernel K11 on a
CUDA tensor, the torch-op loop ``border_fill_plain`` on a CPU tensor).

The CPU cases hold the loop to the JAX package's ``_border_fill_left`` /
``_border_fill_right`` (JAX is imported inside them, so the file also runs
where there is no JAX: on a machine with a card, without the
JAX-importing conftest):

    python -m pytest tests/test_torch_border_fill.py --noconftest -q

The cases marked ``cuda`` hold the kernel to the torch-op loop on the same
CUDA tensor, bit for bit, and skip where no card is present.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mccnn_tpu_torch.kernels import build  # noqa: E402
from mccnn_tpu_torch.models.net import (  # noqa: E402
    init_params,
    params_from_numpy,
)
from mccnn_tpu_torch.ops import cost_volume as tcv  # noqa: E402
from mccnn_tpu_torch.ops.common import BIG_COST  # noqa: E402
from mccnn_tpu_torch.pipeline.match import match_pair  # noqa: E402

from torch_parity import jitted, require_card, scene_pair  # noqa: E402

DTYPES = (torch.float32, torch.bfloat16)
SIDES = ("left", "right")
# (H, W, D_pad, ndisp): whole windows, windows clipped at the image edge
# (W < ndisp + 2; ndisp == W clips one to a single column), the least fill
# (ndisp 2) and none (ndisp 1); lanes >= ndisp hold BIG_COST. The CPU
# cases compile one JAX reference each, so they take few shapes
CPU_SHAPES = ((3, 20, 16, 12), (2, 10, 16, 10), (2, 6, 8, 2), (2, 6, 8, 1))
SMALL = CPU_SHAPES + ((2, 11, 16, 10), (5, 70, 128, 70), (4, 150, 128, 70),
                      (3, 301, 384, 300))
# the main path's volumes: half size (1024 x 1536, D_pad 256) and full size
# (2048 x 3072, D_pad 512)
LARGE = ((1024, 1536, 256, 200), (2048, 3072, 512, 400))


def _volume(shape, dtype, seed=0, device="cpu"):
    height, width, d_pad, ndisp = shape
    generator = torch.Generator(device).manual_seed(seed)
    volume = torch.empty((height, width, d_pad), dtype=dtype, device=device)
    volume.uniform_(-1, 1, generator=generator)
    volume[..., ndisp:] = BIG_COST
    return volume


def _bits(tensor):
    """The stored bits, so that -0.0 and 0.0 count as different."""
    return tensor.view(torch.int32 if tensor.dtype == torch.float32
                       else torch.int16)


def _filled(width, d_pad, ndisp, side, device="cpu"):
    """(W, D_pad) mask of the (column, lane) entries a fill writes."""
    cols = torch.arange(width, device=device)[:, None]
    lanes = torch.arange(d_pad, device=device)[None, :]
    first = cols + 1 if side == "left" else width - cols  # first lane written
    return (lanes >= first) & (lanes >= 1) & (lanes < ndisp)


def _jax_fill(volume, ndisp, side):
    jax = pytest.importorskip("jax")
    jcv = importlib.import_module("mccnn_tpu.ops.cost_volume")
    fn = jcv._border_fill_left if side == "left" else jcv._border_fill_right
    dtype = jax.numpy.bfloat16 if volume.dtype == torch.bfloat16 else None
    # the CPU's XLA even where JAX finds a card
    with jax.default_device(jax.devices("cpu")[0]):
        values = jax.numpy.asarray(volume.float().numpy(), dtype=dtype)
        out = np.array(jitted(fn, "ndisp")(values, ndisp=ndisp), np.float32)
    return torch.from_numpy(out).to(volume.dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", CPU_SHAPES)
def test_cpu_fill_matches_jax(shape, dtype):
    """The torch-op loop against JAX's scan, both sides: bit for bit, but
    for the right side in f32 at clipped widths, where XLA's CPU build of
    the scan takes some whole windows' means as the sum times the f32
    reciprocal of 3: one ulp from the loop's division, carried on along
    the lane's chain, within 2^-24 (an ulp at |v| < 1); the entries
    outside the filled triangle, BIG_COST lanes included, come back
    unchanged."""
    height, width, d_pad, ndisp = shape
    for side in SIDES:
        volume = _volume(shape, dtype, seed=ndisp)
        got = tcv.border_fill(volume.clone(), ndisp, side)
        want = _jax_fill(volume, ndisp, side)
        if (dtype == torch.float32 and side == "right"
                and width < ndisp + 2):
            torch.testing.assert_close(got, want, rtol=0, atol=2.0 ** -24)
        else:
            assert torch.equal(_bits(got), _bits(want))
        kept = ~_filled(width, d_pad, ndisp, side).expand_as(volume)
        assert torch.equal(_bits(got[kept]), _bits(volume[kept]))
        assert bool((got[..., ndisp:] == BIG_COST).all())


def test_cpu_fill_is_in_place_and_launches_nothing():
    volume = _volume(SMALL[0], torch.float32)
    build.LAUNCHES.reset()
    for side in SIDES:
        assert tcv.border_fill(volume, SMALL[0][3], side) is volume
    assert build.LAUNCHES.snapshot()["border_fill"] == 0
    with pytest.raises(ValueError, match="side"):
        tcv.border_fill(volume, 4, "up")


def _launches():
    return build.LAUNCHES.snapshot()["border_fill"]


def _kernel_against_loop(shape, dtype, side, device):
    """K11 and the torch-op loop on copies of one CUDA volume: bit-equal,
    in place, one launch, nothing outside the filled triangle moved. The
    volumes are freed before the asserts: a failure's traceback would hold
    them (13 GB each in f32 at full size) through the later cases."""
    height, width, d_pad, ndisp = shape
    volume = _volume(shape, dtype, seed=ndisp + 1, device=device)
    want = tcv.border_fill_plain(volume.clone(), ndisp, side)
    got = volume.clone()
    pointer = got.data_ptr()
    build.LAUNCHES.reset()
    in_place = tcv.border_fill(got, ndisp, side) is got
    torch.cuda.synchronize()
    in_place = in_place and got.data_ptr() == pointer
    equal = torch.equal(_bits(got), _bits(want))
    kept = ~_filled(width, d_pad, ndisp, side, device)
    unmoved = all(torch.equal(_bits(got[row][kept]),
                              _bits(volume[row][kept]))
                  for row in range(height))
    del volume, want, got
    torch.cuda.empty_cache()
    assert in_place
    assert _launches() == (1 if ndisp >= 2 else 0)
    assert equal
    assert unmoved


@pytest.mark.cuda
@pytest.mark.parametrize("side", SIDES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SMALL)
def test_kernel_matches_loop_at_small_shapes(shape, dtype, side):
    _kernel_against_loop(shape, dtype, side, require_card())


@pytest.mark.cuda
@pytest.mark.parametrize("side", SIDES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", LARGE)
def test_kernel_matches_loop_at_the_main_path_shapes(shape, dtype, side):
    _kernel_against_loop(shape, dtype, side, require_card())


@pytest.mark.cuda
@pytest.mark.parametrize("volume_dtype", ["float32", "bfloat16"])
def test_pair_map_unchanged_against_the_loop(volume_dtype, monkeypatch):
    """A match_pair map on the card with K11, and with the fills run as the
    torch-op loop on the card: equal; one launch a side."""
    device = require_card()
    net = params_from_numpy(init_params(0)).to(device)
    left, right, _, _ = scene_pair("slanted", 48, 150, seed=3)
    left, right = (torch.from_numpy(x).to(device) for x in (left, right))
    build.LAUNCHES.reset()
    got = match_pair(net, left, right, 40, volume_dtype=volume_dtype)
    assert _launches() == 2
    monkeypatch.setattr(tcv, "border_fill", tcv.border_fill_plain)
    want = match_pair(net, left, right, 40, volume_dtype=volume_dtype)
    assert torch.equal(got, want)
