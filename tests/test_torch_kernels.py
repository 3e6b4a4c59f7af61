"""The port's CUDA kernels K1-K10 against their plain versions.

This file imports no JAX, so it also runs on a machine with a card and no
JAX (there, without the JAX-importing conftest):

    python -m pytest tests/test_torch_kernels.py --noconftest -q

Tests marked ``cuda`` skip where no card is present. They hold each
kernel against its plain version, called directly on the card or run on
CPU copies of the same inputs (where every wrapper takes the plain
version). The others check the dispatch contract on the CPU: a CPU tensor
takes the plain version and counts no launch; a kernel entry point refuses
a tensor that is not on CUDA instead of falling back.
"""

import copy
import importlib
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mccnn_tpu_torch.kernels import build  # noqa: E402
from mccnn_tpu_torch.models.net import (  # noqa: E402
    init_params,
    params_from_numpy,
)
from mccnn_tpu_torch.ops import cost_volume as tcv  # noqa: E402
from mccnn_tpu_torch.ops.cbca_fused import (  # noqa: E402
    _quantize_int8,
    cbca_fused,
    cbca_int8_plain,
    cbca_round_cuda,
    cbca_round_int8_cuda,
)
from mccnn_tpu_torch.ops.cbca_fused2 import (  # noqa: E402
    cbca_fused_two,
    cbca_two_rounds_cuda,
)
from mccnn_tpu_torch.ops.cbca_pallas import (  # noqa: E402
    cbca_pallas,
    cbca_stencil_round_cuda,
)
from mccnn_tpu_torch.ops.cbca_rolling import (  # noqa: E402
    cbca_fused_rolling,
    cbca_rolling_round_cuda,
)
from mccnn_tpu_torch.ops.common import BIG_COST  # noqa: E402
from mccnn_tpu_torch.pipeline.match import (  # noqa: E402
    MatchPipeline,
    match_pair,
)
from mccnn_tpu_torch.tools import bench_cbca_stream as stream  # noqa: E402
from mccnn_tpu_torch.utils.config import MatchConfig  # noqa: E402

from chip_smoke import RAGGED_RADII, RAGGED_SHAPES  # noqa: E402
from torch_parity import require_card, scene_pair, unit_features  # noqa: E402

# the modules, not the functions mccnn_tpu_torch.ops exports under their names
tcbca = importlib.import_module("mccnn_tpu_torch.ops.cbca")
tsgm = importlib.import_module("mccnn_tpu_torch.ops.sgm")

NDISP = 70
TAU, DIST = 0.02, 14


def _volume(rng, height, width, d_pad=128, ndisp=NDISP):
    vol = rng.uniform(-1, 1, (height, width, d_pad)).astype(np.float32)
    vol[..., ndisp:] = BIG_COST
    return torch.from_numpy(vol)


def _images(height, width):
    left, right, _, _ = scene_pair("textureless", height, width, seed=5)
    return torch.from_numpy(left), torch.from_numpy(right)


def test_cpu_tensors_take_the_plain_versions():
    rng = np.random.default_rng(0)
    fl, fr = (torch.from_numpy(unit_features(rng, 6, 90)) for _ in "lr")
    left, right = _images(6, 90)
    arms = tcbca.compute_arms(left, TAU, DIST)
    build.LAUNCHES.reset()
    band = tcv.band_side(fl, fr, NDISP, 128, "left", torch.float32)
    torch.testing.assert_close(
        band, tcv.band_side_plain(fl, fr, NDISP, 128, "left", torch.float32),
        rtol=0, atol=0)
    agg = cbca_fused(band, arms, 2, DIST)
    torch.testing.assert_close(agg, tcbca.cbca(band, arms, 2, DIST), rtol=0,
                               atol=0)
    torch.testing.assert_close(cbca_pallas(band, arms, 2, DIST), agg, rtol=0,
                               atol=0)
    torch.testing.assert_close(
        cbca_fused(band, arms, 2, DIST, int8_storage=True),
        cbca_int8_plain(band, arms, 2, DIST), rtol=0, atol=0)
    both = tcv.band_pair(fl, fr, NDISP, 128, torch.float32)
    torch.testing.assert_close(both[0], band, rtol=0, atol=0)
    torch.testing.assert_close(
        both[1], tcv.band_side_plain(fr, fl, NDISP, 128, "right",
                                     torch.float32), rtol=0, atol=0)
    out = torch.empty_like(agg)
    tsgm.sweep(agg, out, left, right, "L", (0, 1), MatchConfig())
    want = torch.empty_like(agg)
    tsgm.sweep_plain(agg, want, left, right, "L", (0, 1), MatchConfig())
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    for variant in (cbca_fused_rolling, cbca_fused_two):
        torch.testing.assert_close(variant(band, arms, 3, DIST),
                                   tcbca.cbca(band, arms, 3, DIST), rtol=0,
                                   atol=0)
    scores = tcv.band_pair_pallas(fl, fr, 128, use_mxu=False)
    torch.testing.assert_close(scores[0][..., :NDISP], -band[..., :NDISP],
                               rtol=0, atol=0)
    copied = stream.cbca_stream(band, 2, 30, 128)
    assert copied is not band and torch.equal(copied, band)
    assert build.LAUNCHES.snapshot() == dict.fromkeys(build.LAUNCHES.NAMES, 0)


def test_kernel_entry_points_refuse_cpu_tensors():
    rng = np.random.default_rng(1)
    vol = _volume(rng, 8, 40)
    left, right = _images(8, 40)
    arms = tcbca.compute_arms(left, TAU, DIST)
    inv = tcbca.inverse_region_size(arms, DIST)
    with pytest.raises(ValueError, match="CUDA"):
        cbca_round_cuda(vol, torch.empty_like(vol), arms, inv, DIST)
    with pytest.raises(ValueError, match="CUDA"):
        tsgm.sweep_cuda(vol, vol, left, right, "L", (1, 0), MatchConfig())
    with pytest.raises(ValueError, match="CUDA"):
        cbca_stencil_round_cuda(vol, torch.empty_like(vol), arms, inv, DIST)
    q = vol.to(torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        cbca_round_int8_cuda(q, torch.empty_like(q), arms, inv, DIST)
    with pytest.raises(ValueError, match="CUDA"):
        cbca_rolling_round_cuda(vol, torch.empty_like(vol), arms, inv, DIST)
    with pytest.raises(ValueError, match="CUDA"):
        cbca_two_rounds_cuda(vol, torch.empty_like(vol), arms, inv, DIST)
    codes = tsgm.penalty_scale_u8(left, right, "L", (1, 0), 128, 0.08)
    with pytest.raises(ValueError, match="CUDA"):
        tsgm.sweep_cuda(vol, vol, left, right, "L", (1, 0), MatchConfig(),
                        codes)


def _launched():
    """The kernels launched since the last reset, with their counts."""
    return {k: v for k, v in build.LAUNCHES.snapshot().items() if v}


def _on_cpu(*tensors):
    return [t.cpu() for t in tensors]


def test_library_name_follows_the_sources():
    path = build.library_path()
    # a source checkout builds into its own build/ directory
    checkout = Path(__file__).resolve().parents[1]
    assert build.BUILD_DIR == checkout / "build" / "mccnn_tpu_torch"
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libmccnn_kernels_")
    assert path == build.library_path()  # stable for unchanged sources
    assert {p.name for p in build.SOURCE_DIR.glob("*.cu")} == {
        "band.cu", "band_pair.cu", "band_vpu.cu", "border_fill.cu",
        "cbca_rolling.cu", "cbca_round.cu", "cbca_round_int8.cu",
        "cbca_stencil.cu", "cbca_stream.cu", "cbca_two_round.cu",
        "sgm_sweep.cu"}
    assert len(build.LAUNCHES.NAMES) == 11


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("side", ["left", "right"])
def test_band_kernel_matches_plain(side, dtype):
    device = require_card()
    rng = np.random.default_rng(2)
    fl, fr = (torch.from_numpy(unit_features(rng, 9, 150)).to(device, dtype)
              for _ in "lr")
    got = tcv.band_side(fl, fr, NDISP, 128, side, dtype).float()
    want = tcv.band_side_plain(fl, fr, NDISP, 128, side, dtype).float()
    # |cost| <= 1: f32 sums in another order; bf16 one ulp (2^-8) apart
    atol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
    torch.testing.assert_close(got, want, atol=atol, rtol=0)


@pytest.mark.cuda
def test_band_kernel_rejects_mismatched_features():
    device = require_card()
    rng = np.random.default_rng(3)
    fl, fr = (torch.from_numpy(unit_features(rng, 4, 40)).to(device)
              for _ in "lr")
    with pytest.raises(ValueError):
        tcv.band_side(fl, fr, 10, 128, "left", torch.bfloat16)
    # either route refuses a pointer off 16 bytes (an offset view); the
    # kernel's refusal raises instead of taking another route
    for dtype in (torch.float32, torch.bfloat16):
        flat = torch.zeros(4 * 40 * 64 + 1, dtype=dtype, device=device)
        skewed = flat[1:].view(4, 40, 64)
        with pytest.raises(RuntimeError, match="band_side"):
            tcv.band_side(skewed, fr.to(dtype), 10, 128, "right", dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cbca_kernel_matches_plain(dtype):
    device = require_card()
    left, _ = _images(70, 150)
    arms = tcbca.compute_arms(left.to(device), TAU, DIST)
    vol = _volume(np.random.default_rng(4), 70, 150, 256, 200).to(device,
                                                                   dtype)
    got = cbca_fused(vol, arms, 3, DIST)
    want = tcbca.cbca(vol, arms, 3, DIST)
    # the kernel sums in the plain round's f32 order: bit-equal
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("paper_mode", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sgm_kernel_matches_plain(dtype, paper_mode):
    device = require_card()
    images = [x.to(device) for x in _images(40, 72)]
    config = MatchConfig(sgm_paper_mode=paper_mode)
    volume = _volume(np.random.default_rng(5), 40, 72, 128, 20).to(device,
                                                                   dtype)
    for choice in ("L", "R"):
        got = tsgm._sgm_one_volume(volume.clone(), *images, choice, 20,
                                   config)
        want = tsgm._sgm_one_volume(*_on_cpu(volume, *images), choice, 20,
                                    config)
        # the same f32 operations in the same order: bit-equal
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ndisp", [300, 400])
def test_kernels_at_full_resolution_depths(ndisp, dtype):
    """D_pad 384 and 512 (full-resolution search ranges): K3's wider lane
    fibres and K1/K2's extra disparity chunks."""
    device = require_card()
    height, width, d_pad = 12, 420, -(-ndisp // 128) * 128
    rng = np.random.default_rng(6)
    fl, fr = (torch.from_numpy(unit_features(rng, height, width)).to(device,
                                                                    dtype)
              for _ in "lr")
    images = [x.to(device) for x in _images(height, width)]
    for side in ("left", "right"):
        torch.testing.assert_close(
            tcv.band_side(fl, fr, ndisp, d_pad, side, dtype).float(),
            tcv.band_side_plain(fl, fr, ndisp, d_pad, side, dtype).float(),
            atol=1e-5 if dtype == torch.float32 else 2.0 ** -8, rtol=0)
    band = tcv.band_side(fl, fr, ndisp, d_pad, "left", dtype)
    arms = tcbca.compute_arms(images[0], TAU, DIST)
    # bit-equal: the same f32 sums and DP steps in the same order
    volume = cbca_fused(band, arms, 2, DIST)
    torch.testing.assert_close(volume, tcbca.cbca(band, arms, 2, DIST),
                               rtol=0, atol=0)
    got = tsgm._sgm_one_volume(volume.clone(), *images, "L", ndisp,
                               MatchConfig())
    want = tsgm._sgm_one_volume(*_on_cpu(volume, *images), "L", ndisp,
                                MatchConfig())
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    assert got[..., ndisp:].float().min().item() >= 1e8


@pytest.mark.cuda
@pytest.mark.parametrize("volume_dtype", ["float32", "bfloat16"])
def test_kernel_path_matches_plain_path(volume_dtype):
    """The pair on the card against the same pair on the CPU (plain)."""
    device = require_card()
    net = params_from_numpy(init_params(0))
    left, right = _images(48, 150)
    want = match_pair(net, left, right, 40, volume_dtype=volume_dtype)
    net = copy.deepcopy(net).to(device)
    left, right = left.to(device), right.to(device)
    per_pair = {"band_side": 2, "border_fill": 2, "cbca_round": 36,
                "sgm_sweep": 8}
    for cbca_impl in ("auto", "xla"):  # every accepted name runs K2
        build.LAUNCHES.reset()
        got = match_pair(net, left, right, 40, volume_dtype=volume_dtype,
                         cbca_impl=cbca_impl)
        assert _launched() == per_pair
        # cuDNN and CPU convolutions round apart, so a few WTA ties flip
        off = (got.cpu() - want).abs().gt(1.0).float().mean().item()
        assert off <= 0.005


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(9, 150, 70), (3, 33, 20), (5, 420, 300)])
def test_band_pair_kernel_equals_two_band_side_launches(shape, dtype):
    """K5 against K1 twice and against its plain version. In f32 K1 runs
    K5's fmaf chain in channel order, so the two are bit-equal; in bf16 K1
    sums its exact products on the tensor cores in another order, so the
    stored values may round one bf16 ulp (2^-8 at |cost| <= 1) apart."""
    device = require_card()
    height, width, ndisp = shape
    d_pad = -(-ndisp // 128) * 128
    rng = np.random.default_rng(7)
    fl, fr = (torch.from_numpy(unit_features(rng, height, width)).to(device,
                                                                    dtype)
              for _ in "lr")
    build.LAUNCHES.reset()
    left, right = tcv.band_pair(fl, fr, ndisp, d_pad, dtype)
    assert build.LAUNCHES.snapshot()["band_pair"] == 1
    assert build.LAUNCHES.snapshot()["band_side"] == 0
    ones = (tcv.band_side(fl, fr, ndisp, d_pad, "left", dtype),
            tcv.band_side(fr, fl, ndisp, d_pad, "right", dtype))
    against_k1 = 0.0 if dtype == torch.float32 else 2.0 ** -8
    for got, one in zip((left, right), ones):
        torch.testing.assert_close(got[..., :ndisp].float(),
                                   one[..., :ndisp].float(), rtol=0,
                                   atol=against_k1)
        assert torch.equal(got[..., ndisp:], one[..., ndisp:])  # pad lanes
    want = tcv.band_pair_plain(fl, fr, ndisp, d_pad, dtype)
    # |cost| <= 1: f32 sums in another order; bf16 one ulp (2^-8) apart
    atol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
    for got, plain in zip((left, right), want):
        torch.testing.assert_close(got.float(), plain.float(), atol=atol,
                                   rtol=0)


# shapes ragged for K5's and K6's tile (band_tile.cuh: 64-column blocks,
# 8 x 8 register tiles at a stride of 4): a width that is no multiple of
# the column tile, an ndisp that is no multiple of a register tile, a width
# below d_pad, 1 x 1 and one-row images
RAGGED_BANDS = [(3, 70, 13), (2, 100, 130), (1, 1, 1), (1, 300, 77),
                (4, 65, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", RAGGED_BANDS)
def test_band_pair_kernel_at_ragged_tiles(shape, dtype):
    """K5 at shapes ragged for its tile: in f32 equal to two K1 f32
    launches, in bf16 equal to the f32 launch on the bf16 values, rounded
    (tolerance 0.0: the same fmaf chain); within the plain version's
    tolerance of it."""
    device = require_card()
    height, width, ndisp = shape
    d_pad = -(-ndisp // 128) * 128
    rng = np.random.default_rng(15)
    fl, fr = (torch.from_numpy(unit_features(rng, height, width)).to(
        device, dtype) for _ in "lr")
    build.LAUNCHES.reset()
    got = tcv.band_pair(fl, fr, ndisp, d_pad, dtype)
    assert _launched() == {"band_pair": 1}
    if dtype == torch.float32:
        want = (tcv.band_side(fl, fr, ndisp, d_pad, "left", dtype),
                tcv.band_side(fr, fl, ndisp, d_pad, "right", dtype))
    else:
        want = tuple(v.to(dtype) for v in tcv.band_pair(
            fl.float(), fr.float(), ndisp, d_pad, torch.float32))
    plain = tcv.band_pair_plain(fl, fr, ndisp, d_pad, dtype)
    atol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
    for ours, exact, reference in zip(got, want, plain):
        torch.testing.assert_close(ours, exact, rtol=0, atol=0)
        torch.testing.assert_close(ours.float(), reference.float(),
                                   rtol=0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("shape", RAGGED_BANDS)
def test_band_side_f32_kernel_at_ragged_tiles(shape, side):
    """K1's f32 route (band_tile.cuh, one-sided) at shapes ragged for its
    tile, on either side: within 1e-5 of the plain version, zeros and pad
    lanes exact; and the two sides equal K5 f32 bit for bit (the same fmaf
    chain)."""
    device = require_card()
    height, width, ndisp = shape
    d_pad = -(-ndisp // 128) * 128
    rng = np.random.default_rng(19)
    fl, fr = (torch.from_numpy(unit_features(rng, height, width)).to(device)
              for _ in "lr")
    anchor, other = (fl, fr) if side == "left" else (fr, fl)
    build.LAUNCHES.reset()
    got = tcv.band_side(anchor, other, ndisp, d_pad, side, torch.float32)
    assert _launched() == {"band_side": 1}
    want = tcv.band_side_plain(anchor, other, ndisp, d_pad, side,
                               torch.float32)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    zero = want[..., :ndisp] == 0
    assert torch.equal(got[..., :ndisp][zero], want[..., :ndisp][zero])
    assert torch.equal(got[..., ndisp:], want[..., ndisp:])
    pair = tcv.band_pair(fl, fr, ndisp, d_pad, torch.float32)
    assert torch.equal(got, pair[side == "right"])


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [*RAGGED_BANDS[:2], (2, 100, 300),
                                   (1, 1, 1), (1, 300, 77), (4, 40, 3)])
def test_band_scores_kernel_at_ragged_tiles(shape, out_dtype):
    """K6 at depths that are no multiple of a register tile or of a chunk,
    at a depth below one register tile, on 1 x 1 and one-row images:
    negated, equal to K5 on the chunks that cover the depth (f32 out), or
    to the f32 scores rounded (bf16 out), at tolerance 0.0; within the
    plain version's tolerance."""
    device = require_card()
    height, width, depth = shape
    rng = np.random.default_rng(16)
    fl, fr = (torch.from_numpy(unit_features(rng, height, width)).to(device)
              for _ in "lr")
    build.LAUNCHES.reset()
    got = tcv.band_pair_scores(fl, fr, depth, out_dtype)
    assert _launched() == {"band_scores": 1}
    if out_dtype == torch.float32:
        d_pad = -(-depth // 128) * 128
        want = tuple(-v[..., :depth] for v in tcv.band_pair(
            fl, fr, d_pad, d_pad, torch.float32))
    else:
        want = tuple(v.to(out_dtype) for v in tcv.band_pair_scores(
            fl, fr, depth))
    plain = tcv.band_pair_scores_plain(fl, fr, depth, out_dtype)
    atol = 1e-5 if out_dtype == torch.float32 else 2.0 ** -8
    for ours, exact, reference in zip(got, want, plain):
        assert ours.dtype == out_dtype and ours.shape == reference.shape
        torch.testing.assert_close(ours, exact, rtol=0, atol=0)
        torch.testing.assert_close(ours.float(), reference.float(),
                                   rtol=0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(70, 150, 256, 200), (48, 64, 128, 16),
                                   (1, 1, 128, 1), (33, 5, 8, 8)])
def test_cbca_stencil_kernel_matches_plain(shape):
    """K7 against the plain f32 round and against K2: all bit-equal."""
    device = require_card()
    height, width, d_pad, ndisp = shape
    left, _ = _images(max(height, 48), max(width, 64))
    arms = tcbca.compute_arms(left[:height, :width].to(device), TAU, DIST)
    vol = _volume(np.random.default_rng(8), height, width, d_pad,
                  ndisp).to(device)
    keep = vol.clone()
    build.LAUNCHES.reset()
    got = cbca_pallas(vol, arms, 3, DIST)
    assert build.LAUNCHES.snapshot()["cbca_stencil_round"] == 3
    torch.testing.assert_close(vol, keep, rtol=0, atol=0)  # input untouched
    torch.testing.assert_close(got, tcbca.cbca(vol, arms, 3, DIST), rtol=0,
                               atol=0)
    if d_pad % 128 == 0:
        torch.testing.assert_close(got, cbca_fused(vol, arms, 3, DIST),
                                   rtol=0, atol=0)
    with pytest.raises(ValueError):
        cbca_pallas(vol.to(torch.bfloat16), arms, 1, DIST)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("shape", [(70, 150, 256, 200), (48, 64, 128, 16),
                                   (1, 1, 32, 1)])
def test_cbca_int8_kernel_matches_plain(shape, dtype):
    """K4 against ``cbca_int8_plain``: exact integer math, bit-equal, in
    the float modes and the pre-quantized raw mode; BIG lanes stay 127."""
    device = require_card()
    height, width, d_pad, ndisp = shape
    left, _ = _images(max(height, 48), max(width, 64))
    arms = tcbca.compute_arms(left[:height, :width].to(device), TAU, DIST)
    vol = _volume(np.random.default_rng(9), height, width, d_pad,
                  ndisp).to(device)
    vol = _quantize_int8(vol)[0] if dtype == torch.int8 else vol.to(dtype)
    build.LAUNCHES.reset()
    got = cbca_fused(vol, arms, 3, DIST, int8_storage=True)
    assert build.LAUNCHES.snapshot()["cbca_round_int8"] == 3
    assert got.dtype == dtype
    torch.testing.assert_close(got, cbca_int8_plain(vol, arms, 3, DIST),
                               rtol=0, atol=0)
    if dtype == torch.int8:
        assert bool((got[..., ndisp:] == 127).all())
        assert int(got[..., :ndisp].abs().max()) <= 126
    else:
        assert got[..., ndisp:].float().min().item() >= 1e8


@pytest.mark.cuda
def test_batch_schedules_launch_their_kernels():
    """The exact-f32, int8 d-chunked and staged schedules on the card."""
    device = require_card()
    params = init_params(0)
    left, right = (x.numpy() for x in _images(48, 150))
    ndisp = 200  # padded depth 256, so a 128-lane chunk really chunks
    left, right = np.tile(left, (1, 2)), np.tile(right, (1, 2))

    def run(stage_times=False, **kwargs):
        pipeline = MatchPipeline(params, bucket=1, device=device, **kwargs)
        build.LAUNCHES.reset()
        if stage_times:
            out, times = pipeline.stage_times(left, right, ndisp)
            assert list(times) == ["features", "cost_volume", "cbca_1", "sgm",
                                   "cbca_2", "wta", "lr_interpolation",
                                   "subpixel", "median", "bilateral"]
        else:
            out = pipeline(left, right, ndisp)
        return out, _launched()

    exact, counts = run(cbca_impl="pallas")
    assert counts == {"band_side": 2, "border_fill": 2,
                      "cbca_stencil_round": 36, "sgm_sweep": 8}
    staged, counts = run(stage_times=True, cbca_impl="pallas")
    assert counts == {"band_pair": 1, "border_fill": 2,
                      "cbca_stencil_round": 36, "sgm_sweep": 8}
    np.testing.assert_array_equal(staged, exact)
    fused, counts = run()
    assert counts == {"band_side": 2, "border_fill": 2, "cbca_round": 36,
                      "sgm_sweep": 8}
    np.testing.assert_array_equal(fused, exact)  # K2 == K7 in f32
    chunked, counts = run(cbca_chunk_d=128)
    assert counts == {"band_side": 2, "border_fill": 2, "cbca_round": 72,
                      "sgm_sweep": 8}
    np.testing.assert_array_equal(chunked, exact)
    int8, counts = run(cbca_impl="fused8", volume_dtype="bfloat16",
                       cbca_chunk_d=128)
    assert counts == {"band_side": 2, "border_fill": 2,
                      "cbca_round_int8": 72, "sgm_sweep": 8}
    assert np.isfinite(int8).all()
    assert np.mean(np.abs(int8 - exact) > 2.0) <= 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("distance", [1, 3, 17])
def test_single_pass_cbca_kernels_at_other_radii(distance):
    """K7 and K4 size their windows by the radius (distance - 1): 0, 2 and
    the largest they take, 16; 18 is refused."""
    device = require_card()
    left, _ = _images(70, 150)
    arms = tcbca.compute_arms(left.to(device), TAU, distance)
    vol = _volume(np.random.default_rng(10), 70, 150, 128, 70).to(device)
    torch.testing.assert_close(cbca_pallas(vol, arms, 2, distance),
                               tcbca.cbca(vol, arms, 2, distance), rtol=0,
                               atol=0)
    torch.testing.assert_close(
        cbca_fused(vol, arms, 2, distance, int8_storage=True),
        cbca_int8_plain(vol, arms, 2, distance), rtol=0, atol=0)
    with pytest.raises(ValueError, match="halo"):
        cbca_pallas(vol, arms, 1, 18)


_MODES = {"f32": (torch.float32, None), "bf16": (torch.bfloat16, None),
          "mixed": (torch.float32, torch.bfloat16)}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(_MODES))
@pytest.mark.parametrize("distance", [1, 2, 14, 17])
@pytest.mark.parametrize("shape", [(37, 70, 128, 5), (48, 64, 384, 300),
                                   (300, 40, 128, 64), (1, 1, 128, 1)])
def test_cbca_round_kernel_at_ragged_shapes(shape, distance, mode):
    """K2 where neither the strip (32 columns), the step (16 rows) nor the
    band (256 rows) divides the image, at radius 0, 1, 13 and 16 and one or
    three 128-lane chunks, in the three modes: bit-equal to the plain
    rounds, the input untouched, pad lanes still BIG."""
    device = require_card()
    dtype, compute = _MODES[mode]
    height, width, d_pad, ndisp = shape
    left, _ = _images(max(height, 48), max(width, 64))
    arms = tcbca.compute_arms(left[:height, :width].to(device), TAU, distance)
    vol = _volume(np.random.default_rng(17), height, width, d_pad,
                  ndisp).to(device, dtype)
    keep = vol.clone()
    build.LAUNCHES.reset()
    got = cbca_fused(vol, arms, 3, distance, compute_dtype=compute)
    assert _launched() == {"cbca_round": 3}
    torch.testing.assert_close(
        got, tcbca.cbca(vol, arms, 3, distance, compute), rtol=0, atol=0)
    torch.testing.assert_close(vol, keep, rtol=0, atol=0)
    assert got[..., ndisp:].float().min().item() >= 1e8
    inv = tcbca.inverse_region_size(arms, distance).contiguous()
    with pytest.raises(ValueError, match="in place"):
        cbca_round_cuda(vol, vol, arms, inv, distance)
    with pytest.raises(ValueError, match="halo"):
        cbca_fused(vol, arms, 1, 18)


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("shape", [(37, 70, 5), (37, 70, 64), (48, 64, 64),
                                   (5, 333, 200), (3, 1504, 200)])
def test_band_kernel_on_the_tensor_cores_at_ragged_shapes(shape, side):
    """K1 in bf16 (mma.sync): widths that are no multiple of its 64-column
    tile, narrower than one tile, and as wide as the serving path's; a
    chunk of pad lanes only (ndisp 5 and 64 of D_pad 128, 200 of 256)."""
    device = require_card()
    height, width, ndisp = shape
    d_pad = -(-ndisp // 128) * 128
    rng = np.random.default_rng(18)
    fl, fr = (torch.from_numpy(unit_features(rng, height, width)).to(
        device, torch.bfloat16) for _ in "lr")
    build.LAUNCHES.reset()
    got = tcv.band_side(fl, fr, ndisp, d_pad, side, torch.bfloat16)
    assert _launched() == {"band_side": 1}
    want = tcv.band_side_plain(fl, fr, ndisp, d_pad, side, torch.bfloat16)
    # exact products, the 64-term f32 sum in another order: one bf16 ulp
    torch.testing.assert_close(got[..., :ndisp].float(),
                               want[..., :ndisp].float(), atol=2.0 ** -8,
                               rtol=0)
    assert torch.equal(got[..., ndisp:], want[..., ndisp:])
    # where no correspondence exists the band holds exactly 0
    cols = torch.arange(width, device=device)[:, None]
    disps = torch.arange(ndisp, device=device)[None, :]
    valid = cols >= disps if side == "left" else cols + disps < width
    assert not bool(got[..., :ndisp][:, ~valid].any())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(_MODES))
@pytest.mark.parametrize("shape", [(70, 150, 256, 200), (300, 40, 128, 16),
                                   (40, 30, 128, 5), (1, 1, 16, 1)])
def test_rolling_and_two_round_kernels_equal_k2(shape, mode):
    """K8 and K9 against the plain rounds and, where K2 takes the depth,
    against K2: bit-equal in f32, bf16 storage and the bf16-operand mode,
    for even and odd round counts, on narrow and one-pixel images too (no
    fallback), over more rows than one band holds."""
    device = require_card()
    dtype, compute = _MODES[mode]
    height, width, d_pad, ndisp = shape
    left, _ = _images(max(height, 48), max(width, 64))
    arms = tcbca.compute_arms(left[:height, :width].to(device), TAU, DIST)
    vol = _volume(np.random.default_rng(11), height, width, d_pad,
                  ndisp).to(device, dtype)
    keep = vol.clone()
    for iterations in (2, 3):
        want = tcbca.cbca(vol, arms, iterations, DIST, compute)
        build.LAUNCHES.reset()
        got = cbca_fused_rolling(vol, arms, iterations, DIST,
                                 compute_dtype=compute)
        assert _launched() == {"cbca_rolling_round": iterations}
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        if iterations % 2 and d_pad % 128:
            continue  # the odd round runs on K2, which takes D % 128 == 0
        build.LAUNCHES.reset()
        got = cbca_fused_two(vol, arms, iterations, DIST,
                             compute_dtype=compute)
        odd = {"cbca_round": 1} if iterations % 2 else {}
        assert _launched() == {"cbca_two_rounds": iterations // 2, **odd}
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        if d_pad % 128 == 0:
            torch.testing.assert_close(
                got, cbca_fused(vol, arms, iterations, DIST,
                                compute_dtype=compute), rtol=0, atol=0)
    torch.testing.assert_close(vol, keep, rtol=0, atol=0)  # input untouched


@pytest.mark.cuda
@pytest.mark.parametrize("distance", [1, 3, 17])
def test_rolling_kernels_at_other_radii(distance):
    """K8 and K9 size their rings by the radius: 0, 2 and the largest they
    take, 16; 18 is refused."""
    device = require_card()
    left, _ = _images(70, 150)
    arms = tcbca.compute_arms(left.to(device), TAU, distance)
    vol = _volume(np.random.default_rng(12), 70, 150, 128, 70).to(device)
    want = tcbca.cbca(vol, arms, 2, distance)
    for variant in (cbca_fused_rolling, cbca_fused_two):
        torch.testing.assert_close(variant(vol, arms, 2, distance), want,
                                   rtol=0, atol=0)
        with pytest.raises(ValueError, match="halo"):
            variant(vol, arms, 2, 18)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(_MODES))
@pytest.mark.parametrize("distance", [14, 17])
def test_rolling_kernel_with_every_arm_at_the_radius(distance, mode):
    """K8 on the arms of a constant image, where every arm reaches the
    radius (13 and 16) inside the image and every group of offsets is
    summed, over more rows than a band of 512 holds and a ragged strip:
    bit-equal to the plain rounds and to K2, in the three modes."""
    device = require_card()
    dtype, compute = _MODES[mode]
    height, width, d_pad, ndisp = 601, 45, 128, 70
    arms = tcbca.compute_arms(torch.zeros((height, width), device=device),
                              TAU, distance)
    assert int(arms.left.max()) >= distance - 1
    vol = _volume(np.random.default_rng(14), height, width, d_pad,
                  ndisp).to(device, dtype)
    build.LAUNCHES.reset()
    got = cbca_fused_rolling(vol, arms, 3, distance, compute_dtype=compute)
    assert _launched() == {"cbca_rolling_round": 3}
    torch.testing.assert_close(
        got, tcbca.cbca(vol, arms, 3, distance, compute), rtol=0, atol=0)
    assert torch.equal(got, cbca_fused(vol, arms, 3, distance,
                                       compute_dtype=compute))
    assert got[..., ndisp:].float().min().item() >= 1e8


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(_MODES))
@pytest.mark.parametrize("distance", [2, 14, 17])
def test_rolling_kernel_at_its_smallest_depths(distance, mode):
    """K8 at one lane chunk, D = 16 in bf16 and D = 8 in f32 (K2 takes no
    such depth), over more rows than one band of 256 or 512 holds: bit-equal
    to the plain rounds; a depth of half a chunk is refused."""
    device = require_card()
    dtype, compute = _MODES[mode]
    d_pad = 16 if dtype == torch.bfloat16 else 8
    height, width = 600, 70
    left, _ = _images(height, width)
    arms = tcbca.compute_arms(left.to(device), TAU, distance)
    vol = _volume(np.random.default_rng(15), height, width, d_pad,
                  d_pad - 2).to(device, dtype)
    build.LAUNCHES.reset()
    got = cbca_fused_rolling(vol, arms, 2, distance, compute_dtype=compute)
    assert _launched() == {"cbca_rolling_round": 2}
    torch.testing.assert_close(
        got, tcbca.cbca(vol, arms, 2, distance, compute), rtol=0, atol=0)
    with pytest.raises(ValueError, match="D %"):
        cbca_fused_rolling(vol[..., :d_pad // 2].contiguous(), arms, 1,
                           distance, compute_dtype=compute)


@pytest.mark.cuda
def test_fused16_flag_of_k2_matches_plain():
    device = require_card()
    left, _ = _images(70, 150)
    arms = tcbca.compute_arms(left.to(device), TAU, DIST)
    vol = _volume(np.random.default_rng(13), 70, 150, 256, 200).to(device)
    got = cbca_fused(vol, arms, 3, DIST, compute_dtype=torch.bfloat16)
    torch.testing.assert_close(
        got, tcbca.cbca(vol, arms, 3, DIST, torch.bfloat16), rtol=0, atol=0)
    assert not torch.equal(got, cbca_fused(vol, arms, 3, DIST))


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(9, 150, 128), (3, 33, 20), (5, 420, 300)])
def test_band_scores_kernel_matches_plain_and_k5(shape, out_dtype):
    """K6 against its plain version and, negated, against K5 finalized
    with ndisp = d_pad (bit-equal: the same fmaf chain), at depths that
    are no multiple of a chunk too."""
    device = require_card()
    height, width, d_pad = shape
    rng = np.random.default_rng(14)
    fl, fr = (torch.from_numpy(unit_features(rng, height, width)).to(device)
              for _ in "lr")
    build.LAUNCHES.reset()
    got = tcv.band_pair_pallas(fl, fr, d_pad, use_mxu=False,
                               out_dtype=out_dtype)
    assert _launched() == {"band_scores": 1}
    want = tcv.band_pair_scores_plain(fl, fr, d_pad, out_dtype)
    atol = 1e-5 if out_dtype == torch.float32 else 2.0 ** -8
    for ours, plain in zip(got, want):
        assert ours.dtype == out_dtype
        torch.testing.assert_close(ours.float(), plain.float(), atol=atol,
                                   rtol=0)
    if d_pad % 128 == 0 and out_dtype == torch.float32:
        costs = tcv.band_pair(fl, fr, d_pad, d_pad, torch.float32)
        for ours, cost in zip(got, costs):
            torch.testing.assert_close(-ours, cost, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("paper_mode", [False, True])
def test_sgm_kernel_on_codes_equals_sgm_on_planes(paper_mode, dtype):
    device = require_card()
    images = [x.to(device) for x in _images(40, 72)]
    config = MatchConfig(sgm_paper_mode=paper_mode)
    volume = _volume(np.random.default_rng(15), 40, 72, 256, 200).to(device,
                                                                     dtype)
    for choice in ("L", "R"):
        want = tsgm._sgm_one_volume(volume.clone(), *images, choice, 200,
                                    config)
        build.LAUNCHES.reset()
        got = tsgm._sgm_one_volume(volume.clone(), *images, choice, 200,
                                   config.replace(sgm_u8=True))
        assert _launched() == {"sgm_sweep": 4}
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        plain = tsgm._sgm_one_volume(*_on_cpu(volume, *images), choice, 200,
                                     config.replace(sgm_u8=True))
        torch.testing.assert_close(got.cpu(), plain, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8])
@pytest.mark.parametrize("tiles", [(32, 32, 8), (32, 32, 128), (64, 128, 128),
                                   (1, 32, 16), (256, 32, 16), (2, 30, 128)])
def test_stream_kernel_copies_exactly(tiles, dtype):
    """K10: the output equals the input in both layouts; a view whose data
    is not 16-byte aligned is refused by the wrapper and by the entry."""
    device = require_card()
    tile_h, tile_w, tile_d = tiles
    if tile_d * torch.empty(0, dtype=dtype).element_size() % 16:
        pytest.skip("a chunk must be a multiple of 16 bytes")
    height, depth = max(2 * tile_h, 96), 256
    width = -(-max(2 * tile_w, 128) // tile_w) * tile_w
    generator = torch.Generator(device=device).manual_seed(16)
    flat = (torch.randn((height, width, depth), device=device,
                        generator=generator) * 50).to(dtype)
    build.LAUNCHES.reset()
    torch.testing.assert_close(
        stream.cbca_stream(flat, tile_h, tile_w, tile_d), flat, rtol=0,
        atol=0)
    split = flat.reshape(height, width, depth // tile_d, tile_d).permute(
        2, 0, 1, 3).contiguous()
    torch.testing.assert_close(
        stream.cbca_stream(split, tile_h, tile_w, tile_d, dsplit=True), split,
        rtol=0, atol=0)
    assert _launched() == {"cbca_stream": 2}
    with pytest.raises(ValueError):  # no whole number of column tiles
        stream.cbca_stream(flat[:, :width - 1].contiguous(), tile_h, tile_w,
                           tile_d)
    storage = torch.empty(flat.numel() + 1, dtype=dtype, device=device)
    shifted = storage[1:].view(flat.shape)  # one element off: misaligned
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        stream.cbca_stream(shifted, tile_h, tile_w, tile_d)
    chunk_bytes = tile_d * flat.element_size()
    code = build.library().mccnn_cbca_stream(
        shifted.data_ptr(), torch.empty_like(flat).data_ptr(), height, width,
        depth // tile_d, tile_h, tile_w, chunk_bytes, depth *
        flat.element_size(), chunk_bytes, build.stream_handle(flat))
    assert code == 1  # cudaErrorInvalidValue
    assert _launched() == {"cbca_stream": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("tiles,shape,dtype", [
    ((32, 32, 8192), (64, 64, 8192), torch.float32),
    ((1, 300, 16), (34, 600, 64), torch.bfloat16),
])
def test_stream_kernel_copies_wide_boxes(tiles, shape, dtype):
    """K10 where a box cannot take a whole chunk (32 KB chunks, split into
    pieces) or a whole centre row (300 columns, past TMA's 256)."""
    device = require_card()
    tile_h, tile_w, tile_d = tiles
    height, width, depth = shape
    generator = torch.Generator(device=device).manual_seed(17)
    flat = (torch.randn(shape, device=device, generator=generator) * 50).to(
        dtype)
    split = flat.reshape(height, width, depth // tile_d, tile_d).permute(
        2, 0, 1, 3).contiguous()
    build.LAUNCHES.reset()
    assert torch.equal(stream.cbca_stream(flat, *tiles), flat)
    assert torch.equal(stream.cbca_stream(split, *tiles, dsplit=True), split)
    assert _launched() == {"cbca_stream": 2}


@pytest.mark.cuda
def test_variant_schedules_launch_their_kernels():
    """rolling, fused2 (even and odd counts), fused16, mxu, joint regions
    and sgm_u8 on the card, against the K2 pipeline."""
    device = require_card()
    params = init_params(0)
    left, right = (x.numpy() for x in _images(48, 150))
    ndisp = 40

    def run(config=MatchConfig(), **kwargs):
        pipeline = MatchPipeline(params, config, bucket=1, device=device,
                                 **kwargs)
        build.LAUNCHES.reset()
        return pipeline(left, right, ndisp), _launched()

    fused, _ = run()
    rolling, counts = run(cbca_impl="rolling")
    assert counts == {"band_side": 2, "border_fill": 2,
                      "cbca_rolling_round": 36, "sgm_sweep": 8}
    np.testing.assert_array_equal(rolling, fused)
    two, counts = run(cbca_impl="fused2")
    assert counts == {"band_side": 2, "border_fill": 2,
                      "cbca_two_rounds": 18, "sgm_sweep": 8}
    np.testing.assert_array_equal(two, fused)
    odd = MatchConfig(cbca_num_iterations_1=3, cbca_num_iterations_2=5)
    two_odd, counts = run(odd, cbca_impl="fused2")
    assert counts == {"band_side": 2, "border_fill": 2,
                      "cbca_two_rounds": 6, "cbca_round": 4, "sgm_sweep": 8}
    np.testing.assert_array_equal(two_odd, run(odd)[0])
    coded, counts = run(MatchConfig(sgm_u8=True), cbca_impl="rolling")
    assert counts == {"band_side": 2, "border_fill": 2,
                      "cbca_rolling_round": 36, "sgm_sweep": 8}
    np.testing.assert_array_equal(coded, fused)
    mixed = [run(cbca_impl=impl)[0]
             for impl in ("fused16", "rolling16", "fused2_16")]
    np.testing.assert_array_equal(mixed[0], mixed[1])
    np.testing.assert_array_equal(mixed[0], mixed[2])
    for config, kwargs in ((MatchConfig(), {"cbca_impl": "mxu"}),
                           (MatchConfig(cbca_joint_regions=True), {})):
        got, counts = run(config, **kwargs)
        # the joint and mxu CBCA are torch ops
        assert counts == {"band_side": 2, "border_fill": 2, "sgm_sweep": 8}
        want = MatchPipeline(params, config, bucket=1, device="cpu",
                             **kwargs)(left, right, ndisp)
        # cuDNN and CPU convolutions round apart, so a few WTA ties flip
        assert np.mean(np.abs(got - want) > 1.0) <= 0.01


def _ring_lines(dtype, d_pad):
    """Lines per warp in K3's ring, from the constants of its source."""
    text = (build.SOURCE_DIR / "sgm_sweep.cu").read_text()
    const = {name: int(value) for name, value in re.findall(
        r"constexpr int (k\w+) = (\d+);", text)}
    line_bytes = d_pad * torch.empty(0, dtype=dtype).element_size()
    return min(const["kMaxLines"],
               max(const["kMinLines"], const["kRingBytes"] // line_bytes))


def _hold_sweeps(volume, images, config=MatchConfig()):
    """K3 against ``sweep_plain`` on the card for every direction, both
    volumes, in place and out of place, on the gradient planes and on
    penalty codes: bit-equal, the input of an out-of-place sweep untouched,
    pad lanes still BIG."""
    d_pad = volume.shape[2]
    for choice in ("L", "R"):
        for direction in tsgm._DIRECTIONS:
            for coded in (False, True):
                codes = tsgm.penalty_scale_u8(
                    *images, choice, direction, d_pad,
                    config.sgm_d) if coded else None
                for in_place in (True, False):
                    got, want = volume.clone(), volume.clone()
                    outs = (got, want) if in_place else (
                        torch.empty_like(volume), torch.empty_like(volume))
                    build.LAUNCHES.reset()
                    tsgm.sweep_cuda(got, outs[0], *images, choice, direction,
                                    config, codes)
                    assert _launched() == {"sgm_sweep": 1}
                    tsgm.sweep_plain(want, outs[1], *images, choice,
                                     direction, config, codes)
                    what = (choice, direction, coded, in_place)
                    torch.testing.assert_close(outs[0], outs[1], rtol=0,
                                               atol=0, msg=str(what))
                    if not in_place:
                        assert torch.equal(got, volume)
                    assert outs[0][..., -3:].float().min().item() >= 1e8


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d_pad", [128, 256, 384, 512])
@pytest.mark.parametrize("lines", ["1", "2", "k-1", "k", "k+1"])
def test_sgm_sweep_kernel_at_the_ring_edges(lines, d_pad, dtype):
    """K3 on sweeps of 1, 2, k - 1, k and k + 1 lines, where k is the depth
    of a warp's ring at this D_pad and type: vertical sweeps of n rows and
    horizontal sweeps of n columns."""
    device = require_card()
    k = _ring_lines(dtype, d_pad)
    n = {"1": 1, "2": 2, "k-1": k - 1, "k": k, "k+1": k + 1}[lines]
    rng = np.random.default_rng(18)
    for height, width in ((n, 7), (5, n)):
        left, right = _images(48, 64)
        images = [x[:height, :width].contiguous().to(device)
                  for x in (left, right)]
        volume = _volume(rng, height, width, d_pad, d_pad - 3).to(device,
                                                                  dtype)
        _hold_sweeps(volume, images)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", RAGGED_SHAPES)
def test_sgm_sweep_kernel_at_ragged_shapes(shape, dtype):
    """K3 where no ring depth, block of four fibres or 16-byte chunk of a
    penalty row divides the image (chip_smoke.py's ragged shapes)."""
    device = require_card()
    height, width, d_pad = shape
    left, right = _images(max(height, 48), max(width, 64))
    images = [x[:height, :width].contiguous().to(device)
              for x in (left, right)]
    volume = _volume(np.random.default_rng(19), height, width, d_pad,
                     d_pad - 3).to(device, dtype)
    _hold_sweeps(volume, images)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sgm_sweep_kernel_with_zero_minima(dtype):
    """Lines whose minimum over d is an exact zero of either sign: K3's
    ordered min-reduction and the plain ``amin`` may pick different zeros,
    which can change the sign of a zero result and never a value."""
    device = require_card()
    rng = np.random.default_rng(20)
    height, width, d_pad = 24, 40, 128
    values = rng.integers(0, 3, (height, width, d_pad)).astype(np.float32)
    values = np.where(rng.random(values.shape) < 0.5, values, -values)
    values = np.where(values == 0.0, values, np.abs(values))  # +-0 and > 0
    values[..., -3:] = BIG_COST
    volume = torch.from_numpy(values).to(device, dtype)
    assert bool(torch.signbit(volume).any())
    left, right = _images(48, 64)
    images = [x[:height, :width].contiguous().to(device)
              for x in (left, right)]
    _hold_sweeps(volume, images)


@pytest.mark.cuda
@pytest.mark.parametrize("radius", RAGGED_RADII)
@pytest.mark.parametrize("shape", RAGGED_SHAPES)
def test_cbca_stencil_kernel_at_ragged_shapes(shape, radius):
    """K7 where neither the 32-column strip, the 32-row step (16 at radius
    16) nor the 256-row band divides the image: three rounds bit-equal to
    the plain rounds and to K2 in f32, the input untouched, pad lanes BIG."""
    device = require_card()
    height, width, d_pad = shape
    distance = radius + 1
    left, _ = _images(max(height, 48), max(width, 64))
    arms = tcbca.compute_arms(left[:height, :width].to(device), TAU,
                              distance)
    vol = _volume(np.random.default_rng(21), height, width, d_pad,
                  d_pad - 28).to(device)
    keep = vol.clone()
    build.LAUNCHES.reset()
    got = cbca_pallas(vol, arms, 3, distance)
    assert _launched() == {"cbca_stencil_round": 3}
    torch.testing.assert_close(got, tcbca.cbca(vol, arms, 3, distance),
                               rtol=0, atol=0)
    torch.testing.assert_close(got, cbca_fused(vol, arms, 3, distance),
                               rtol=0, atol=0)
    torch.testing.assert_close(vol, keep, rtol=0, atol=0)
    assert got[..., d_pad - 28:].min().item() >= 1e8


def _flat_arms(height, width, distance, device):
    """Every arm at the radius, capped at the border (a constant image)."""
    return tcbca.compute_arms(torch.zeros((height, width), device=device),
                              TAU, distance)


@pytest.mark.cuda
@pytest.mark.parametrize("arms_kind", ["scene", "full"])
@pytest.mark.parametrize("mode", sorted(_MODES))
@pytest.mark.parametrize("radius", RAGGED_RADII)
@pytest.mark.parametrize("shape", RAGGED_SHAPES)
def test_two_round_kernel_at_ragged_shapes(shape, radius, mode, arms_kind):
    """K9 where neither its 32-column strip, 8-row step nor 256-row band
    divides the image, at radius 0, 1, 13 and 16, on the scene's arms and
    with every arm at the radius: one pass bit-equal to the plain rounds and
    to two K2 rounds, the input untouched, pad lanes BIG."""
    device = require_card()
    dtype, compute = _MODES[mode]
    height, width, d_pad = shape
    distance = radius + 1
    if arms_kind == "full":
        arms = _flat_arms(height, width, distance, device)
    else:
        left, _ = _images(max(height, 48), max(width, 64))
        arms = tcbca.compute_arms(left[:height, :width].to(device), TAU,
                                  distance)
    vol = _volume(np.random.default_rng(22), height, width, d_pad,
                  d_pad - 28).to(device, dtype)
    keep = vol.clone()
    build.LAUNCHES.reset()
    got = cbca_fused_two(vol, arms, 2, distance, compute_dtype=compute)
    assert _launched() == {"cbca_two_rounds": 1}
    torch.testing.assert_close(
        got, tcbca.cbca(vol, arms, 2, distance, compute), rtol=0, atol=0)
    torch.testing.assert_close(
        got, cbca_fused(vol, arms, 2, distance, compute_dtype=compute),
        rtol=0, atol=0)
    torch.testing.assert_close(vol, keep, rtol=0, atol=0)
    assert got[..., d_pad - 28:].float().min().item() >= 1e8


@pytest.mark.cuda
@pytest.mark.parametrize("arms_kind", ["scene", "full"])
@pytest.mark.parametrize("distance", [1, 14, 17])
@pytest.mark.parametrize("d_pad", [32, 128, 256])
def test_cbca_int8_kernel_at_depths(d_pad, distance, arms_kind):
    """K4 (16 lanes a block) at D = 32, 128 and 256, radius 0, 13 and 16, on
    the scene's arms and with every arm at the radius, in the raw and the
    float modes: bit-equal to ``cbca_int8_plain``, BIG lanes 127."""
    device = require_card()
    height, width = 37, 70
    if arms_kind == "full":
        arms = _flat_arms(height, width, distance, device)
    else:
        left, _ = _images(48, 70)
        arms = tcbca.compute_arms(left[:height].to(device), TAU, distance)
    vol = _volume(np.random.default_rng(23), height, width, d_pad,
                  d_pad - 5).to(device)
    raw = _quantize_int8(vol)[0]
    for operand in (raw, vol.to(torch.bfloat16)):
        build.LAUNCHES.reset()
        got = cbca_fused(operand, arms, 2, distance, int8_storage=True)
        assert _launched() == {"cbca_round_int8": 2}
        torch.testing.assert_close(
            got, cbca_int8_plain(operand, arms, 2, distance), rtol=0, atol=0)
    raw_out = cbca_fused(raw, arms, 1, distance, int8_storage=True)
    assert bool((raw_out[..., d_pad - 5:] == 127).all())
