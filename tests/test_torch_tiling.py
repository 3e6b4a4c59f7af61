"""Torch models of the index arithmetic of kernels K2, K7, K8, K4, K9, K1,
K5, K6, K3 and K10, on the CPU.

The CUDA kernels run only on a card, and only there are they held against
their plain versions (``tests/test_torch_kernels.py``, ``chip_smoke.py``).
These tests guard a model of the kernels, not the kernels: what can go
wrong in a kernel before any arithmetic does is an offset (a tile's origin,
a halo, a ring slot, a diagonal), and the models repeat that arithmetic
step by step in torch, so a decomposition can be shown right before it is
written in CUDA. The tile sizes and the radius split are read from the CUDA
sources; the formulas (the lag of the vertical sums, the n-tiles of a warp)
are the model's own copy. One case per distinct piece of arithmetic:

  * K2, K7 and K8 (``csrc/cbca_walk.cuh``, the walk all three run;
    ``csrc/cbca_round.cu``, ``csrc/cbca_stencil.cu`` and
    ``csrc/cbca_rolling.cu`` set its step and band): strips of 32 columns
    and bands of 256 rows (512 in K8), walked in steps of 16 (K2, K8 in
    bf16) or 32 rows (K7 and K8 in f32 up to R = 13); raw rows with a halo
    of R columns, zero outside the image; horizontal sums into a ring of
    rows, vertical sums out of the ring a fixed number of steps later; sums
    in the plain round's order. Against ``ops.cbca.cbca_round``, tolerance
    0.0.
  * K4 (``csrc/cbca_round_int8.cu``): the same walk on an int8 stage of 16
    lanes a block, the sums exact, the store rounded half to even. Against
    ``ops.cbca_fused.cbca_round_int8_plain``, tolerance 0.0.
  * K9 (``csrc/cbca_two_round.cu``): two walks chained per strip: round A
    on the 64 columns round B can reach, from raw rows with a halo of 2R
    columns and rows; its vertical sums emitted into an intermediate stage,
    rounded to the storage type and 0 outside the image; round B's
    horizontal sums on that stage one step later, its vertical sums a lag
    behind them. Against two ``ops.cbca.cbca_round`` calls, tolerance 0.0,
    in f32, bf16 and the bf16-operand mode.
  * K1 (``csrc/band.cu``, bf16 route): per (64-column tile, 128-disparity
    chunk) the correlation of the anchor tile with a (64 + 128)-column
    context window, the band read off its diagonals per 16-row warp tile of
    18 n-tiles. Against ``ops.cost_volume.band_side_plain``: bf16 inputs
    one bf16 ulp, zeros and pad lanes exact; the same offsets on f32 inputs
    to 1e-5 (another summation order).
  * K1's f32 route (``csrc/band.cu`` on ``csrc/band_tile.cuh``, one-sided):
    per (column tile up to ``width``, chunk) the tile of one direction, the
    right side's context window from ``w0 + d0`` read along anti-diagonals
    (x = col + dl) by the left side's multiply-add loop with the
    accumulators' disparities reversed; rows stored only, every element
    once; the block and per-thread skips; masks at ``width``, ``ndisp`` and
    ``d_pad``; the pad-chunk fill. Against ``band_side_plain`` on both
    sides: zeros and pad lanes exact, values to 1e-5.
  * K5 and K6 (``csrc/band_tile.cuh``, the block routine both run): per
    (column tile, 128-disparity chunk) one correlation tile of fL's
    anchor columns and fR's context window, zero outside the image,
    stored as the left band's rows and the right band's diagonals, column
    tiles up to ``width + d_max``; each lane's register tile of columns x
    disparities at a stride of 4, read off its diagonals; the per-thread
    skip of tiles with nothing to compute; the epilogues' masks at
    ``width``, ``ndisp`` and ``depth``; the pad-chunk fill; every element
    stored once; the shared-memory budget of the header's note. Against
    ``band_pair_plain`` and ``band_pair_scores_plain``: zeros and pad
    lanes exact, values to 1e-5.
  * K3 (``csrc/sgm_sweep.cu``): a ring of lines per fibre filled a fixed
    number of lines ahead, which slot holds which line in both sweep
    orders, that an in-place sweep reads each line before it writes it, and
    the penalty bytes a slot or a staged row holds: the 16-byte-aligned
    window of the padded D2 plane (``ops.sgm.kernel_planes``) at both image
    edges, the D1 chunk, the code line. Against ``ops.sgm.sweep_plain``,
    tolerance 0.0.
  * K10 (``csrc/cbca_stream.cu``): each block's window cut into TMA boxes
    (bands of rows wholly in the halo or the centre, halo boxes clamped
    into the window, centre boxes, a chunk's pieces), every box within
    TMA's limits and a ring slot, the ring of slots in the kernel's order
    (which use of a slot a wait names, no refill before the store that
    reads the slot has read it), every window word read and every output
    word written once. Against ``Tensor.clone()``, tolerance 0.0.
"""

import importlib
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mccnn_tpu_torch.ops import cost_volume as tcv  # noqa: E402
from mccnn_tpu_torch.ops.cbca_fused import (  # noqa: E402
    cbca_round_int8_plain,
)
from mccnn_tpu_torch.ops.common import BIG_COST  # noqa: E402
from mccnn_tpu_torch.utils.config import MatchConfig  # noqa: E402

from torch_parity import scene_pair, unit_features  # noqa: E402

# the modules, not the functions mccnn_tpu_torch.ops exports under their names
tcbca = importlib.import_module("mccnn_tpu_torch.ops.cbca")
tsgm = importlib.import_module("mccnn_tpu_torch.ops.sgm")

_CSRC = Path(tcbca.__file__).resolve().parents[1] / "csrc"


def _constants(source: str) -> dict:
    """The ``constexpr int kName = <number>;`` lines of a CUDA source."""
    text = (_CSRC / source).read_text()
    return {name: int(value) for name, value in re.findall(
        r"constexpr int (k\w+) = (\d+);", text)}


WALK = _constants("cbca_walk.cuh")
K2 = {**WALK, **_constants("cbca_round.cu")}
K7 = {**WALK, **_constants("cbca_stencil.cu")}
K4 = {**WALK, **_constants("cbca_round_int8.cu")}
K8 = {**WALK, **_constants("cbca_rolling.cu")}
K9 = {**WALK, **_constants("cbca_two_round.cu")}
K1 = _constants("band.cu")
TILE = _constants("band_tile.cuh")
K3 = _constants("sgm_sweep.cu")
# the radius up to which K2 and K7 run their smaller instantiation, and the
# larger
K2_SMALL_R = int(re.search(r"radius <= (\d+)",
                           (_CSRC / "cbca_round.cu").read_text()).group(1))
K7_SMALL_R = int(re.search(r"radius <= (\d+)",
                           (_CSRC / "cbca_stencil.cu").read_text()).group(1))
K2_LARGE_R = _constants("cbca_arms.cuh")["kArmHalo"]
K4_SMALL_R, K9_SMALL_R, K8_SMALL_R = (
    int(re.search(r"radius <= (\d+)", (_CSRC / name).read_text()).group(1))
    for name in ("cbca_round_int8.cu", "cbca_two_round.cu",
                 "cbca_rolling.cu"))


def test_the_models_read_the_kernels_constants():
    assert {"kTileW", "kBatch", "kBandH", "kLpt", "kSkip"} <= set(K2)
    assert K2["kTileW"] == 32 and K2["kBatch"] == 16
    assert (K2_SMALL_R, K7_SMALL_R, K2_LARGE_R) == (13, 13, 16)
    assert (K7["kBatch"], K7["kThreads"], K7["kBatchAt16"]) == (32, 512, 16)
    assert (K4["kBatch"], K4["kThreads"], K4["kLanes"]) == (16, 256, 16)
    assert (K9["kLanes2"], K9["kBatch2"], K9["kSegCols"]) == (8, 8, 8)
    assert (K4_SMALL_R, K9_SMALL_R, K8_SMALL_R) == (13, 13, 13)
    assert (K8["kThreads"], K8["kBatch"]) == (256, 16)
    assert (K8["kThreadsF32"], K8["kBatchF32"]) == (512, 32)
    assert K8["kBandRows"] == 2 * K8["kBandH"] == 512
    assert {"kChannels", "kChunkD", "kMmaTileW", "kSideBw", "kSideBd",
            "kSideTileW"} <= set(K1)
    assert K1["kChunkD"] == 128 and K1["kMmaTileW"] == 64
    assert (K1["kSideBw"], K1["kSideBd"], K1["kSideTileW"]) == (4, 16, 64)
    assert {"kChannels", "kChunkD", "kLanes", "kSliceC", "kBw", "kBd",
            "kTileW"} <= set(TILE)
    assert (TILE["kChunkD"], TILE["kLanes"], TILE["kSliceC"]) == (128, 4, 16)
    assert (TILE["kBw"], TILE["kBd"], TILE["kTileW"]) == (8, 8, 64)
    assert {"kRingBytes", "kMaxLines", "kMinLines", "kChunk"} <= set(K3)
    assert {"kHalo", "kThreads", "kStages", "kSlotBytes", "kPromotion",
            "kRowRuns", "kMaxBox", "kWord", "kSlotAlign", "kPiece"} <= set(K10)
    assert (K10["kHalo"], K10["kThreads"], K10["kMaxBox"]) == (16, 32, 256)


def _gated_sum(line, centre0, count, neg, pos, radius_r):
    """Sums of ``count`` neighbouring windows along dim 1 of ``line``
    ((n, positions, D)): window s has its centre at position centre0 + s and
    adds, in the kernel's order, +o where o <= pos and -o where o <= neg."""
    acc = line[:, centre0:centre0 + count].clone()
    for o in range(1, radius_r + 1):
        plus = line[:, centre0 + o:centre0 + o + count]
        minus = line[:, centre0 - o:centre0 - o + count]
        acc = acc + torch.where((pos >= o)[..., None], plus, 0.0)
        acc = acc + torch.where((neg >= o)[..., None], minus, 0.0)
    return acc


def _plane(values, rows, cols, fill=0):
    """``values[rows][:, cols]`` of an (H, W) plane with ``fill`` where a
    row or column lies outside it (the zero-filling copy)."""
    height, width = values.shape
    out = torch.full((len(rows), len(cols)), fill, dtype=values.dtype)
    ok_r = (rows >= 0) & (rows < height)
    ok_c = (cols >= 0) & (cols < width)
    inside = values[rows[ok_r]][:, cols[ok_c]]
    out[ok_r[:, None] & ok_c[None, :]] = inside.flatten()
    return out


def _store(values, dtype):
    """A round's store into the storage type: int8 rounds half to even."""
    if dtype == torch.int8:
        values = torch.round(values)
    return values.to(dtype)


def k2_model(volume, arms, inv_region, distance, compute_dtype=None,
             band_h=None, kernel=K2):
    """One round as ``cbca_walk_kernel`` decomposes it (all lane chunks at
    once: the lane offset d0 + lane is the kernel's only use of them), with
    the step of K2 or, ``kernel=K7``, of K7, ``kernel=K4``, of K4 on an
    int8 volume, or ``kernel=K8``, K8's step and band in the volume's
    storage type."""
    radius = distance - 1
    # the template parameter R, and the step height at that R
    reach = K2_SMALL_R if radius <= K2_SMALL_R else K2_LARGE_R
    batch = kernel["kBatch"]
    if kernel is K7 and reach > K7_SMALL_R:
        batch = kernel["kBatchAt16"]
    if (kernel is K8 and volume.dtype == torch.float32
            and reach <= K8_SMALL_R):
        batch = kernel["kBatchF32"]
    tile_w = kernel["kTileW"]
    band_h = band_h or kernel.get("kBandRows", kernel["kBandH"])
    lag = -(-2 * reach // batch)
    ring_rows = (lag + 1) * batch
    height, width, depth = volume.shape
    operand = volume.float()
    if compute_dtype == torch.bfloat16:
        operand = operand.to(torch.bfloat16).float()
    out = torch.zeros_like(volume)
    written = torch.zeros((height, width), dtype=torch.int32)
    for hb0 in range(0, height, band_h):
        hb1 = min(hb0 + band_h, height)
        steps = -(-(hb1 - hb0) // batch) + lag
        for w0 in range(0, width, tile_w):
            ring = torch.full((ring_rows, tile_w, depth), float("nan"))
            raw_cols = torch.arange(w0 - reach, w0 + tile_w + reach)
            out_cols = torch.arange(w0, w0 + tile_w)
            for j in range(steps):
                rows = hb0 - reach + j * batch + torch.arange(batch)
                # raw rows: zero outside the image and past the band's halo
                raw = torch.zeros((batch, len(raw_cols), depth))
                ok_r = (rows >= 0) & (rows < min(height, hb1 + reach))
                ok_c = (raw_cols >= 0) & (raw_cols < width)
                raw[ok_r[:, None] & ok_c[None, :]] = operand[
                    rows[ok_r]][:, raw_cols[ok_c]].reshape(-1, depth)
                left = _plane(arms.left, rows, out_cols).clamp(max=radius)
                right = _plane(arms.right, rows, out_cols).clamp(max=radius)
                # H: raw column c is image column w0 - R + c
                slot0 = (j % (lag + 1)) * batch
                ring[slot0:slot0 + batch] = _gated_sum(
                    raw, reach, tile_w, left, right, reach)
                if j < lag:
                    continue
                # V: ring offset k is image row hb0 - R + k
                first = (j - lag) * batch
                out_rows = hb0 + first + torch.arange(batch)
                up = _plane(arms.up, out_rows, out_cols).clamp(max=radius)
                down = _plane(arms.down, out_rows, out_cols).clamp(max=radius)
                inv = _plane(inv_region, out_rows, out_cols, 0.0)
                slots = (first + torch.arange(batch + 2 * reach)) % ring_rows
                column = ring[slots].permute(1, 0, 2)  # (col, position, D)
                sums = _gated_sum(column, reach, batch, up.T, down.T,
                                  reach).permute(1, 0, 2)
                keep_r = out_rows < hb1
                keep_c = out_cols < width
                result = _store(sums * inv[..., None], volume.dtype)
                out[out_rows[keep_r][:, None], out_cols[keep_c][None, :]] = \
                    result[keep_r][:, keep_c]
                written[out_rows[keep_r][:, None],
                        out_cols[keep_c][None, :]] += 1
    assert bool((written == 1).all())  # every pixel stored exactly once
    return out


def _round_case(height, width, depth, distance, dtype, seed, capped=True):
    rng = np.random.default_rng(seed)
    left, _, _, _ = scene_pair("textureless", max(height, 48),
                               max(width, 64), seed=5)
    image = torch.from_numpy(left)[:height, :width]
    if capped:
        arms = tcbca.compute_arms(image, 0.02, distance)
    else:  # arms that run past the border: they add the halo's zeros
        arms = tcbca.CrossArms(*(
            torch.from_numpy(rng.integers(0, distance, (height, width))
                             .astype(np.int32)) for _ in range(4)))
    values = rng.uniform(-1, 1, (height, width, depth)).astype(np.float32)
    values[..., depth - 3:] = BIG_COST
    volume = torch.from_numpy(values).to(dtype)
    inv = tcbca.inverse_region_size(arms, distance)
    return volume, arms, inv


_ROUND_MODES = {"f32": (torch.float32, None), "bf16": (torch.bfloat16, None),
                "mixed": (torch.float32, torch.bfloat16)}


# every radius split (0, 1, R = 13, R = 16) at a shape ragged in both axes;
# the three operand modes at a shape that fills its strips
@pytest.mark.parametrize("shape,distance,mode", [
    ((37, 70), 1, "f32"), ((37, 70), 2, "f32"), ((37, 70), 14, "f32"),
    ((37, 70), 17, "f32"), ((48, 64), 14, "f32"), ((48, 64), 14, "bf16"),
    ((48, 64), 14, "mixed"),
])
def test_k2_tiling_model_equals_plain_round(shape, distance, mode):
    dtype, compute = _ROUND_MODES[mode]
    volume, arms, inv = _round_case(*shape, 8, distance, dtype, seed=20)
    want = tcbca.cbca_round(volume, arms, inv, distance, compute)
    # bands of 32 rows: two bands with a ragged last one, each with its halo
    got = k2_model(volume, arms, inv, distance, compute, band_h=32)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_k2_tiling_model_at_the_kernels_band_height(shape=(300, 40)):
    volume, arms, inv = _round_case(*shape, 4, 14, torch.float32, seed=21)
    want = tcbca.cbca_round(volume, arms, inv, 14)
    torch.testing.assert_close(k2_model(volume, arms, inv, 14), want, rtol=0,
                               atol=0)


# K7's 32-row steps at R = 13 (radius 0, 1, 13) and K2's shape at R = 16,
# with two ragged bands and at the kernel's band height
@pytest.mark.parametrize("shape,distance,band_h", [
    ((37, 70), 1, 64), ((37, 70), 2, 64), ((75, 70), 14, 64),
    ((37, 70), 17, 32), ((300, 40), 14, None),
])
def test_k7_tiling_model_equals_plain_round(shape, distance, band_h):
    volume, arms, inv = _round_case(*shape, 8, distance, torch.float32,
                                    seed=24)
    want = tcbca.cbca_round(volume, arms, inv, distance)
    got = k2_model(volume, arms, inv, distance, band_h=band_h, kernel=K7)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# K8 at its own band height, in f32 at its 32-row steps (K7's lever) and
# in bf16 at K2's shape, on more rows than one band holds
@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_k8_tiling_model_at_its_band_height(mode, distance=14):
    dtype, _ = _ROUND_MODES[mode]
    height = K8["kBandRows"] + 44  # two bands, the second ragged
    volume, arms, inv = _round_case(height, 40, 8, distance, dtype, seed=25)
    want = tcbca.cbca_round(volume, arms, inv, distance)
    got = k2_model(volume, arms, inv, distance, kernel=K8)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# K4: int8 volumes (BIG lanes 127) at both radius splits, a ragged shape
@pytest.mark.parametrize("shape,distance", [((37, 70), 14), ((37, 70), 17)])
def test_k4_tiling_model_equals_plain_int8_round(shape, distance):
    volume, arms, inv = _round_case(*shape, 16, distance, torch.float32,
                                    seed=26)
    q = torch.clamp(torch.round(volume * 100), -126, 127).to(torch.int8)
    want = cbca_round_int8_plain(q, arms, inv, distance)
    got = k2_model(q, arms, inv, distance, band_h=32, kernel=K4)
    assert got.dtype == torch.int8 and bool((got[..., -3:] == 127).all())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def k9_shape(reach):
    """Constants of ``TwoShape``: A's columns, raw columns, lag, ring rows,
    and the shared bytes of a block in each storage type."""
    lanes, batch = K9["kLanes2"], K9["kBatch2"]
    cols_a = K9["kTileW"] + 2 * K2_LARGE_R
    raw_cols = cols_a + 2 * reach
    lag = -(-2 * reach // batch)
    ring_rows = (lag + 1) * batch
    planes = 4 * 2 * K9["kPlanes"] * batch * (cols_a + 1 + K9["kTileW"] + 1)
    rings = 4 * ring_rows * lanes * (cols_a + 1 + K9["kTileW"] + 1)
    shared = {size: rings + planes + size * lanes * batch * (
        2 * (raw_cols + 1) + cols_a + 1) for size in (2, 4)}
    return cols_a, raw_cols, lag, ring_rows, shared


def test_k9_shape_fits_the_block_as_its_note_says():
    note = (_CSRC / "cbca_two_round.cu").read_text()
    for reach, bf16, f32 in ((K9_SMALL_R, "188,416", "220,032"),
                             (K2_LARGE_R, "189,952", "223,104")):
        cols_a, _, lag, ring_rows, shared = k9_shape(reach)
        assert (cols_a, lag, ring_rows) == (64, 4, 40)
        assert shared[2] == int(bf16.replace(",", "")) and bf16 in note
        assert shared[4] == int(f32.replace(",", "")) and f32 in note
        assert shared[4] <= 232448
    # every thread walks once per phase: A's warps, then B's
    seg = K9["kSegCols"]
    assert 32 * (cols_a // seg + K9["kTileW"] // seg) == 384


def k9_model(volume, arms, inv_region, distance, compute_dtype=None,
             band_h=None):
    """One pass as ``cbca_two_round_kernel`` decomposes it: per strip and
    band, walk A over the 64 columns B can reach, its V emitting into an
    intermediate stage that walk B's H reads one step later."""
    radius = distance - 1
    reach = K9_SMALL_R if radius <= K9_SMALL_R else K2_LARGE_R
    tile_w, batch = K9["kTileW"], K9["kBatch2"]
    band_h = band_h or K9["kBandH"]
    cols_a, raw_cols, lag, ring_rows, _ = k9_shape(reach)
    height, width, depth = volume.shape
    operand = volume.float()
    if compute_dtype == torch.bfloat16:
        operand = operand.to(torch.bfloat16).float()

    def as_operand(stage):  # round B's operand, as round A's
        stage = stage.float()
        if compute_dtype == torch.bfloat16:
            stage = stage.to(torch.bfloat16).float()
        return stage

    def arm(plane, rows, cols):
        return _plane(plane, rows, cols).clamp(max=radius)

    out = torch.zeros_like(volume)
    written = torch.zeros((height, width), dtype=torch.int32)
    for hb0 in range(0, height, band_h):
        hb1 = min(hb0 + band_h, height)
        ya0, yb0 = hb0 - 2 * reach, hb0 - reach
        steps = -(-(hb1 - hb0) // batch) + 2 * lag + 1
        for w0 in range(0, width, tile_w):
            ring_a = torch.full((ring_rows, cols_a, depth), float("nan"))
            ring_b = torch.full((ring_rows, tile_w, depth), float("nan"))
            stage = None
            raw_x = torch.arange(w0 - 2 * reach, w0 - 2 * reach + raw_cols)
            a_x = torch.arange(w0 - reach, w0 - reach + cols_a)
            b_x = torch.arange(w0, w0 + tile_w)
            for j in range(steps):
                jb = j - 1 - lag
                rows = ya0 + j * batch + torch.arange(batch)
                raw = torch.zeros((batch, raw_cols, depth))
                ok_r = (rows >= 0) & (rows < min(height, hb1 + 2 * reach))
                ok_c = (raw_x >= 0) & (raw_x < width)
                raw[ok_r[:, None] & ok_c[None, :]] = operand[
                    rows[ok_r]][:, raw_x[ok_c]].reshape(-1, depth)
                # phase 1: A's H into ring A; B's H on the stage A's V
                # filled one step before
                slot = (j % (lag + 1)) * batch
                ring_a[slot:slot + batch] = _gated_sum(
                    raw, reach, cols_a, arm(arms.left, rows, a_x),
                    arm(arms.right, rows, a_x), reach)
                if jb >= 0:
                    b_rows = yb0 + jb * batch + torch.arange(batch)
                    slot = (jb % (lag + 1)) * batch
                    ring_b[slot:slot + batch] = _gated_sum(
                        as_operand(stage), reach, tile_w,
                        arm(arms.left, b_rows, b_x),
                        arm(arms.right, b_rows, b_x), reach)
                # phase 2: A's V into the stage; B's V into the output
                if j >= lag:
                    first = (j - lag) * batch
                    o = yb0 + first + torch.arange(batch)
                    slots = (first + torch.arange(batch + 2 * reach)) \
                        % ring_rows
                    sums = _gated_sum(
                        ring_a[slots].permute(1, 0, 2), reach, batch,
                        arm(arms.up, o, a_x).T, arm(arms.down, o, a_x).T,
                        reach).permute(1, 0, 2)
                    inv = _plane(inv_region, o, a_x, 0.0)
                    inside = ((o >= 0) & (o < height))[:, None] & \
                        ((a_x >= 0) & (a_x < width))[None, :]
                    stage = torch.where(inside[..., None],
                                        sums * inv[..., None],
                                        0.0).to(volume.dtype)
                if jb >= lag:
                    first = (jb - lag) * batch
                    o = hb0 + first + torch.arange(batch)
                    slots = (first + torch.arange(batch + 2 * reach)) \
                        % ring_rows
                    sums = _gated_sum(
                        ring_b[slots].permute(1, 0, 2), reach, batch,
                        arm(arms.up, o, b_x).T, arm(arms.down, o, b_x).T,
                        reach).permute(1, 0, 2)
                    inv = _plane(inv_region, o, b_x, 0.0)
                    keep_r, keep_c = o < hb1, b_x < width
                    result = (sums * inv[..., None]).to(volume.dtype)
                    out[o[keep_r][:, None], b_x[keep_c][None, :]] = \
                        result[keep_r][:, keep_c]
                    written[o[keep_r][:, None], b_x[keep_c][None, :]] += 1
    assert bool((written == 1).all())  # every pixel stored exactly once
    return out


# the radius splits at a ragged shape with two bands (f32), the three
# operand modes, and arms that run past the border (they add the zeros the
# intermediate holds outside the image)
@pytest.mark.parametrize("shape,distance,mode,capped", [
    ((37, 70), 2, "f32", True), ((37, 70), 14, "f32", True),
    ((37, 70), 17, "bf16", True), ((37, 40), 14, "mixed", True),
    ((37, 40), 17, "f32", False),
])
def test_k9_tiling_model_equals_two_plain_rounds(shape, distance, mode,
                                                 capped):
    dtype, compute = _ROUND_MODES[mode]
    volume, arms, inv = _round_case(*shape, 4, distance, dtype, seed=27,
                                    capped=capped)
    once = tcbca.cbca_round(volume, arms, inv, distance, compute)
    want = tcbca.cbca_round(once, arms, inv, distance, compute)
    got = k9_model(volume, arms, inv, distance, compute, band_h=24)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("distance", [14, 17])
def test_k2_tiling_model_with_arms_past_the_border(distance):
    volume, arms, inv = _round_case(37, 70, 4, distance, torch.float32,
                                    seed=22, capped=False)
    want = tcbca.cbca_round(volume, arms, inv, distance)
    got = k2_model(volume, arms, inv, distance, band_h=32)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def k1_model(anchor, other, ndisp, d_pad, side, dtype):
    """One side's band as ``band_side_bf16_kernel`` tiles it."""
    tile_w, chunk_d = K1["kMmaTileW"], K1["kChunkD"]
    n_tiles = (16 + chunk_d) // 8
    height, width, _ = anchor.shape
    right = side == "right"
    a, o = anchor.float(), other.float()
    out = torch.full((height, width, d_pad), float("nan"))
    wl = torch.arange(tile_w)[:, None]
    dl = torch.arange(chunk_d)[None, :]
    for d0 in range(0, d_pad, chunk_d):
        for w0 in range(0, width, tile_w):
            cols = w0 + torch.arange(tile_w)
            keep = cols < width
            if d0 >= ndisp:  # the whole chunk is pad lanes
                out[:, cols[keep], d0:d0 + chunk_d] = BIG_COST
                continue
            base = w0 + d0 if right else w0 - d0 - (chunk_d - 1)
            ctx_cols = base + torch.arange(tile_w + chunk_d)
            tile = torch.zeros((height, tile_w, a.shape[2]))
            tile[:, keep] = a[:, cols[keep]]
            ctx = torch.zeros((height, tile_w + chunk_d, a.shape[2]))
            ok = (ctx_cols >= 0) & (ctx_cols < width)
            ctx[:, ok] = o[:, ctx_cols[ok]]
            corr = torch.bmm(tile, ctx.transpose(1, 2))  # (H, 64, 192)
            # the band's diagonal: context column x of anchor row wl
            x = wl + dl if right else wl - dl + (chunk_d - 1)
            # warp m reads only its 18 n-tiles: columns 16 m .. 16 m + 143
            m0 = wl // 16 * 16
            assert bool(((x >= m0) & (x < m0 + 8 * n_tiles)).all())
            assert int(x.max()) < tile_w + chunk_d
            band = -torch.gather(corr, 2, x.expand(height, -1, -1))
            gw, d = w0 + wl, d0 + dl
            src = gw + d if right else gw - d
            band = torch.where((src >= 0) & (src < width), band, 0.0)
            band = torch.where(d < ndisp, band, BIG_COST)
            out[:, cols[keep], d0:d0 + chunk_d] = band[:, keep]
    assert not bool(torch.isnan(out).any())  # every element stored
    return out.to(dtype)


# per side: a ragged last tile, a full tile with a full chunk's worth of
# lanes, a second chunk that is partly pad lanes, a chunk that is all pad
# lanes; then the same offsets on f32 inputs
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("shape,ndisp,d_pad,dtype", [
    ((7, 70), 5, 128, torch.bfloat16),
    ((6, 64), 64, 128, torch.bfloat16),
    ((3, 200), 200, 256, torch.bfloat16),
    ((7, 70), 5, 256, torch.bfloat16),
    ((3, 200), 200, 256, torch.float32),
])
def test_k1_tiling_model_equals_plain_band(shape, ndisp, d_pad, dtype, side):
    height, width = shape
    rng = np.random.default_rng(23)
    fl, fr = (torch.from_numpy(unit_features(rng, height, width)).to(dtype)
              for _ in "lr")
    got = k1_model(fl, fr, ndisp, d_pad, side, dtype)
    want = tcv.band_side_plain(fl, fr, ndisp, d_pad, side, dtype)
    # the 64-term f32 sum in another order: 1e-5 at |cost| <= 1; the stored
    # bf16 value may then round one ulp (2^-8) apart
    atol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
    torch.testing.assert_close(got[..., :ndisp].float(),
                               want[..., :ndisp].float(), rtol=0, atol=atol)
    assert torch.equal(got[..., ndisp:], want[..., ndisp:])
    cols = torch.arange(width)[:, None]
    disps = torch.arange(ndisp)[None, :]
    valid = cols >= disps if side == "left" else cols + disps < width
    assert not bool(got[..., :ndisp][:, ~valid].any())


def band_tile_shape(bw, bd, tile_w):
    """``Tile<bw, bd, tile_w>`` and ``Layout``: threads, and the shared
    bytes of a block for f32 and bf16 descriptors (the tile of either
    output type overlaid), the f32 tile's and a raw bf16 slice's bytes."""
    lanes, chunk, slice_c = TILE["kLanes"], TILE["kChunkD"], TILE["kSliceC"]
    threads = 32 * (tile_w // (2 * lanes * bw)) * (chunk // (lanes * bd))
    pixels = 2 * tile_w + chunk - 1  # anchor, then context
    f32_slice = pixels * (slice_c + 4) * 4
    raw_slice = pixels * slice_c * 2
    tile = {size: tile_w * (chunk + 16 // size) * size for size in (2, 4)}
    shared = {"f32": max(2 * f32_slice, tile[4]),
              "bf16": max(f32_slice + 2 * raw_slice, tile[2])}
    return threads, shared, tile[4], raw_slice


def test_band_tile_fits_the_block_as_its_note_says():
    note = (_CSRC / "band_tile.cuh").read_text()
    threads, shared, tile32, raw = band_tile_shape(
        TILE["kBw"], TILE["kBd"], TILE["kTileW"])
    assert threads == 128 and f"{threads} threads" in note
    for value in (shared["f32"], shared["bf16"], tile32, raw):
        assert f"{value:,}" in note
    # four blocks per SM: 228 KB, 1 KB of it reserved per block, and the
    # register file at 128 registers a thread
    assert 4 * (shared["f32"] + 1024) <= 228 * 1024
    assert 4 * threads * 128 <= 65536
    # K1's one-sided tile: the same threads and f32 bytes, as band.cu's
    # note says
    side_threads, side_shared, side_tile32, _ = band_tile_shape(
        *K1_SIDE_TILE)
    assert (side_threads, side_shared["f32"]) == (threads, shared["f32"])
    k1_note = (_CSRC / "band.cu").read_text()
    assert f"{side_threads} threads" in k1_note
    for value in (side_shared["f32"], side_tile32):
        assert f"{value:,} bytes" in k1_note


def band_tile_lanes(bw, bd, tile_w):
    """Every thread of a block (warp -> (wc, wd), lane -> (h, p, q)): its
    first column col0 and first disparity dmin in the block's tile."""
    lanes = TILE["kLanes"]
    t = torch.arange(band_tile_shape(bw, bd, tile_w)[0])
    lane, warp = t % 32, t // 32
    p, q, h = lane % lanes, lane // lanes % lanes, lane // 16
    warps_w = tile_w // (2 * lanes * bw)
    col0 = warp % warps_w * 2 * lanes * bw + h * lanes * bw + p
    dmin = warp // warps_w * lanes * bd + q
    return col0, dmin


def band_tile_model(fl, fr, depth, compute_end, epilogue, shape=None):
    """Both bands as the block routine of ``band_tile.cuh`` makes them, at
    ``shape`` = (Bw, Bd, block columns), the shipped one by default: per
    (column tile, chunk) the correlation tile t[w][d] = <fL(w), fR(w - d)>,
    stored as the left band's rows and the right band's diagonals.
    ``epilogue(score, d, matched)`` gives the stored value; no sums at
    d >= ``compute_end``; lanes d >= ``depth`` are not stored."""
    bw, bd, tile_w = shape or (TILE["kBw"], TILE["kBd"], TILE["kTileW"])
    lanes, chunk = TILE["kLanes"], TILE["kChunkD"]
    height, width, _ = fl.shape
    a, o = fl.float(), fr.float()
    out = torch.full((2, height, width, depth), float("nan"))
    stores = torch.zeros((2, width, depth), dtype=torch.int64)
    col0, dmin = band_tile_lanes(bw, bd, tile_w)
    xb = col0 - dmin + chunk - 1 - lanes * (bd - 1)
    i = torch.arange(bw)[None, :, None]
    j = torch.arange(bd)[None, None, :]
    col = (col0[:, None, None] + lanes * i).expand(-1, bw, bd)
    dl = (dmin[:, None, None] + lanes * j).expand(-1, bw, bd)
    x = xb[:, None, None] + lanes * (i - j + bd - 1)
    # the diagonal: context column x holds fR column w0 - d0 - 127 + x
    assert torch.equal(x, col - dl + chunk - 1)
    assert int(x.min()) >= 0 and int(x.max()) < tile_w + chunk - 1
    cells = torch.zeros((tile_w, chunk), dtype=torch.int64)
    cells.index_put_((col, dl), torch.ones_like(col), accumulate=True)
    assert bool((cells == 1).all())  # each tile element once per block
    # the right pixels: diagonal r holds lanes dl at tile row r - 127 + dl
    r = torch.arange(tile_w + chunk - 1)[:, None]
    rl = torch.arange(chunk)[None, :]
    on_tile = (r - (chunk - 1) + rl >= 0) & (r - (chunk - 1) + rl < tile_w)
    chunks = -(-depth // chunk)
    for d0 in range(0, chunks * chunk, chunk):
        # column tiles up to width + d_max: every right pixel's lanes
        for w0 in range(0, width + chunks * chunk - 1, tile_w):
            if w0 >= width + d0 + chunk - 1:
                continue  # no left or right pixel of this tile is stored
            gw, gd = w0 + col, d0 + dl
            score = torch.zeros((height, *col.shape))
            if d0 < compute_end and w0 < width and w0 + tile_w - 1 >= d0:
                anchor = torch.zeros((height, tile_w, 64))
                ctx = torch.zeros((height, tile_w + chunk - 1, 64))
                cols = w0 + torch.arange(tile_w)
                anchor[:, cols < width] = a[:, cols[cols < width]]
                cols = w0 - d0 - (chunk - 1) + torch.arange(
                    tile_w + chunk - 1)
                ok = (cols >= 0) & (cols < width)
                ctx[:, ok] = o[:, cols[ok]]
                score = (anchor[:, col] * ctx[:, x]).sum(-1)
                # a thread skips its sums when its whole tile lies past the
                # image, past the end, or out of range
                lo_w, lo_d = gw[:, 0, 0], gd[:, 0, 0]
                active = ((lo_w < width) & (lo_d < compute_end)
                          & (lo_w + lanes * (bw - 1) >= lo_d))
                score[:, ~active] = 0.0
            tile = torch.empty((height, tile_w, chunk))
            tile[:, col, dl] = epilogue(score, gd, (gw >= gd) & (gw < width))
            stored = min(chunk, depth - d0)
            rows = torch.arange(tile_w)
            rows = rows[w0 + rows < width]
            out[0][:, w0 + rows, d0:d0 + stored] = tile[:, rows, :stored]
            stores[0][w0 + rows, d0:d0 + stored] += 1
            wr = w0 - d0 - (chunk - 1) + r
            keep = on_tile & (wr >= 0) & (wr < width) & (rl < stored)
            rr, ll = (v.expand_as(keep)[keep] for v in (r, rl))
            out[1][:, (wr.expand_as(keep))[keep], d0 + ll] = tile[
                :, rr - (chunk - 1) + ll, ll]
            stores[1].index_put_(((wr.expand_as(keep))[keep], d0 + ll),
                                 torch.ones_like(ll), accumulate=True)
    assert bool((stores == 1).all())  # every element stored once
    return out[0], out[1]


def _k5_epilogue(ndisp):
    def value(score, d, matched):
        return torch.where(d >= ndisp, BIG_COST,
                           torch.where(matched, -score, 0.0))
    return value


def _k6_epilogue(score, d, matched):
    return torch.where(matched, score, 0.0)


# a ragged column tile with ndisp no multiple of a register tile, a second
# chunk partly pad lanes, a width below d_pad with a chunk of pad lanes
# only; the shipped tile and a narrower one
@pytest.mark.parametrize("shape", [None, (4, 8, 32)])
@pytest.mark.parametrize("size,ndisp,d_pad", [
    ((2, 70), 5, 128),
    ((2, 150), 130, 256),
    ((1, 33), 20, 256),
])
def test_band_tile_model_equals_plain_k5(size, ndisp, d_pad, shape):
    height, width = size
    rng = np.random.default_rng(31)
    fl, fr = (torch.from_numpy(unit_features(rng, height, width))
              for _ in "lr")
    got = band_tile_model(fl, fr, d_pad, ndisp, _k5_epilogue(ndisp), shape)
    want = tcv.band_pair_plain(fl, fr, ndisp, d_pad, torch.float32)
    for ours, plain in zip(got, want):
        zero = plain[..., :ndisp] == 0
        assert torch.equal(ours[..., :ndisp][zero], plain[..., :ndisp][zero])
        assert torch.equal(ours[..., ndisp:], plain[..., ndisp:])
        torch.testing.assert_close(ours, plain, rtol=0, atol=1e-5)


# K6: a depth that is no multiple of a register tile or of a chunk, and one
# below a register tile
@pytest.mark.parametrize("size,depth", [((2, 150), 300), ((3, 40), 3)])
def test_band_tile_model_equals_plain_k6(size, depth):
    height, width = size
    rng = np.random.default_rng(32)
    fl, fr = (torch.from_numpy(unit_features(rng, height, width))
              for _ in "lr")
    got = band_tile_model(fl, fr, depth, depth, _k6_epilogue)
    want = tcv.band_pair_scores_plain(fl, fr, depth)
    for ours, plain in zip(got, want):
        assert torch.equal(ours[plain == 0], plain[plain == 0])
        torch.testing.assert_close(ours, plain, rtol=0, atol=1e-5)


K1_SIDE_TILE = (K1["kSideBw"], K1["kSideBd"], K1["kSideTileW"])


def band_side_tile_model(anchor, other, ndisp, d_pad, side, shape=None):
    """One finalized band as K1's f32 route runs the block routine of
    ``band_tile.cuh`` one-sided, at ``shape`` = (Bw, Bd, block columns),
    K1's shipped one by default: per (column tile up to ``width``, chunk)
    the tile t[w][d] = <anchor(w), other(w - d)> (left) or
    <anchor(w), other(w + d)> (right), read by one multiply-add loop along
    its diagonals or anti-diagonals, its rows stored; a chunk of pad lanes
    only filled with ``BIG_COST`` and nothing staged."""
    bw, bd, tile_w = shape or K1_SIDE_TILE
    lanes, chunk = TILE["kLanes"], TILE["kChunkD"]
    right = side == "right"
    height, width, _ = anchor.shape
    a, o = anchor.float(), other.float()
    out = torch.full((height, width, d_pad), float("nan"))
    stores = torch.zeros((width, d_pad), dtype=torch.int64)
    col0, dmin = band_tile_lanes(bw, bd, tile_w)
    i = torch.arange(bw)[None, :, None]
    j = torch.arange(bd)[None, None, :]
    col = (col0[:, None, None] + lanes * i).expand(-1, bw, bd)
    # accumulator (i, j) holds disparity dmin + 4 j on the left and
    # dmin + 4 (Bd - 1 - j) on the right; both read context column
    # xb + 4 (i - j + Bd - 1)
    dl = (dmin[:, None, None]
          + lanes * ((bd - 1 - j) if right else j)).expand(-1, bw, bd)
    xb = col0 + dmin if right else col0 - dmin + chunk - 1 - lanes * (bd - 1)
    x = xb[:, None, None] + lanes * (i - j + bd - 1)
    # the context window holds other column w0 + d0 + x on the right (the
    # anti-diagonal x = col + dl), w0 - d0 - 127 + x on the left
    assert torch.equal(x, col + dl if right else col - dl + chunk - 1)
    assert int(x.min()) >= 0 and int(x.max()) < tile_w + chunk - 1
    cells = torch.zeros((tile_w, chunk), dtype=torch.int64)
    cells.index_put_((col, dl), torch.ones_like(col), accumulate=True)
    assert bool((cells == 1).all())  # each tile element once per block
    rows = torch.arange(tile_w)
    for d0 in range(0, d_pad, chunk):
        for w0 in range(0, width, tile_w):  # column tiles up to width only
            keep = rows[w0 + rows < width]
            if d0 >= ndisp:  # pad lanes only: the fill, no tile
                out[:, w0 + keep, d0:d0 + chunk] = BIG_COST
                stores[w0 + keep, d0:d0 + chunk] += 1
                continue
            gw, gd = w0 + col, d0 + dl
            matched = (gw < width) & ((gw + gd < width) if right
                                      else (gw >= gd))
            real = bool((matched & (gd < ndisp)).any())
            # block-uniform: some output of the tile is a real match
            assert real == (w0 + d0 < width if right
                            else w0 + tile_w - 1 >= d0)
            score = torch.zeros((height, *col.shape))
            if real:
                origin = w0 + d0 if right else w0 - d0 - (chunk - 1)
                tile = torch.zeros((height, tile_w, 64))
                ctx = torch.zeros((height, tile_w + chunk - 1, 64))
                cols = w0 + rows
                tile[:, cols < width] = a[:, cols[cols < width]]
                cols = origin + torch.arange(tile_w + chunk - 1)
                ok = (cols >= 0) & (cols < width)
                ctx[:, ok] = o[:, cols[ok]]
                score = (tile[:, col] * ctx[:, x]).sum(-1)
                # a thread skips its sums when its whole tile lies past the
                # image, past ndisp or out of range: its first column and
                # disparity (the lowest of each) decide
                lo_w, lo_d = w0 + col0, d0 + dmin
                active = (lo_w < width) & (lo_d < ndisp) & (
                    lo_w + lo_d < width if right
                    else lo_w + lanes * (bw - 1) >= lo_d)
                assert not bool((matched & (gd < ndisp))[~active].any())
                score[:, ~active] = 0.0
            band = torch.empty((height, tile_w, chunk))
            band[:, col, dl] = torch.where(
                gd >= ndisp, BIG_COST, torch.where(matched, -score, 0.0))
            out[:, w0 + keep, d0:d0 + chunk] = band[:, keep]
            stores[w0 + keep, d0:d0 + chunk] += 1
    assert bool((stores == 1).all())  # every band element stored once
    return out


# test_k1_tiling_model_equals_plain_band's shapes on f32 descriptors (a
# ragged last tile, a full tile, a second chunk partly pad lanes, a width
# below d_pad with a chunk of pad lanes only), both sides; then K5's tile
# one-sided on the last
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("size,ndisp,d_pad,shape", [
    ((7, 70), 5, 128, None),
    ((6, 64), 64, 128, None),
    ((3, 200), 200, 256, None),
    ((7, 70), 5, 256, None),
    ((7, 70), 5, 256, (8, 8, 64)),
])
def test_band_side_tile_model_equals_plain_band(size, ndisp, d_pad, shape,
                                                side):
    height, width = size
    rng = np.random.default_rng(33)
    fl, fr = (torch.from_numpy(unit_features(rng, height, width))
              for _ in "lr")
    anchor, other = (fl, fr) if side == "left" else (fr, fl)
    got = band_side_tile_model(anchor, other, ndisp, d_pad, side, shape)
    want = tcv.band_side_plain(anchor, other, ndisp, d_pad, side,
                               torch.float32)
    zero = want[..., :ndisp] == 0
    assert torch.equal(got[..., :ndisp][zero], want[..., :ndisp][zero])
    assert torch.equal(got[..., ndisp:], want[..., ndisp:])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def k3_lines(dtype, d_pad):
    """Lines in a warp's ring (``Ring::kLines``)."""
    line_bytes = d_pad * torch.empty(0, dtype=dtype).element_size()
    return min(K3["kMaxLines"],
               max(K3["kMinLines"], K3["kRingBytes"] // line_bytes))


def k3_model(vol_in, vol_out, left_image, right_image, choice, direction,
             config, codes=None):
    """One sweep as ``sgm_sweep_kernel`` walks it, every fibre at once: the
    ring of lines, the penalty bytes each slot or staged row holds, the
    DP step of ``sweep_plain``. Returns the order of line reads and writes.
    """
    vertical, forward, p1_base, p2_base = tsgm._sweep_params(direction,
                                                             config)
    height, width, d_pad = vol_in.shape
    lines = k3_lines(vol_in.dtype, d_pad)
    chunk = K3["kChunk"]
    left = choice == "L"
    src = vol_in if vertical else vol_in.transpose(0, 1)
    dst = vol_out if vertical else vol_out.transpose(0, 1)
    size, perp = src.shape[0], src.shape[1]
    first, step = (0, 1) if forward else (size - 1, -1)
    fibres = torch.arange(perp)
    disps = torch.arange(d_pad)
    if codes is None:
        d1, d2 = tsgm.kernel_planes(left_image, right_image, choice,
                                    direction, d_pad, config.sgm_d)
        pitch1, pitch2 = d1.shape[1], d2.shape[1]
        assert pitch1 % chunk == 0 and pitch2 % chunk == 0
    # a vertical sweep's D2 window starts at the run's first column, aligned
    # down to a chunk
    run_base = ((fibres + 1) if left else (fibres + d_pad)) // chunk * chunk
    ring = [None] * lines
    events = []

    def request(n, slot):
        s = first + n * step
        events.append(("read", s))
        if codes is not None:
            penalty = codes[s]
        elif vertical:
            # the window and the D1 chunk of image row s, whole chunks
            # inside the row
            window = run_base[:, None] + torch.arange(d_pad + chunk)
            own = (fibres // chunk * chunk)[:, None] + torch.arange(chunk)
            assert int(window.max()) < pitch2 and int(own.max()) < pitch1
            penalty = (d2[s][window], d1[s][own])
        else:
            penalty = None
        ring[slot] = (s, src[s].clone(), penalty)

    def fetch(n, slot):
        ahead = n + lines - 1
        if ahead < size:
            request(ahead, (slot - 1) % lines)
        s, line, penalty = ring[slot]
        assert s == first + n * step  # the slot holds the line of this step
        return s, line, penalty

    for n in range(lines - 1):
        if n < size:
            request(n, n)
    _, line, _ = fetch(0, 0)
    prev = line.float()
    if vol_out.data_ptr() != vol_in.data_ptr():
        dst[first] = line
        events.append(("write", first))
    big = torch.full((perp, 1), BIG_COST)
    slot = 1
    for n in range(1, size):
        s, line, penalty = fetch(n, slot)
        if codes is not None:
            cls = penalty.long()
        else:
            w = fibres[:, None] if vertical else s
            column = w + d_pad - disps if left else w + d_pad + disps
            if vertical:
                window, own = penalty
                offset = column - run_base[:, None]
                assert int(offset.min()) >= 0
                assert int(offset.max()) < d_pad + chunk
                b2 = window.gather(1, offset)
                b1 = own.gather(1, (fibres % chunk)[:, None])
            else:  # the staged plane rows of image row p
                b2 = d2[:, column]
                b1 = d1[:, s][:, None]
            cls = 2 - (b1 != 0).long() - (b2 != 0).long()
        scale = torch.where(cls == 0, 1.0, torch.where(
            cls == 1, 1.0 / config.sgm_q1, 1.0 / config.sgm_q2))
        min_prev = prev.amin(dim=1, keepdim=True)
        neighbor = torch.minimum(torch.cat([big, prev[:, :-1]], dim=1),
                                 torch.cat([prev[:, 1:], big], dim=1))
        candidate = torch.minimum(
            torch.minimum(prev, neighbor + p1_base * scale),
            min_prev + p2_base * scale)
        prev = line.float() + candidate - min_prev
        dst[s] = prev.to(vol_out.dtype)
        events.append(("write", s))
        slot = (slot + 1) % lines
    return events


def _sweep_case(height, width, d_pad, dtype, seed):
    rng = np.random.default_rng(seed)
    left, right, _, _ = scene_pair("textureless", max(height, 48),
                                   max(width, 64), seed=5)
    images = [torch.from_numpy(x)[:height, :width] for x in (left, right)]
    values = rng.uniform(-1, 1, (height, width, d_pad)).astype(np.float32)
    values[..., d_pad - 5:] = BIG_COST
    return torch.from_numpy(values).to(dtype), images


# rings of 16 lines (bf16 or f32 at D_pad 128) and 8 (f32 at 256) around
# sweeps longer and shorter than the ring, one and two lines; in place (the
# chained mode), out of place, on codes; all four directions, both volumes
@pytest.mark.parametrize("shape,dtype,mode", [
    ((19, 37, 128), torch.bfloat16, "in place"),
    ((10, 9, 256), torch.float32, "out of place"),
    ((17, 15, 128), torch.float32, "codes"),
    ((1, 2, 128), torch.bfloat16, "in place"),
])
def test_k3_ring_model_equals_plain_sweep(shape, dtype, mode):
    config = MatchConfig()
    volume, images = _sweep_case(*shape, dtype, seed=25)
    for choice in ("L", "R"):
        for direction in tsgm._DIRECTIONS:
            codes = None
            if mode == "codes":
                codes = tsgm.penalty_scale_u8(*images, choice, direction,
                                              shape[2], config.sgm_d)
            want = torch.empty_like(volume)
            tsgm.sweep_plain(volume, want, *images, choice, direction,
                             config, codes)
            got = volume.clone() if mode == "in place" else \
                torch.empty_like(volume)
            source = got if mode == "in place" else volume
            events = k3_model(source, got, *images, choice, direction,
                              config, codes)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
            # in place, every line is read before it is written, and once
            reads = [line for kind, line in events if kind == "read"]
            writes = [line for kind, line in events if kind == "write"]
            assert sorted(reads) == list(range(len(reads)))
            for line in writes:
                assert events.index(("read", line)) < events.index(
                    ("write", line))


K10 = _constants("cbca_stream.cu")
MAX_SHARED = _constants("common.cuh")["kMaxSharedBytes"]
TMA_TX_LIMIT = 2 ** 20 - 1  # bytes an mbarrier phase can count


def _divisor_at_most(n, cap, step=1):
    """The largest divisor of n up to cap that is a multiple of step."""
    d = min(n, cap) // step * step
    while d > step:
        if n % d == 0:
            return d
        d -= step
    return step


def k10_plan(height, width, tile_h, tile_w, chunk_bytes, one_chunk_pixels):
    """K10's boxes for one launch (``make_plan`` and the entry in
    ``csrc/cbca_stream.cu``): rows, centre and halo columns, the words of a
    piece and the pieces of a box along a chunk, and whether a box's columns
    share its first dimension with the chunk's words (row runs: a pixel is
    one chunk, dsplit or flat with one chunk)."""
    word, max_box, halo = K10["kWord"], K10["kMaxBox"], K10["kHalo"]
    words = chunk_bytes // word
    row_runs = (bool(K10["kRowRuns"]) and one_chunk_pixels
                and words <= max_box)
    piece_words = words if row_runs else _divisor_at_most(
        words, max_box, K10["kPiece"] // word)
    chunk_pieces = words // piece_words
    col_cap = max_box // words if row_runs else max_box
    rows = int(np.gcd(tile_h, halo))
    centre = _divisor_at_most(tile_w, col_cap)
    halo_cols = min(halo, col_cap)
    pieces = _divisor_at_most(chunk_pieces, max_box)

    def nbytes(cols):
        return word * piece_words * pieces * cols * rows

    while max(nbytes(centre), nbytes(halo_cols)) > K10["kSlotBytes"]:
        if rows > 1:
            rows //= 2
        elif centre > 1 and centre >= halo_cols:
            centre = _divisor_at_most(tile_w, centre - 1)
        elif halo_cols > 1:
            halo_cols //= 2
        elif pieces > 1:
            pieces = _divisor_at_most(chunk_pieces, pieces - 1)
        else:
            break
    align = K10["kSlotAlign"]
    slot = -(-max(nbytes(centre), nbytes(halo_cols)) // align) * align
    return {"rows": rows, "centre_cols": centre, "halo_cols": halo_cols,
            "row_runs": row_runs, "piece_words": piece_words,
            "pieces": pieces,
            "chunk_pieces": chunk_pieces, "centre_bytes": nbytes(centre),
            "halo_bytes": nbytes(halo_cols), "slot_bytes": slot}


def k10_boxes(plan, height, width, tile_h, tile_w, col0, row0):
    """One block's boxes in the kernel's order, as (piece offset in the
    chunk, x, y, centre, stored), and the block's window."""
    halo = K10["kHalo"]
    span_h, span_w = tile_h + 2 * halo, tile_w + 2 * halo
    col_base = min(max(col0 - halo, 0), width - span_w)
    row_base = min(max(row0 - halo, 0), height - span_h)
    col_end = col_base + span_w
    hc, cc = plan["halo_cols"], plan["centre_cols"]
    n_left = -(-(col0 - col_base) // hc)
    n_centre = tile_w // cc
    n_cols = n_left + n_centre + -(-(col_end - col0 - tile_w) // hc)
    boxes = []
    for band in range(span_h // plan["rows"]):
        y = row_base + band * plan["rows"]
        for col in range(n_cols):
            centre = n_left <= col < n_left + n_centre
            if col < n_left:
                x = max(min(col_base + col * hc, col0 - hc), col_base)
            elif centre:
                x = col0 + (col - n_left) * cc
            else:
                x = min(col0 + tile_w + (col - n_left - n_centre) * hc,
                        col_end - hc)
            stored = centre and row0 <= y < row0 + tile_h
            for i in range(plan["chunk_pieces"] // plan["pieces"]):
                boxes.append((i * plan["pieces"], x, y, centre, stored))
    return boxes, (row_base, col_base, span_h, span_w)


def k10_model(volume, tile_h, tile_w, tile_d, dsplit=False):
    """K10 on the CPU, box by box: each block's boxes go through a ring of
    kStages slots in the kernel's order and its centre boxes come back out.
    Asserts TMA's limits on every box, the shared-memory budget, that the
    ring never refills a slot a store has yet to read, that every window
    word is read and none outside it, and that every output word is written
    once. Returns the output and the bytes the boxes read."""
    if dsplit:
        n_chunks, height, width, _ = volume.shape
    else:
        height, width, depth = volume.shape
        n_chunks = depth // tile_d
    chunk_bytes = tile_d * volume.element_size()
    plan = k10_plan(height, width, tile_h, tile_w, chunk_bytes,
                    dsplit or n_chunks == 1)
    pw, stages = plan["piece_words"], K10["kStages"]
    # the maps' five dimensions, outermost first: (chunks, H, W, pieces,
    # words of a piece); flat keeps every chunk's pieces in dimension 1
    words = volume.contiguous().view(torch.int32).numpy()
    grid = words.reshape(n_chunks if dsplit else 1, height, width, -1, pw)
    out = np.zeros_like(grid)
    written = np.zeros(grid.shape[:4], dtype=np.int64)
    assert (pw * K10["kWord"]) % 16 == 0 and pw <= K10["kMaxBox"]
    assert stages >= 3
    assert stages * K10["kSlotBytes"] + K10["kSlotAlign"] <= MAX_SHARED
    for key in ("centre", "halo"):
        cols = plan[f"{key}_cols"]
        # the box's first dimension: a piece's words, or in row runs the
        # columns' chunks
        inner = cols * pw if plan["row_runs"] else pw
        assert inner <= K10["kMaxBox"] and (inner * K10["kWord"]) % 16 == 0
        assert max(plan["rows"], cols, plan["pieces"]) <= K10["kMaxBox"]
        assert plan[f"{key}_bytes"] <= min(plan["slot_bytes"],
                                           K10["kSlotBytes"], TMA_TX_LIMIT)
    read = 0
    for ty in range(height // tile_h):
        for tx in range(width // tile_w):
            for chunk in range(n_chunks):  # the fastest grid index
                c4 = chunk if dsplit else 0
                p0 = 0 if dsplit else chunk * plan["chunk_pieces"]
                boxes, (r0, c0, span_h, span_w) = k10_boxes(
                    plan, height, width, tile_h, tile_w, tx * tile_w,
                    ty * tile_h)
                seen = np.zeros((span_h, span_w, plan["chunk_pieces"]),
                                dtype=bool)
                slots, armed, pending = [None] * stages, [0] * stages, []

                def issue(n):
                    piece, x, y, centre, _ = boxes[n]
                    cols = plan["centre_cols" if centre else "halo_cols"]
                    assert 0 <= y and y + plan["rows"] <= height
                    assert 0 <= x and x + cols <= width
                    assert r0 <= y and y + plan["rows"] <= r0 + span_h
                    assert c0 <= x and x + cols <= c0 + span_w
                    assert piece + plan["pieces"] <= plan["chunk_pieces"]
                    slot = n % stages
                    assert all(m % stages != slot for m in pending)
                    armed[slot] += 1
                    ys = slice(y, y + plan["rows"])
                    xs = slice(x, x + cols)
                    ps = slice(p0 + piece, p0 + piece + plan["pieces"])
                    slots[slot] = (n, grid[c4, ys, xs, ps].copy())
                    seen[y - r0:y - r0 + plan["rows"], x - c0:x - c0 + cols,
                         piece:piece + plan["pieces"]] = True
                    return slots[slot][1].nbytes

                for n in range(min(stages, len(boxes))):
                    read += issue(n)
                stored_last = False
                for n, (piece, x, y, centre, stored) in enumerate(boxes):
                    slot = n % stages
                    # the wait's parity names this use of the slot
                    assert armed[slot] == n // stages + 1
                    assert slots[slot][0] == n
                    if stored:
                        index = (c4, slice(y, y + plan["rows"]),
                                 slice(x, x + plan["centre_cols"]),
                                 slice(p0 + piece,
                                       p0 + piece + plan["pieces"]))
                        out[index] = slots[slot][1]
                        written[index] += 1
                        pending.append(n)
                    if n > 0 and n - 1 + stages < len(boxes):
                        if stored_last:  # wait_group.read 1 or 0
                            pending = pending[-1:] if stored else []
                        read += issue(n - 1 + stages)
                    stored_last = stored
                assert seen.all()
    assert (written == 1).all()
    result = torch.from_numpy(out.reshape(words.shape)).view(volume.dtype)
    return result.reshape(volume.shape), read, plan


def _k10_volume(height, width, depth, tile_d, dtype, dsplit, seed=16):
    rng = np.random.default_rng(seed)
    flat = torch.from_numpy(
        rng.integers(-100, 100, (height, width, depth)).astype(np.float32))
    flat = flat.to(dtype)
    if not dsplit:
        return flat
    return flat.reshape(height, width, depth // tile_d, tile_d).permute(
        2, 0, 1, 3).contiguous()


# the card tests' tilings, the wrapper's CPU dispatch tiling (2, 30, 128),
# chip_smoke.py's STREAM_TILES (K2's 256 x 32 x 16 among them), windows
# clamped at both edges of a two-tile volume ((32, 32, 8) at 64 x 64) and
# at offsets that are no multiple of 16 ((8, 8, 16) at 48 x 48)
@pytest.mark.parametrize("tiles,shape,dtype", [
    ((32, 32, 8), (64, 64, 16), torch.bfloat16),
    ((32, 32, 128), (96, 96, 128), torch.float32),
    ((64, 128, 128), (128, 256, 128), torch.bfloat16),
    ((1, 32, 16), (34, 64, 16), torch.int8),
    ((2, 30, 128), (36, 90, 128), torch.bfloat16),
    ((256, 32, 16), (768, 64, 32), torch.bfloat16),
    ((8, 8, 16), (48, 48, 16), torch.bfloat16),
])
@pytest.mark.parametrize("dsplit", [False, True])
def test_k10_box_model_equals_clone(tiles, shape, dtype, dsplit):
    tile_h, tile_w, tile_d = tiles
    volume = _k10_volume(*shape, tile_d, dtype, dsplit)
    got, read, plan = k10_model(volume, *tiles, dsplit)
    torch.testing.assert_close(got, volume.clone(), rtol=0, atol=0)
    # the window's bytes, and more only where a halo box overlaps the
    # centre (an offset that is no multiple of the halo box)
    span = (tile_h + 32) * (tile_w + 32)
    blocks = volume.numel() // (tile_h * tile_w * tile_d)
    window = blocks * span * tile_d * volume.element_size()
    if tiles == (8, 8, 16):
        assert read > window
    else:
        assert read == window
    if tiles == (256, 32, 16):  # K2's tiling: 16-row bands, no box shrunk
        assert (plan["rows"], plan["centre_cols"], plan["halo_cols"]) == (
            16, 32, 16)
        assert plan["row_runs"] == dsplit  # 1 KB runs, or 32 bytes


@pytest.mark.parametrize("tiles,chunk_bytes", [
    ((256, 32, 16), 32), ((64, 128, 128), 256), ((32, 32, 512), 2048),
    ((1, 1, 8192), 32768), ((3, 300, 16), 64)])
@pytest.mark.parametrize("one_chunk_pixels", [False, True])
def test_k10_plan_keeps_tma_limits(tiles, chunk_bytes, one_chunk_pixels):
    """Chunks past 1 KB split into pieces, tiles past 256 columns into
    centre boxes, and every box fits a slot."""
    tile_h, tile_w, _ = tiles
    plan = k10_plan(tile_h + 32, tile_w + 32, tile_h, tile_w, chunk_bytes,
                    one_chunk_pixels)
    inner = plan["piece_words"] * (
        max(plan["centre_cols"], plan["halo_cols"]) if plan["row_runs"]
        else 1)
    assert inner <= K10["kMaxBox"]
    assert plan["piece_words"] <= K10["kMaxBox"]
    assert plan["piece_words"] * plan["chunk_pieces"] * 4 == chunk_bytes
    assert plan["chunk_pieces"] % plan["pieces"] == 0
    assert tile_w % plan["centre_cols"] == 0
    assert (tile_h % plan["rows"], 16 % plan["rows"]) == (0, 0)
    assert max(plan["centre_bytes"], plan["halo_bytes"]) <= K10["kSlotBytes"]
    assert max(plan["rows"], plan["centre_cols"], plan["halo_cols"],
               plan["pieces"]) <= K10["kMaxBox"]
