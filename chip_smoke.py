#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mccnn_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the checkout root on a machine with one NVIDIA H100. It

  1. prints the card (nvidia-smi name and power limit) and the versions;
  2. builds the eleven CUDA kernels from ``mccnn_tpu_torch/csrc`` (timed; one
     nvcc per source, started together);
  3. holds each kernel against its plain PyTorch version on the card at a
     middle shape (256 x 384, ndisp 64 and 200; K1-K3 and K5 in f32 and
     bf16, K7 in f32, K4 in its float and raw int8 modes; K5 also against
     two K1 launches; K8 and K9 in f32, bf16 and the bf16-operand mode, also
     against K2; K2 with the bf16-operand flag and at ragged shapes (37 x
     70 x 128, 301 x 45 x 384; radius 0, 1, 13, 16; f32, bf16, bf16
     operands), K8, K9 and K4 there too, K7 also against K2, and K3 there in
     every direction, in place and out of place, on planes and on codes;
     K3 on penalty codes; K6 also against K5; K5 and K6 at shapes ragged
     for their tile (``RAGGED_BANDS``): K1's f32 route on either side
     against its plain version, K5 in f32 against two K1 launches, in bf16
     against the f32 launch rounded, -K6 against K5 and K6's bf16
     output against its f32 output rounded, all at 0.0, each against its
     plain version; K10's output against its input in both layouts; K11,
     the border fills, on both sides' K1 bands against the torch-op loop
     bit for bit);
  4. drives the serving path -- ``MatchPipeline.dispatch``/``fetch`` at
     1000 x 1504, ndisp 200, bf16 volumes, paper-default MatchConfig, the
     fast MC-CNN at full width with seeded random weights -- on one
     synthetic scene, checks the output and the kernel launch counts
     (per pair: K1 2, K11 2, K2 36, K3 8), and prints seconds per pair;
  5. drives the batch matcher: one synthetic scene of that size written to
     a temporary Middlebury layout, then ``mccnn_tpu_torch.cli.match.main``
     three times in this process -- the exact-f32 schedule
     (``--cbca_impl pallas``: K1 2, K7 36, K3 8 launches), the int8
     d-chunked schedule (``--cbca_impl fused8 --volume_dtype bfloat16
     --cbca_chunk_d 128``: K1 2, K4 72, K3 8) and ``--stage_times
     --cbca_impl pallas`` (K5 1, K7 36, K3 8) -- checking launch counts,
     artifacts, ranges, run 1 == run 3 == the K2 pipeline in f32, and run
     2's bad-2.0 within 0.5 pt of run 1's; then the variants on the same
     scene: ``--cbca_impl rolling --volume_dtype bfloat16`` (K1 2, K8 36,
     K3 8), ``--cbca_impl fused2 --volume_dtype bfloat16`` (K1 2, K9 18,
     K3 8), ``--cbca_impl fused2_16`` in f32 (K9 18, K3 8), and
     ``MatchPipeline`` with ``cbca_impl="rolling16"`` and
     ``MatchConfig(sgm_u8=True)`` (K8 36, K3 8 on penalty codes), which must
     equal the same run without ``sgm_u8`` bit for bit; each within 0.5 pt
     bad-2.0 of the exact-f32 run, the two bf16 runs equal to the K2 bf16
     pipeline bit for bit; then ``band_pair_pallas(use_mxu=False)`` (K6) on
     the scene's descriptors and the stream probe's ``main()`` (K10);
  6. compares a whole pair on the kernels with the same pair on CPU copies
     (where every wrapper runs its plain version), in f32 and bf16 and with
     ``cbca_impl`` fused16, rolling16 and mxu and with joint regions;
  7. holds each kernel against its plain version at the main-path shapes
     (1000 x 1504 x 256), times both with CUDA events (K11 a side beside
     the torch-op loop's events, host enqueue and kernel time, and at the
     full config's 2048 x 3072 x 512; K2 per round in
     bf16, f32, with bf16 operands and with every arm at the radius, beside
     K8 in bf16, f32, with bf16 operands (path V4's launch) and at full
     arms, K9 per pass in bf16, f32, with bf16 operands (path V3) and at
     full arms, K4 per 128-lane launch and at full arms, K7 with and
     without its 512-thread lever and K10's floor at the tiling of K2 and
     K7, at 32 x 32 x 8 and at the probe's default tiling; K1 per side in
     bf16 and f32, the f32 route on either side, each also against its
     plain version; K5 in f32 and bf16 and K6 with f32
     and bf16 output; K3 in place as the chained path
     launches it, out of place, and in f32), computes each
     kernel's bound from this run's inputs, and profiles one pair;
  8. drives the training path at full width (the fast net, 11 x 11 patches,
     ``TrainConfig()``: batch 128, margin 0.2, lr 0.002, beta 0.9): two
     synthetic 1000 x 1504 scenes written in the Middlebury layout under
     ``build/train_smoke``; ``mccnn_tpu_torch.cli.train.main`` on the card
     for 3 epochs with the native sampler and the prefetcher (checkpoints
     and metrics events checked); 3 steps on the card against 3 on the CPU
     from one set of weights and three sampler batches (losses, params and
     momentum traces within ``TRAIN_LOSS_TOL`` / ``TRAIN_REL_TOL``); steps/s
     on a fixed batch with no sync between steps (the loss must fall over
     200 steps) and fed by the sampler through the prefetcher, with a
     profile of 20 steps (``build/profile_train.txt``); then the last
     checkpoint through ``MatchPipeline`` on one scene (K1 2, K2 36, K3 8
     launches) and its features against an ``F.relu`` forward, bit for bit;
  9. drives the quality loop: ``mccnn_tpu_torch.tools.train_fullscale`` on
     the card for ``QUALITY_EPOCHS`` epochs of its 15 noisy 256 x 384
     scenes (3,000 steps), then its two evaluations at 1000 x 1504, ndisp
     162, on the five scene families (the trained weights and random init,
     fast schedule: K1 2, K2 36, K3 8 a pair); ``tools.eval_fullscale`` on
     the first family with the exact cross-check (the exact pair: K1 0, K2
     36, K3 8); ``tools.parity_eval`` on the card against the oracle chain.
     It fails on a non-finite pixel, a family whose trained bad-2.0 is worse
     than random init's by more than 0.005, fast and exact more than 0.005
     apart, or a scene more than 0.005 from the oracle chain;
 10. drives ``parallel/`` on two ranks that share the card over gloo (NCCL
     takes one rank per card): ``make_sharded_match``
     (``tools/multichip_midscale.py``, one spawn) at 1000 x 1504, ndisp
     200, on the serving (bf16, fused: K1 2, K2 36, K3 8 a rank), exact
     (f32, pallas: K7 36) and fused8 (K4 36) schedules and at 256 x 384 on
     fused2 (3 + 5 rounds: K9 6, K2 4), rolling (K8 36) and the joint-region
     CBCA (f32, "xla", 1 + 2 rounds: torch ops per halo-extended block, K1
     2 and K3 8 only), each rank's
     pre-WTA volume rows against the unsharded ``match_pair`` on the card
     (f32 atol 1e-4 / rtol 1e-6, bf16 one ulp at the cost scale, fused8 bit
     for bit), the WTA maps' differing pixels, the bad-2.0 delta (<= 0.005),
     exact launch counts a rank, the halo, reshard and gather bytes and
     seconds, each rank's peak memory beside the unsharded pair's, s/pair;
     the DP step on two ranks (batch 128) against one process (replicas
     bit-identical); ``cli.train --data_parallel`` on NCCL with one rank
     against the plain CLI (phase 8's rule); ``cli.match --multihost`` in
     two processes over three scenes, each written once by its owner;
 11. drives the bench entry points in this process: ``mccnn_tpu_torch.bench``
     (half, halfexact, quarter, full: the launches of one pair exact --
     K1 2, K2 36, K3 8; full K2 72 on 256-lane chunks of D_pad 512 -- the
     parity check's limits, finite disparities; train), then K1, K2 and
     K3 against their plain versions at the full config's depth (ndisp 400,
     D_pad 512) on a 256-row strip of its 2000 x 3072 pair -- K1 on both
     sides in bf16 and in f32 (also against K5 f32), K2 through
     ``_run_cbca`` on 256-lane chunks (and equal to one launch over the
     whole depth), K3 in place in every direction --
     with phase 7's tolerances, and a profile of one full pair
     (``build/profile_full.txt``); ``tools.bench_serve`` on sixteen 1000 x
     1504 scenes for the pipelined and the sync client,
     ``tools.profile_pipeline`` at the main shape, ``tools.profile_fullres``
     at 2000 x 3072, ndisp 400, and ``tools.warmup`` in a process of its own;
     each prints one JSON record naming this card;
 12. runs the two CBCA layout tools' ``main()`` in this process on their
     seeded 1000 x 1504 x 256 f32 volume: ``tools.bench_cbca_banded``
     (``cbca_impl="mxu"``'s dense round, masks built in the call, against
     the banded-block round: times, peak memory, every element within
     ``round_tolerance``) and ``tools.bench_cbca_layout`` (the torch-op
     round in (H, W, D) and in (H, D, W), x1 and x16: times, peak memory,
     the layouts' two-round difference within ``LAYOUT_RTOL`` of the
     largest value); every output finite, every line naming this card;
     then one dense and one banded round profiled (device time by kernel).

Every failed phase raises, so the exit code is non-zero; without a CUDA
device, or outside a checkout, it exits non-zero before printing a result.
The last lines are the bench's records (one JSON line each), the
serving pair's seconds and peak device memory, the
training summary (both steps/s), the quality summary, the sharded summary,
the CBCA tools' line, the card, the per-kernel JSON summary and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
MAIN_SHAPE = (1000, 1504)
MAIN_NDISP = 200
MIDDLE_SHAPE = (256, 384)
SCENES = ("occlusion",)
BATCH_SCENE = "slanted"
KERNELS = {
    "band_side": ("mccnn_tpu_torch/csrc/band.cu",
                  "mccnn_tpu/ops/cost_volume_pallas.py:315"),
    "cbca_round": ("mccnn_tpu_torch/csrc/cbca_round.cu",
                   "mccnn_tpu/ops/cbca_fused.py:130"),
    "sgm_sweep": ("mccnn_tpu_torch/csrc/sgm_sweep.cu",
                  "mccnn_tpu/ops/sgm_pallas.py:108"),
    "cbca_round_int8": ("mccnn_tpu_torch/csrc/cbca_round_int8.cu",
                        "mccnn_tpu/ops/cbca_fused.py:130"),
    "band_pair": ("mccnn_tpu_torch/csrc/band_pair.cu",
                  "mccnn_tpu/ops/cost_volume_pallas.py:187"),
    "cbca_stencil_round": ("mccnn_tpu_torch/csrc/cbca_stencil.cu",
                           "mccnn_tpu/ops/cbca_pallas.py:40"),
    "band_scores": ("mccnn_tpu_torch/csrc/band_vpu.cu",
                    "mccnn_tpu/ops/cost_volume_pallas.py:53"),
    "cbca_rolling_round": ("mccnn_tpu_torch/csrc/cbca_rolling.cu",
                           "mccnn_tpu/ops/cbca_rolling.py:68"),
    "cbca_two_rounds": ("mccnn_tpu_torch/csrc/cbca_two_round.cu",
                        "mccnn_tpu/ops/cbca_fused2.py:85"),
    "cbca_stream": ("mccnn_tpu_torch/csrc/cbca_stream.cu",
                    "tools/bench_cbca_stream.py:44"),
    # no pallas_call: JAX runs the fills as a lax.scan
    "border_fill": ("mccnn_tpu_torch/csrc/border_fill.cu",
                    "none (mccnn_tpu/ops/cost_volume.py:217, :272, XLA)"),
}
PROBE_ITERS = 4  # the stream probe's ITERS: a check, a warm-up, the rounds
# launches per pair on each driven path; kernels not named are launched 0
# times there
PER_PAIR = {
    "serve": {"band_side": 2, "border_fill": 2, "cbca_round": 36,
              "sgm_sweep": 8},
    "match exact-f32": {"band_side": 2, "border_fill": 2,
                        "cbca_stencil_round": 36, "sgm_sweep": 8},
    "match int8 d-chunked": {"band_side": 2, "border_fill": 2,
                             "cbca_round_int8": 72, "sgm_sweep": 8},
    "match stage_times": {"band_pair": 1, "border_fill": 2,
                          "cbca_stencil_round": 36, "sgm_sweep": 8},
    "match rolling bf16": {"band_side": 2, "border_fill": 2,
                           "cbca_rolling_round": 36, "sgm_sweep": 8},
    "match fused2 bf16": {"band_side": 2, "border_fill": 2,
                          "cbca_two_rounds": 18, "sgm_sweep": 8},
    "match fused2_16 f32": {"band_side": 2, "border_fill": 2,
                            "cbca_two_rounds": 18, "sgm_sweep": 8},
    "pipeline rolling16 sgm_u8": {"band_side": 2, "border_fill": 2,
                                  "cbca_rolling_round": 36, "sgm_sweep": 8},
    "raw bands": {"band_scores": 1},
    "stream probe": {"cbca_stream": PROBE_ITERS + 2},
    # the training phase's last checkpoint through the serving path
    "trained serve": {"band_side": 2, "border_fill": 2, "cbca_round": 36,
                      "sgm_sweep": 8},
    # phase 9: train_fullscale's two evaluations (fast pairs only), one
    # eval_fullscale run on one family (a fast pair, then the exact pair:
    # f32 volumes by matrix products and the fills, K2 in f32, K3) and
    # parity_eval (per scene: the exact row, K1 2, K2 6 (2 x (1 + 2)
    # rounds), K3 8, and the mxu row, K1 2, K3 8; the fills after each K1)
    "quality train_fullscale": {"band_side": 2, "border_fill": 2,
                                "cbca_round": 36, "sgm_sweep": 8},
    "quality eval_fullscale": {"band_side": 2, "border_fill": 2 + 2,
                               "cbca_round": 36 + 36, "sgm_sweep": 8 + 8},
    "quality parity_eval": {"band_side": 4, "border_fill": 4,
                            "cbca_round": 6, "sgm_sweep": 16},
    # phase 10: make_sharded_match on two ranks, launches of each rank
    # (every pass one kernel call on the rank's halo-extended block)
    "sharded fused (per rank)": {"band_side": 2, "border_fill": 2,
                                 "cbca_round": 36, "sgm_sweep": 8},
    "sharded exact-f32 (per rank)": {"band_side": 2, "border_fill": 2,
                                     "cbca_stencil_round": 36,
                                     "sgm_sweep": 8},
    "sharded fused8 (per rank)": {"band_side": 2, "border_fill": 2,
                                  "cbca_round_int8": 36, "sgm_sweep": 8},
    # SHARDED_ODD_ROUNDS: (1 + 2) K9 passes and 1 + 1 odd rounds on K2 a
    # volume
    "sharded fused2 (per rank)": {"band_side": 2, "border_fill": 2,
                                  "cbca_two_rounds": 6, "cbca_round": 4,
                                  "sgm_sweep": 8},
    "sharded rolling (per rank)": {"band_side": 2, "border_fill": 2,
                                   "cbca_rolling_round": 36, "sgm_sweep": 8},
    # the joint-region CBCA is torch ops on each rank's halo-extended block
    "sharded joint (per rank)": {"band_side": 2, "border_fill": 2,
                                 "sgm_sweep": 8},
    # phase 11: one pair of each bench config (mccnn_tpu_torch/bench.py);
    # full aggregates D_pad 512 in two 256-lane chunks
    "bench half": {"band_side": 2, "border_fill": 2, "cbca_round": 36,
                   "sgm_sweep": 8},
    "bench halfexact": {"band_side": 2, "border_fill": 2, "cbca_round": 36,
                        "sgm_sweep": 8},
    "bench quarter": {"band_side": 2, "border_fill": 2, "cbca_round": 36,
                      "sgm_sweep": 8},
    "bench full": {"band_side": 2, "border_fill": 2, "cbca_round": 72,
                   "sgm_sweep": 8},
}
# the path whose launch count stands in the summary line for each kernel
OWN_PATH = {
    "band_side": "serve", "cbca_round": "serve", "sgm_sweep": "serve",
    "cbca_stencil_round": "match exact-f32",
    "cbca_round_int8": "match int8 d-chunked",
    "band_pair": "match stage_times",
    "band_scores": "raw bands",
    "cbca_rolling_round": "match rolling bf16",
    "cbca_two_rounds": "match fused2 bf16",
    "cbca_stream": "stream probe",
    "border_fill": "serve",
}
# K10 is timed at the tiling of K2 and K7 (a 256-row band of a 32-column
# strip, one 32-byte sector per pixel: 16 bf16 lanes) and at the 32 x 32 x
# 8-lane blocks of K7's first port
STREAM_TILES = {"K2 and K7": (256, 32, 16), "32 x 32 x 8": (32, 32, 8)}
STREAM_HALO = 32  # rows (columns) a tile's window adds: radius 16 each side
STREAM_DEFAULT_TILES = (64, 128, 128)  # the probe's own defaults
# K2, K7 and K3 where no tile, step, band, ring or block divides the image:
# (H, W, D_pad); the rounds at each radius below
RAGGED_SHAPES = ((37, 70, 128), (301, 45, 384))
RAGGED_RADII = (0, 1, 13, 16)
# K5 and K6 where their tile (64-column blocks, 8 x 8 register tiles at a
# stride of 4) does not divide the band: (H, W, K5's ndisp, K6's depth);
# every width is no multiple of the column tile and below d_pad, no ndisp
# a multiple of a register tile, no depth of a register tile or a chunk
RAGGED_BANDS = ((37, 70, 13, 300), (301, 45, 130, 77), (2, 1, 1, 3))
# the training phase: two scenes at the main shape, the CLI's epochs, the
# steps of each throughput run
TRAIN_SCENES = ("slanted", "occlusion")
TRAIN_EPOCHS = 3
TRAIN_STEPS = 200
# card against CPU after 3 steps: cuDNN sums the convolutions and their
# gradients in another order than the CPU (TF32 off), a few thousand f32
# terms a sum, relative errors of order 1e-6; each param and momentum leaf
# is held to 1e-4 of its largest entry, each loss (about 0.2) to 1e-5
TRAIN_REL_TOL = 1e-4
TRAIN_LOSS_TOL = 1e-5
# the quality phase: train_fullscale's recipe cut to 200 epochs (3,000
# steps), evaluated at the main shape with ndisp 162 on the training noise
QUALITY_EPOCHS = 200
QUALITY_NOISE = 0.25
QUALITY_BUDGET = 0.005  # bad-2.0: fast vs exact, trained vs random init
# the sharded phase: two ranks share the one card over gloo (NCCL takes one
# rank per card); fused2 runs 3 + 5 rounds, so each volume ends both CBCA
# stages on an odd round (K2)
SHARDED_RANKS = 2
SHARDED_ODD_ROUNDS = (3, 5)
MULTIHOST_SCENES = 3
# the bench phase: its configs in-process, the serve bench's scenes a client
# (15 gaps between completions for the steady rate), the rows of the full
# config's pair on which K1, K2 and K3 are held to their plain versions at
# D_pad 512
BENCH_CONFIGS = ("half", "halfexact", "quarter", "full", "train")
BENCH_SERVE_SCENES = 16
FULL_STRIP = (872, 1128)
# the CBCA layout tools: (H, D, W) against (H, W, D) after two rounds, as
# tests/test_torch_cbca_tools.py holds cbca_hdw to JAX's cbca
LAYOUT_RTOL = 1e-6
# the card's published peaks (H100 SXM data sheet, dense): device memory
# rate; f32 outside the tensor cores, bf16 and int8 on them
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}


def log(*parts) -> None:
    print(*parts, flush=True)


def bf16_ulp(magnitude: float) -> float:
    """Spacing of bf16 numbers at ``magnitude`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(max(magnitude, 1e-30))) - 7)


def unit_features(rng, height, width, device):
    import torch

    f = rng.standard_normal((height, width, 64)).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    return torch.from_numpy(f).to(device)


def scene_images(height, width, family, rng, device, max_disparity):
    import torch
    from mccnn_tpu_torch.pipeline.match import standardize_image
    from mccnn_tpu_torch.utils.scenes import make_scene

    s = make_scene(family, rng, height, width, max_disparity)
    left = torch.from_numpy(standardize_image(s["left"])).to(device)
    right = torch.from_numpy(standardize_image(s["right"])).to(device)
    return s, left, right


class Errors:
    """Largest |kernel - plain| per kernel over the checks."""

    def __init__(self):
        self.worst = {name: 0.0 for name in KERNELS}

    def record(self, name, what, err, tol):
        log(f"  {name:18s} {what:34s} max_abs_err {err:.3e}  tol {tol:.3e}")
        self.worst[name] = max(self.worst[name], err)
        if not err <= tol:
            raise AssertionError(f"{name} {what}: {err} > {tol}")


def check_kernels(device, errors: Errors) -> None:
    """Phase 3: each kernel against its plain version on the card."""
    import torch
    from mccnn_tpu_torch.ops.cbca import cbca, compute_arms
    from mccnn_tpu_torch.ops.cbca_fused import (
        _quantize_int8,
        cbca_fused,
        cbca_int8_plain,
    )
    from mccnn_tpu_torch.ops.cbca_fused2 import cbca_fused_two
    from mccnn_tpu_torch.ops.cbca_pallas import cbca_pallas
    from mccnn_tpu_torch.ops.cbca_rolling import cbca_fused_rolling
    from mccnn_tpu_torch.ops.common import pad_disparities
    from mccnn_tpu_torch.ops.cost_volume import (
        band_pair,
        band_pair_pallas,
        band_pair_plain,
        band_pair_scores_plain,
        band_side,
        band_side_plain,
        border_fill,
        border_fill_plain,
    )
    from mccnn_tpu_torch.ops.sgm import (
        _DIRECTIONS,
        penalty_scale_u8,
        sweep_cuda,
        sweep_plain,
    )
    from mccnn_tpu_torch.tools.bench_cbca_stream import (
        cbca_stream,
        cbca_stream_plain,
    )
    from mccnn_tpu_torch.utils.config import MatchConfig

    config = MatchConfig()
    height, width = MIDDLE_SHAPE
    rng = np.random.default_rng(SEED)
    fl = unit_features(rng, height, width, device)
    fr = unit_features(rng, height, width, device)
    _, left_img, right_img = scene_images(height, width, "occlusion", rng,
                                          device, 60)
    arms = compute_arms(left_img, config.cbca_intensity, config.cbca_distance)
    for ndisp in (64, 200):
        d_pad = pad_disparities(ndisp)
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"ndisp {ndisp} {str(dtype)[6:]}"
            bf16 = dtype == torch.bfloat16
            a, o = fl.to(dtype), fr.to(dtype)
            for side in ("left", "right"):
                got = band_side(a, o, ndisp, d_pad, side, dtype)
                want = band_side_plain(a, o, ndisp, d_pad, side, dtype)
                err = (got[..., :ndisp].float()
                       - want[..., :ndisp].float()).abs().max().item()
                # |cost| <= 1: f32 sums differ in order only; bf16 may
                # round one ulp apart at |v| <= 1 (2^-8)
                errors.record("band_side", f"{tag} {side}", err,
                              2.0 ** -8 if bf16 else 1e-5)
                if not torch.equal(got[..., ndisp:], want[..., ndisp:]):
                    raise AssertionError("band_side pad lanes differ")
            # K5: one launch, both sides. In f32 K1 runs K5's fmaf chain in
            # channel order, so K5 equals two K1 launches bit for bit; in
            # bf16 K1 sums its exact products on the tensor cores in another
            # order, so the two may round one bf16 ulp (2^-8) apart
            pair = band_pair(a, o, ndisp, d_pad, dtype)
            plain = band_pair_plain(a, o, ndisp, d_pad, dtype)
            ones = (band_side(a, o, ndisp, d_pad, "left", dtype),
                    band_side(o, a, ndisp, d_pad, "right", dtype))
            for side, got, want, one in zip(("left", "right"), pair, plain,
                                            ones):
                err = (got.float() - want.float()).abs().max().item()
                errors.record("band_pair", f"{tag} {side}", err, 0.0)
                off = (got[..., :ndisp].float()
                       - one[..., :ndisp].float()).abs().max().item()
                if not (off <= (2.0 ** -8 if bf16 else 0.0) and torch.equal(
                        got[..., ndisp:], one[..., ndisp:])):
                    raise AssertionError(
                        f"band_pair {tag} {side}: {off} from band_side")
            # K11 on both bands, in place: the torch-op loop's values bit
            # for bit, pad lanes untouched
            for side, band in zip(("left", "right"), ones):
                got = border_fill(band.clone(), ndisp, side)
                want = border_fill_plain(band.clone(), ndisp, side)
                err = (got.float() - want.float()).abs().max().item()
                errors.record("border_fill", f"{tag} {side}", err, 0.0)
                if not torch.equal(got, want):
                    raise AssertionError(f"border_fill {tag} {side}: "
                                         "differs from the torch-op loop")
            volume = ones[0]
            got = cbca_fused(volume, arms, 1, config.cbca_distance)
            want = cbca(volume, arms, 1, config.cbca_distance)
            err = (got[..., :ndisp].float()
                   - want[..., :ndisp].float()).abs().max().item()
            # same f32 summation order as the plain round, so bit-equal is
            # expected; the limit is an f32 ulp at |v| <= 1 or a bf16 ulp
            errors.record("cbca_round", tag, err,
                          2.0 ** -8 if bf16 else 1e-6)
            if got[..., ndisp:].float().min().item() < 1e8:
                raise AssertionError("cbca_round pad lanes fell below 1e8")
            # K4: exact integer math between one quantization and one
            # dequantization, so equal to the plain version (tolerance 0.0)
            got8 = cbca_fused(volume, arms, 2, config.cbca_distance,
                              int8_storage=True)
            want8 = cbca_int8_plain(volume, arms, 2, config.cbca_distance)
            err = (got8.float() - want8.float()).abs().max().item()
            errors.record("cbca_round_int8", tag, err, 0.0)
            if got8[..., ndisp:].float().min().item() < 1e8:
                raise AssertionError("cbca_round_int8 pad lanes fell below 1e8")
            if not bf16:
                # K7: the plain round's f32 order (tolerance 0.0); then K2
                got7 = cbca_pallas(volume, arms, 2, config.cbca_distance)
                want7 = cbca(volume, arms, 2, config.cbca_distance)
                err = (got7 - want7).abs().max().item()
                errors.record("cbca_stencil_round", tag, err, 0.0)
                if not torch.equal(
                        got7, cbca_fused(volume, arms, 2,
                                         config.cbca_distance)):
                    raise AssertionError("cbca_stencil_round differs from "
                                         "cbca_round")
                # K4's raw mode: int8 in, int8 out, BIG lanes stay 127
                raw = _quantize_int8(volume)[0]
                got_raw = cbca_fused(raw, arms, 3, config.cbca_distance,
                                     int8_storage=True)
                want_raw = cbca_int8_plain(raw, arms, 3,
                                           config.cbca_distance)
                err = (got_raw.int() - want_raw.int()).abs().max().item()
                errors.record("cbca_round_int8", f"{tag} raw int8", err, 0.0)
                if got_raw.dtype != torch.int8 or not bool(
                        (got_raw[..., ndisp:] == 127).all()):
                    raise AssertionError("cbca_round_int8 raw: BIG lanes "
                                         "left 127")
                # K6: both raw score bands from the f32 descriptors; the
                # plain version's correlation and K5's fmaf chain, so equal
                # to both (tolerance 0.0): -K6 == K5 with ndisp = d_pad
                scores = band_pair_pallas(a, o, d_pad, use_mxu=False)
                costs = band_pair(a, o, d_pad, d_pad, dtype)
                for side, score, want, cost in zip(
                        ("left", "right"), scores,
                        band_pair_scores_plain(a, o, d_pad), costs):
                    err = (score - want).abs().max().item()
                    errors.record("band_scores", f"{tag} {side}", err, 0.0)
                    if not torch.equal(-score, cost):
                        raise AssertionError(
                            f"band_scores {tag} {side}: -scores differ from "
                            "band_pair")
            # K8 and K9 (three rounds: a K9 pass and an odd K2 round) in this
            # storage type and, on f32 storage, with bf16 operands, which is
            # also K2's new flag: the plain round's f32 order (tolerance
            # 0.0), and equal to K2
            for compute in (None,) if bf16 else (None, torch.bfloat16):
                what = tag + (" bf16 operands" if compute else "")
                want3 = cbca(volume, arms, 3, config.cbca_distance, compute)
                fused3 = cbca_fused(volume, arms, 3, config.cbca_distance,
                                    compute_dtype=compute)
                if compute:
                    err = (fused3 - want3).abs().max().item()
                    errors.record("cbca_round", what, err, 0.0)
                for name, variant in (
                        ("cbca_rolling_round", cbca_fused_rolling),
                        ("cbca_two_rounds", cbca_fused_two)):
                    got3 = variant(volume, arms, 3, config.cbca_distance,
                                   compute_dtype=compute)
                    err = (got3.float() - want3.float()).abs().max().item()
                    errors.record(name, what, err, 0.0)
                    if not torch.equal(got3, fused3):
                        raise AssertionError(f"{name} {what}: differs from "
                                             "cbca_round")
            for direction in _DIRECTIONS:
                out_k = torch.empty_like(got)
                out_p = torch.empty_like(got)
                sweep_cuda(got, out_k, left_img, right_img, "L", direction,
                           config)
                sweep_plain(got, out_p, left_img, right_img, "L", direction,
                            config)
                real_k = out_k[..., :ndisp].float()
                real_p = out_p[..., :ndisp].float()
                err = (real_k - real_p).abs().max().item()
                # the same f32 operations in the same order, so bit-equal
                # is expected; the limit is two ulps at the largest cost
                top = real_p.abs().max().item()
                errors.record("sgm_sweep", f"{tag} dir {direction}", err,
                              2 * bf16_ulp(top) if bf16 else 2.4e-7 * top)
                if out_k[..., ndisp:].float().min().item() < 1e8:
                    raise AssertionError("sgm_sweep pad lanes fell below 1e8")
                # K3 on a code volume: the same predicate, so the same
                # sweep as on the gradient planes (tolerance 0.0)
                codes = penalty_scale_u8(left_img, right_img, "L", direction,
                                         d_pad, config.sgm_d)
                out_c = torch.empty_like(got)
                sweep_cuda(got, out_c, left_img, right_img, "L", direction,
                           config, codes)
                err = (out_c.float() - out_k.float()).abs().max().item()
                errors.record("sgm_sweep", f"{tag} dir {direction} on codes",
                              err, 0.0)
    check_ragged_rounds(device, errors)
    check_ragged_bands(device, errors)
    # K10: a copy; the output equals the input in both layouts (two bands
    # of K2's tile shape in height)
    height = 2 * height
    stream_in = (torch.randn((height, width, 256), device=device)
                 * 50).to(torch.bfloat16)
    for label, (tile_h, tile_w, tile_d) in STREAM_TILES.items():
        split = stream_in.reshape(height, width, 256 // tile_d, tile_d)
        split = split.permute(2, 0, 1, 3).contiguous()
        for layout, vol in (("flat", stream_in), ("dsplit", split)):
            out = cbca_stream(vol, tile_h, tile_w, tile_d, layout == "dsplit")
            err = (out.float() - cbca_stream_plain(vol).float()).abs().max()
            errors.record("cbca_stream", f"tiles of {label} {layout}",
                          err.item(), 0.0)
    torch.cuda.synchronize()


def check_ragged_rounds(device, errors: Errors) -> None:
    """Phase 3 at shapes that nothing divides. K2: three rounds against the
    plain rounds where neither the 32-column strip, the 16-row step nor the
    256-row band divides the image, at radius 0, 1, 13 and 16, on one and
    three 128-lane chunks, in f32, bf16 and with bf16 operands on f32
    storage; K8 three rounds the same, also against K2; K9 one two-round
    pass the same, also against two K2 rounds;
    K7 (32-row steps) in f32, also against K2; K4 two rounds on the f32
    volume and on its int8 quantization (raw mode), BIG lanes 127. The sums
    run in the plain round's order, so the tolerance is 0.0. K3: every
    direction of both volumes, in place and out of place, on the planes and
    on codes, in f32 and bf16, where no ring or block of fibres divides the
    image (tolerance 0.0)."""
    import torch
    from mccnn_tpu_torch.ops.cbca import cbca, compute_arms
    from mccnn_tpu_torch.ops.cbca_fused import (
        _quantize_int8,
        cbca_fused,
        cbca_int8_plain,
    )
    from mccnn_tpu_torch.ops.cbca_fused2 import cbca_fused_two
    from mccnn_tpu_torch.ops.cbca_pallas import cbca_pallas
    from mccnn_tpu_torch.ops.cbca_rolling import cbca_fused_rolling
    from mccnn_tpu_torch.ops.common import BIG_COST
    from mccnn_tpu_torch.ops.sgm import (
        _DIRECTIONS,
        penalty_scale_u8,
        sweep_cuda,
        sweep_plain,
    )
    from mccnn_tpu_torch.utils.config import MatchConfig

    config = MatchConfig()
    rng = np.random.default_rng(SEED + 4)
    modes = (("f32", torch.float32, None), ("bf16", torch.bfloat16, None),
             ("bf16 operands", torch.float32, torch.bfloat16))
    for height, width, d_pad in RAGGED_SHAPES:
        _, image, right = scene_images(height, width, "occlusion", rng,
                                       device, 20)
        values = rng.uniform(-1, 1, (height, width, d_pad)).astype(np.float32)
        values[..., d_pad - 28:] = BIG_COST
        volume = torch.from_numpy(values).to(device)
        for radius in RAGGED_RADII:
            arms = compute_arms(image, config.cbca_intensity, radius + 1)
            for mode, dtype, compute in modes:
                operand = volume.to(dtype)
                got = cbca_fused(operand, arms, 3, radius + 1,
                                 compute_dtype=compute)
                want = cbca(operand, arms, 3, radius + 1, compute)
                err = (got.float() - want.float()).abs().max().item()
                errors.record(
                    "cbca_round",
                    f"ragged {height}x{width}x{d_pad} r{radius} {mode}",
                    err, 0.0)
                if got[..., d_pad - 28:].float().min().item() < 1e8:
                    raise AssertionError("cbca_round ragged: pad lanes fell "
                                         "below 1e8")
                # K8: three rounds, against the plain rounds and K2 (every
                # ragged depth is whole 128-lane chunks, which K2 takes)
                got8 = cbca_fused_rolling(operand, arms, 3, radius + 1,
                                          compute_dtype=compute)
                err = (got8.float() - want.float()).abs().max().item()
                errors.record(
                    "cbca_rolling_round",
                    f"ragged {height}x{width}x{d_pad} r{radius} {mode}",
                    err, 0.0)
                if d_pad % 128 == 0 and not torch.equal(got8, got):
                    raise AssertionError("cbca_rolling_round ragged: differs "
                                         "from cbca_round")
                if got8[..., d_pad - 28:].float().min().item() < 1e8:
                    raise AssertionError("cbca_rolling_round ragged: pad "
                                         "lanes fell below 1e8")
                # K9: one pass, against the plain rounds and two K2 rounds
                got9 = cbca_fused_two(operand, arms, 2, radius + 1,
                                      compute_dtype=compute)
                want2 = cbca(operand, arms, 2, radius + 1, compute)
                err = (got9.float() - want2.float()).abs().max().item()
                errors.record(
                    "cbca_two_rounds",
                    f"ragged {height}x{width}x{d_pad} r{radius} {mode}",
                    err, 0.0)
                if not torch.equal(got9, cbca_fused(
                        operand, arms, 2, radius + 1, compute_dtype=compute)):
                    raise AssertionError("cbca_two_rounds ragged: differs "
                                         "from two cbca_round launches")
                if got9[..., d_pad - 28:].float().min().item() < 1e8:
                    raise AssertionError("cbca_two_rounds ragged: pad lanes "
                                         "fell below 1e8")
                if mode == "f32":
                    got7 = cbca_pallas(operand, arms, 3, radius + 1)
                    err = (got7 - want).abs().max().item()
                    errors.record(
                        "cbca_stencil_round",
                        f"ragged {height}x{width}x{d_pad} r{radius}", err,
                        0.0)
                    if not torch.equal(got7, got):
                        raise AssertionError("cbca_stencil_round ragged: "
                                             "differs from cbca_round")
                    # K4 in the float mode and on pre-quantized int8 (raw):
                    # exact integer math, BIG lanes stay 127
                    raw = _quantize_int8(operand)[0]
                    for kind, vol8 in (("float", operand), ("raw int8", raw)):
                        got8 = cbca_fused(vol8, arms, 2, radius + 1,
                                          int8_storage=True)
                        want8 = cbca_int8_plain(vol8, arms, 2, radius + 1)
                        err = (got8.float() - want8.float()).abs().max()
                        errors.record(
                            "cbca_round_int8",
                            f"ragged {height}x{width}x{d_pad} r{radius} "
                            f"{kind}", err.item(), 0.0)
                    if not bool((got8[..., d_pad - 28:] == 127).all()):
                        raise AssertionError("cbca_round_int8 ragged: BIG "
                                             "lanes left 127")
        for dtype in (torch.float32, torch.bfloat16):
            operand = volume.to(dtype)
            worst = 0.0
            for choice in ("L", "R"):
                for direction in _DIRECTIONS:
                    codes = penalty_scale_u8(image, right, choice, direction,
                                             d_pad, config.sgm_d)
                    for code in (None, codes):
                        for in_place in (True, False):
                            got, want = operand.clone(), operand.clone()
                            outs = (got, want) if in_place else (
                                torch.empty_like(got), torch.empty_like(got))
                            sweep_cuda(got, outs[0], image, right, choice,
                                       direction, config, code)
                            sweep_plain(want, outs[1], image, right, choice,
                                        direction, config, code)
                            err = (outs[0].float() - outs[1].float()).abs()
                            worst = max(worst, err.max().item())
            errors.record("sgm_sweep",
                          f"ragged {height}x{width}x{d_pad} {str(dtype)[6:]} "
                          "(L, R; 4 dirs; in/out of place; planes, codes)",
                          worst, 0.0)


def check_ragged_bands(device, errors: Errors) -> None:
    """Phase 3 at the shapes of ``RAGGED_BANDS``. K1's f32 route on either
    side against its plain version (``compare_side_f32``). K5 in f32
    against two K1 f32 launches, in bf16 against the f32 launch on the
    bf16 values, rounded; -K6 against K5 with ndisp = d_pad on the chunks
    that cover its depth, K6 with bf16 output against its f32 output,
    rounded: the same fmaf chain, tolerance 0.0. Each also against its
    plain version:
    f32 1e-5 (the plain correlation is cuBLAS's, whose order at these
    shapes is its own), bf16 one ulp at |value| <= 1 (2^-8)."""
    import torch
    from mccnn_tpu_torch.ops.cost_volume import (
        band_pair,
        band_pair_plain,
        band_pair_scores,
        band_pair_scores_plain,
        band_side,
        band_side_plain,
    )

    rng = np.random.default_rng(SEED + 5)
    for height, width, ndisp, depth in RAGGED_BANDS:
        shape = f"ragged {height}x{width} ndisp {ndisp}"
        fl = unit_features(rng, height, width, device)
        fr = unit_features(rng, height, width, device)
        d_pad = -(-ndisp // 128) * 128
        exact32 = band_pair(fl, fr, ndisp, d_pad, torch.float32)
        ones = (band_side(fl, fr, ndisp, d_pad, "left", torch.float32),
                band_side(fr, fl, ndisp, d_pad, "right", torch.float32))
        for side, one, (anchor, other) in zip(("left", "right"), ones,
                                              ((fl, fr), (fr, fl))):
            compare_side_f32(errors, ndisp, f"{shape} f32 {side}", one,
                             band_side_plain(anchor, other, ndisp, d_pad,
                                             side, torch.float32))
        widened = band_pair(fl.to(torch.bfloat16).float(),
                            fr.to(torch.bfloat16).float(), ndisp, d_pad,
                            torch.float32)
        for dtype, tol, exact in ((torch.float32, 1e-5, ones),
                                  (torch.bfloat16, 2.0 ** -8, widened)):
            a, o = fl.to(dtype), fr.to(dtype)
            pair = exact32 if dtype == torch.float32 else band_pair(
                a, o, ndisp, d_pad, dtype)
            plain = band_pair_plain(a, o, ndisp, d_pad, dtype)
            for side, got, want, one in zip(("left", "right"), pair, plain,
                                            exact):
                what = f"{shape} {str(dtype)[6:]} {side}"
                errors.record("band_pair", what,
                              (got.float() - want.float()).abs().max().item(),
                              tol)
                if not torch.equal(got, one.to(dtype)):
                    raise AssertionError(
                        f"band_pair {what}: differs from "
                        + ("two band_side launches" if dtype == torch.float32
                           else "the f32 launch on bf16 values, rounded"))
        # K6 at a depth of no register tile or chunk
        full = -(-depth // 128) * 128
        costs = band_pair(fl, fr, full, full, torch.float32)
        scores32 = band_pair_scores(fl, fr, depth)
        for out_dtype, tol in ((torch.float32, 1e-5),
                               (torch.bfloat16, 2.0 ** -8)):
            scores = scores32 if out_dtype == torch.float32 else \
                band_pair_scores(fl, fr, depth, out_dtype)
            plain = band_pair_scores_plain(fl, fr, depth, out_dtype)
            for side, got, want, cost, score32 in zip(
                    ("left", "right"), scores, plain, costs, scores32):
                what = (f"ragged {height}x{width} depth {depth} "
                        f"{str(out_dtype)[6:]} out {side}")
                errors.record("band_scores", what,
                              (got.float() - want.float()).abs().max().item(),
                              tol)
                if not (torch.equal(-score32, cost[..., :depth])
                        and torch.equal(got, score32.to(out_dtype))):
                    raise AssertionError(
                        f"band_scores {what}: -K6 differs from K5 or its "
                        "bf16 output from its f32 output, rounded")


def drive_main_path(device, launches):
    """Phase 4: the serving path at 1000 x 1504, ndisp 200, bf16."""
    import torch
    from mccnn_tpu_torch.models.net import init_params
    from mccnn_tpu_torch.pipeline.match import MatchPipeline, standardize_image
    from mccnn_tpu_torch.utils.evaluate import bad_n
    from mccnn_tpu_torch.utils.scenes import make_scene

    height, width = MAIN_SHAPE
    rng = np.random.default_rng(SEED)
    scenes = [make_scene(f, rng, height, width, 150) for f in SCENES]
    pipeline = MatchPipeline(init_params(SEED), volume_dtype="bfloat16",
                             bucket=8, device=device)

    def serve(scene):
        left = standardize_image(scene["left"])
        right = standardize_image(scene["right"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        disparity = pipeline.fetch(pipeline.dispatch(left, right, MAIN_NDISP))
        torch.cuda.synchronize()
        return disparity, time.perf_counter() - t0

    _, warm_seconds = serve(scenes[0])  # first use: cuDNN choice, pools
    log(f"  warm-up pair: {warm_seconds:.4f} s")
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    results = [serve(scene) for scene in scenes]
    counts = launches.snapshot()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    seconds = []
    for family, scene, (disparity, secs) in zip(SCENES, scenes, results):
        if disparity.shape != (height, width):
            raise AssertionError(f"{family}: shape {disparity.shape}")
        if not np.isfinite(disparity).all():
            raise AssertionError(f"{family}: non-finite disparity")
        lo, hi = float(disparity.min()), float(disparity.max())
        # the subpixel parabola fit (the reference's, as in JAX) is
        # unbounded where an LR-filled d is not a cost minimum, so a few
        # pixels may leave [0, ndisp) there and only there (check_ranges)
        outside = float(((disparity < 0) | (disparity >= MAIN_NDISP)).mean())
        if outside > 1e-3:
            raise AssertionError(
                f"{family}: {outside} of pixels outside [0, ndisp) "
                f"(range [{lo}, {hi}])")
        bad2 = float(bad_n(disparity, scene["gt"], 2.0))
        seconds.append(secs)
        log(f"  {family:12s} {secs:.4f} s/pair  range [{lo:.2f}, {hi:.2f}]"
            f" ({outside:.2e} outside [0, ndisp))  bad-2.0 {bad2:.4f} "
            "(random weights: information only)")
    log(f"  launch counts over {len(scenes)} pairs: {counts}")
    check_counts("serve", counts, len(scenes))
    log(f"  mean {np.mean(seconds):.4f} s/pair, peak device memory "
        f"{peak_gb:.2f} GB")
    serving = {"s_per_pair": float(np.mean(seconds)), "peak_gb": peak_gb}
    check_dispatch_is_async(pipeline, scenes[0])
    for family, scene in zip(SCENES, scenes):
        left, right = (pipeline._to_device(standardize_image(scene[k]))
                       for k in ("left", "right"))
        check_ranges(family, pipeline.net, left, right,
                     volume_dtype="bfloat16")
    return counts, pipeline, serving


def check_counts(path: str, counts: dict, pairs: int = 1) -> None:
    """The exact launches of every kernel on a driven path."""
    for name in KERNELS:
        want = PER_PAIR[path].get(name, 0) * pairs
        if counts[name] != want:
            raise AssertionError(
                f"{path}: {name} launched {counts[name]} times, want {want}")


def outside_share(disparity) -> float:
    return ((disparity < 0) | (disparity >= MAIN_NDISP)).float().mean().item()


def check_ranges(what, net, left, right, **options) -> None:
    """The WTA and LR-interpolated maps of a main-path pair lie in
    [0, ndisp) exactly; only the subpixel fit may leave it."""
    import torch
    from mccnn_tpu_torch.ops.lr_check import lr_consistency_interpolate
    from mccnn_tpu_torch.ops.subpixel import subpixel_enhance
    from mccnn_tpu_torch.pipeline.match import match_pair

    out = match_pair(net, left, right, MAIN_NDISP, return_volumes=True,
                     **options)
    lr = lr_consistency_interpolate(out["left_disparity"],
                                    out["right_disparity"], MAIN_NDISP)
    shares = {
        "wta left": outside_share(out["left_disparity"]),
        "wta right": outside_share(out["right_disparity"]),
        "lr": outside_share(lr),
    }
    subpixel = outside_share(
        subpixel_enhance(lr, out["left_volume"], MAIN_NDISP))
    log(f"  {what:12s} outside [0, ndisp): {shares}, after subpixel "
        f"{subpixel:.2e}")
    if any(shares.values()):
        raise AssertionError(f"{what}: maps outside [0, ndisp) before "
                             f"subpixel: {shares}")
    torch.cuda.synchronize()


def synchronizing_calls(fn) -> list:
    """The messages of the synchronizing calls that ``fn`` makes, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them."""
    import warnings

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return [str(w.message) for w in caught
            if "synchroniz" in str(w.message).lower()]


def check_dispatch_is_async(pipeline, scene) -> None:
    """``dispatch`` must enqueue without waiting on the device (the serve
    loop overlaps host work with it): no synchronizing call inside it."""
    import torch
    from mccnn_tpu_torch.pipeline.match import standardize_image

    left = standardize_image(scene["left"])
    right = standardize_image(scene["right"])
    torch.cuda.synchronize()
    handles = []
    t0 = time.perf_counter()
    syncs = synchronizing_calls(
        lambda: handles.append(pipeline.dispatch(left, right, MAIN_NDISP)))
    t1 = time.perf_counter()
    pipeline.fetch(handles[0])
    t2 = time.perf_counter()
    log(f"  dispatch returned after {1e3 * (t1 - t0):.1f} ms, fetch after "
        f"{1e3 * (t2 - t0):.1f} ms; synchronizing calls in dispatch: "
        f"{len(syncs)}")
    if syncs:
        raise AssertionError(f"dispatch synchronized: {syncs[:3]}")


def write_png(image: np.ndarray, path: str) -> None:
    """Save an image in ~[0, 1] as an 8-bit grayscale PNG."""
    pixels = np.clip(np.rint(image * 255.0), 0, 255).astype(np.uint8)
    try:
        from PIL import Image
    except ImportError:
        import cv2

        if not cv2.imwrite(path, pixels):
            raise RuntimeError(f"could not write {path}")
    else:
        Image.fromarray(pixels).save(path)


def drive_batch_matcher(device, launches, smi: str) -> dict:
    """Phase 5: ``cli.match.main`` on one full-width scene in a temporary
    Middlebury layout, three batch schedules and three CBCA variants, then
    the variants that have no CLI flag; returns the launch counts per run."""
    import torch
    from mccnn_tpu_torch.cli import match as cli
    from mccnn_tpu_torch.data.dataset import load_grayscale
    from mccnn_tpu_torch.io.pfm import read_pfm
    from mccnn_tpu_torch.models.net import init_params
    from mccnn_tpu_torch.models.params import save_params
    from mccnn_tpu_torch.pipeline.match import (
        STAGES,
        MatchPipeline,
        standardize_image,
    )
    from mccnn_tpu_torch.utils.evaluate import bad_n
    from mccnn_tpu_torch.utils.scenes import make_scene

    height, width = MAIN_SHAPE
    scene = make_scene(BATCH_SCENE, np.random.default_rng(SEED + 3), height,
                       width, 150)
    runs = {
        "match exact-f32": ["--cbca_impl", "pallas", "--volume_dtype",
                            "float32"],
        "match int8 d-chunked": ["--cbca_impl", "fused8", "--volume_dtype",
                                 "bfloat16", "--cbca_chunk_d", "128"],
        "match stage_times": ["--stage_times", "--cbca_impl", "pallas"],
        "match rolling bf16": ["--cbca_impl", "rolling", "--volume_dtype",
                               "bfloat16"],
        "match fused2 bf16": ["--cbca_impl", "fused2", "--volume_dtype",
                              "bfloat16"],
        "match fused2_16 f32": ["--cbca_impl", "fused2_16", "--volume_dtype",
                                "float32"],
    }
    results = {}
    log(smi)
    with tempfile.TemporaryDirectory() as tmp:
        scene_dir = os.path.join(tmp, "data", "scene0")
        os.makedirs(scene_dir)
        write_png(scene["left"], os.path.join(scene_dir, "im0.png"))
        write_png(scene["right"], os.path.join(scene_dir, "im1.png"))
        with open(os.path.join(scene_dir, "calib.txt"), "w") as f:
            f.write("cam0=[1 0 0]\ncam1=[1 0 0]\ndoffs=0\nbaseline=100\n"
                    f"width={width}\nheight={height}\nndisp={MAIN_NDISP}\n")
        list_file = os.path.join(tmp, "list.txt")
        with open(list_file, "w") as f:
            f.write(os.path.join(scene_dir, "im0.png") + "\n")
        weights = os.path.join(tmp, "weights.npz")
        save_params(init_params(SEED), weights)
        # the pair as the CLI reads it (8-bit files), for the comparisons
        left = standardize_image(load_grayscale(
            os.path.join(scene_dir, "im0.png")))
        right = standardize_image(load_grayscale(
            os.path.join(scene_dir, "im1.png")))

        for tag, (path, flags) in enumerate(runs.items()):
            save_dir = os.path.join(tmp, f"out{tag}")
            argv = ["--list_file", list_file, "--resume", weights,
                    "--data_dir", os.path.join(tmp, "data"),
                    "--save_dir", save_dir, "--tag", "smoke", "--start", "0",
                    "--end", "0", "--device", str(device), *flags]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            launches.reset()
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                cli.main(argv)
            counts = launches.snapshot()
            torch.cuda.synchronize()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            check_counts(path, counts)
            out = os.path.join(save_dir, "submit_smoke", "scene0")
            pgm = os.path.join(save_dir, "submit_smoke_imgs", "scene0",
                               "disp0MCCNN.pgm")
            if not os.path.getsize(pgm) > height * width:
                raise AssertionError(f"{path}: {pgm} is short")
            with open(os.path.join(out, "timeMCCNN.txt")) as f:
                seconds = float(f.read())
            disparity = read_pfm(os.path.join(out, "disp0MCCNN.pfm"))
            if disparity.shape != (height, width):
                raise AssertionError(f"{path}: PFM shape {disparity.shape}")
            if not np.isfinite(disparity).all():
                raise AssertionError(f"{path}: non-finite disparity")
            outside = float(((disparity < 0)
                             | (disparity >= MAIN_NDISP)).mean())
            if outside > 1e-3:
                raise AssertionError(f"{path}: {outside} of pixels outside "
                                     "[0, ndisp)")
            bad2 = float(bad_n(disparity, scene["gt"], 2.0))
            launched = {k: v for k, v in counts.items() if v}
            log(f"  {path}: {seconds:.4f} s/pair, launches {launched}, peak "
                f"device memory {peak_gb:.2f} GB, bad-2.0 {bad2:.4f} (random "
                f"weights), {outside:.2e} outside [0, ndisp)")
            results[path] = {"counts": counts, "disparity": disparity,
                             "bad2": bad2, "printed": printed.getvalue()}

    # run 3's ten stage lines, in the CLI's format
    stage_lines = [line for line in
                   results["match stage_times"]["printed"].splitlines()
                   if line.startswith("  ") and line.endswith(" ms")]
    if [line.split()[0] for line in stage_lines] != list(STAGES):
        raise AssertionError(f"stage_times printed {stage_lines}")
    log(smi)
    for line in stage_lines:
        log(line)

    exact = results["match exact-f32"]["disparity"]
    if not np.array_equal(exact, results["match stage_times"]["disparity"]):
        raise AssertionError("stage_times and __call__ disparities differ")
    # K2 and K7 both equal the plain f32 round bit for bit, so the default
    # f32 pipeline must give the same map as --cbca_impl pallas
    pipeline = MatchPipeline(init_params(SEED), volume_dtype="float32",
                             bucket=1, device=device)
    if not np.array_equal(exact, pipeline(left, right, MAIN_NDISP)):
        raise AssertionError("--cbca_impl pallas (K7) and the default f32 "
                             "pipeline (K2) disagree")
    delta = abs(results["match int8 d-chunked"]["bad2"]
                - results["match exact-f32"]["bad2"])
    log(f"  exact-f32 == stage_times == K2 f32 pipeline; int8 d-chunked "
        f"bad-2.0 within {delta:.4f} of exact-f32 (limit 0.005)")
    if not delta <= 0.005:
        raise AssertionError(f"int8 bad-2.0 is {delta} from exact f32")

    tensors = [pipeline._to_device(x) for x in (left, right)]
    check_ranges("exact-f32", pipeline.net, *tensors, cbca_impl="pallas")
    check_ranges("int8 chunked", pipeline.net, *tensors, cbca_impl="fused8",
                 volume_dtype="bfloat16", cbca_chunk_d=128)
    counts = {path: r["counts"] for path, r in results.items()}
    counts.update(drive_variants(device, launches, scene, left, right,
                                 results, tensors, pipeline.net))
    return counts


def drive_variants(device, launches, scene, left, right, results, tensors,
                   net) -> dict:
    """Phase 5, second half: the variant runs' checks, the variants without
    a CLI flag (``sgm_u8``), K6 through ``band_pair_pallas`` and K10 through
    the stream probe. Returns the launch counts of the new paths."""
    import torch
    from mccnn_tpu_torch.models.net import extract_features, init_params
    from mccnn_tpu_torch.ops.common import pad_disparities
    from mccnn_tpu_torch.ops.cost_volume import band_pair, band_pair_pallas
    from mccnn_tpu_torch.pipeline.match import MatchPipeline
    from mccnn_tpu_torch.tools import bench_cbca_stream
    from mccnn_tpu_torch.utils.config import MatchConfig
    from mccnn_tpu_torch.utils.evaluate import bad_n

    def run(what, config=MatchConfig(), **options):
        """One timed pair through ``MatchPipeline`` as the CLI builds it."""
        pipeline = MatchPipeline(init_params(SEED), config, bucket=1,
                                 device=device, **options)
        pipeline(left, right, MAIN_NDISP)  # first use of this schedule
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launches.reset()
        t0 = time.perf_counter()
        disparity = pipeline(left, right, MAIN_NDISP)
        seconds = time.perf_counter() - t0
        counts = launches.snapshot()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        bad2 = float(bad_n(disparity, scene["gt"], 2.0))
        log(f"  {what}: {seconds:.4f} s/pair, launches "
            f"{ {k: v for k, v in counts.items() if v} }, peak device memory "
            f"{peak_gb:.2f} GB, bad-2.0 {bad2:.4f} (random weights)")
        return disparity, counts, bad2

    # rolling16 in f32 on penalty codes, and the same run on the planes
    path = "pipeline rolling16 sgm_u8"
    coded, counts, coded_bad2 = run(path, MatchConfig(sgm_u8=True),
                                    cbca_impl="rolling16")
    check_counts(path, counts)
    uncoded, _, _ = run("pipeline rolling16", cbca_impl="rolling16")
    if not np.array_equal(coded, uncoded):
        raise AssertionError("sgm_u8 changed the disparity")
    # K8 and K9 equal K2 bit for bit, so in bf16 storage they must give the
    # K2 bf16 pipeline's map
    fused_bf16, _, _ = run("pipeline fused bf16 (K2)",
                           volume_dtype="bfloat16")
    for name in ("match rolling bf16", "match fused2 bf16"):
        if not np.array_equal(results[name]["disparity"], fused_bf16):
            raise AssertionError(f"{name} differs from the K2 bf16 pipeline")
    exact_bad2 = results["match exact-f32"]["bad2"]
    deltas = {name: abs(results[name]["bad2"] - exact_bad2)
              for name in ("match rolling bf16", "match fused2 bf16",
                           "match fused2_16 f32")}
    deltas[path] = abs(coded_bad2 - exact_bad2)
    log(f"  sgm_u8 == planes; rolling bf16 == fused2 bf16 == K2 bf16 "
        f"pipeline; bad-2.0 deltas to exact-f32 (limit 0.005): "
        f"{ {k: round(v, 4) for k, v in deltas.items()} }")
    if not max(deltas.values()) <= 0.005:
        raise AssertionError(f"a variant's bad-2.0 is off exact f32: {deltas}")
    check_ranges("rolling bf16", net, *tensors, cbca_impl="rolling",
                 volume_dtype="bfloat16")
    new_counts = {path: counts}

    # K6 through its entry point, on this scene's f32 descriptors
    d_pad = pad_disparities(MAIN_NDISP)
    with torch.no_grad():
        features = [extract_features(net, t).contiguous() for t in tensors]
    launches.reset()
    scores = band_pair_pallas(*features, d_pad, use_mxu=False)
    new_counts["raw bands"] = launches.snapshot()
    check_counts("raw bands", new_counts["raw bands"])
    costs = band_pair(*features, d_pad, d_pad, torch.float32)
    for side, score, cost in zip(("left", "right"), scores, costs):
        if tuple(score.shape) != (*MAIN_SHAPE, d_pad) or not bool(
                torch.isfinite(score).all()):
            raise AssertionError(f"raw {side} band: bad shape or values")
        if not torch.equal(-score, cost):
            raise AssertionError(f"raw {side} band: -K6 differs from K5")
    log(f"  raw bands: band_pair_pallas(use_mxu=False) {tuple(scores[0].shape)}"
        f" x 2, -K6 == K5(ndisp = d_pad) bit for bit")
    del scores, costs, features

    # K10 through the probe's own entry point, at its default tile shape
    os.environ["ITERS"] = str(PROBE_ITERS)
    launches.reset()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        bench_cbca_stream.main()
    new_counts["stream probe"] = launches.snapshot()
    check_counts("stream probe", new_counts["stream probe"])
    log("  " + printed.getvalue().strip())
    return new_counts


def compare_whole_pair(device) -> None:
    """Phase 6: the pair on the kernels against the same pair run on CPU
    copies, where every wrapper takes its plain version: the two storage
    types at ndisp 64, then at ndisp 32 the bf16-operand modes of K2 and K8
    and the two torch-op aggregations, ``mxu`` and joint regions (the
    latter with 1 + 2 rounds: its CPU copy takes seconds per round)."""
    import copy

    import torch
    from mccnn_tpu_torch.models.net import init_params, params_from_numpy
    from mccnn_tpu_torch.pipeline.match import match_pair
    from mccnn_tpu_torch.utils.config import MatchConfig

    height, width = MIDDLE_SHAPE
    net_cpu = params_from_numpy(init_params(SEED))
    net = copy.deepcopy(net_cpu).to(device)
    s, left, right = scene_images(height, width, "slanted",
                                  np.random.default_rng(SEED + 1), device, 50)
    joint = MatchConfig(cbca_joint_regions=True, cbca_num_iterations_1=1,
                        cbca_num_iterations_2=2)
    cases = [
        ("float32", 64, MatchConfig(), {"volume_dtype": "float32"}),
        ("bfloat16", 64, MatchConfig(), {"volume_dtype": "bfloat16"}),
        ("fused16", 32, MatchConfig(), {"cbca_impl": "fused16"}),
        ("rolling16", 32, MatchConfig(), {"cbca_impl": "rolling16"}),
        ("mxu", 32, MatchConfig(), {"cbca_impl": "mxu"}),
        ("joint regions, 1 + 2 rounds", 32, joint, {}),
    ]
    for what, ndisp, config, options in cases:
        match_pair(net, left, right, ndisp, config, **options)  # first use
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = match_pair(net, left, right, ndisp, config, **options).cpu()
        seconds = time.perf_counter() - t0
        want = match_pair(net_cpu, left.cpu(), right.cpu(), ndisp, config,
                          **options)
        # cuDNN and CPU convolutions round apart, so a few WTA ties flip
        diff = (got - want).abs()
        far = (diff > 1.0).float().mean().item()
        log(f"  {what} (ndisp {ndisp}): {seconds:.4f} s/pair on the card, "
            f"pixels off by > 1 px {far:.5f} (limit 0.01), identical "
            f"{(diff == 0).float().mean().item():.5f}")
        if not far <= 0.01:
            raise AssertionError(f"whole pair {what}: {far} of pixels off")


def time_events(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` runs after one warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, operations: float, kind: str):
    """(ms, "bytes" | "operations"): the least time the card could take:
    each input read and each output written once at the memory rate, or
    the operations at the peak rate of their type, whichever is longer."""
    by_bytes = 1e3 * bytes_moved / HBM_BYTES_PER_S
    by_ops = 1e3 * operations / PEAK_OPS_PER_S[kind]
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


def compare_costs(errors: Errors, ndisp: int, name: str, what: str, got,
                  want, tol: float) -> None:
    """|got - want| on the real disparities within ``tol``; the pad lanes of
    ``got`` must stay at ``BIG_COST``."""
    err = (got[..., :ndisp].float()
           - want[..., :ndisp].float()).abs().max().item()
    errors.record(name, what, err, tol)
    if got[..., ndisp:].float().min().item() < 1e8:
        raise AssertionError(f"{name} {what}: pad lanes fell below 1e8")


def compare_side_f32(errors: Errors, ndisp: int, what: str, got,
                     want) -> None:
    """K1's f32 route against its plain version: 1e-5 (the plain
    correlation is cuBLAS's, summed in its own order; |cost| <= 1), the
    zeros where no match exists and the pad lanes exact."""
    errors.record("band_side", what, (got - want).abs().max().item(), 1e-5)
    zero = want[..., :ndisp] == 0
    if not (bool((got[..., :ndisp][zero] == 0).all())
            and bool((got[..., ndisp:] == want[..., ndisp:]).all())):
        raise AssertionError(f"band_side {what}: zeros or pad lanes differ "
                             "from the plain version")


def fill_bound(height: int, ndisp: int, item_bytes: int):
    """K11's bound: each row's triangle, ndisp (ndisp - 1) / 2 values,
    written once, and each lane's three window values read once; a value
    takes three adds and a multiply."""
    values = height * ndisp * (ndisp - 1) // 2
    return bound(item_bytes * (values + 3 * height * (ndisp - 1)),
                 4 * values, "f32")


def border_times(times: dict, fl, fr, ndisp: int, d_pad: int, dtype,
                 pair) -> None:
    """K11 on the serving path's bands, in place (a launch writes the
    values the last one wrote: a step reads only columns no earlier step
    wrote on its lane), beside the torch-op loop: its CUDA-event time, its
    host's enqueue and its kernels' device time; then both sides at the
    full config's shape (2048 x 3072, ndisp 400, D_pad 512)."""
    import torch
    from mccnn_tpu_torch.ops.common import BIG_COST
    from mccnn_tpu_torch.ops.cost_volume import (
        band_side,
        border_fill,
        border_fill_plain,
    )

    bands = {"left": band_side(fl, fr, ndisp, d_pad, "left", dtype),
             "right": band_side(fr, fl, ndisp, d_pad, "right", dtype)}
    pair("border_fill", lambda: border_fill(bands["left"], ndisp, "left"),
         lambda: border_fill_plain(bands["left"], ndisp, "left"), 20, 2)
    entry = times["border_fill"]
    entry["ms_right"] = time_events(
        lambda: border_fill(bands["right"], ndisp, "right"), 20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    border_fill_plain(bands["left"], ndisp, "left")
    entry["plain_host_ms"] = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    _, entry["plain_device_ms"], _ = profiled(
        lambda: border_fill_plain(bands["left"], ndisp, "left"))
    del bands
    height, width, ndisp_full, d_full = 2048, 3072, 400, 512
    volume = torch.empty((height, width, d_full), dtype=dtype,
                         device=fl.device).uniform_(-1, 1)
    volume[..., ndisp_full:] = BIG_COST
    for side in ("left", "right"):
        got = border_fill(volume.clone(), ndisp_full, side)
        if not torch.equal(got, border_fill_plain(volume.clone(),
                                                  ndisp_full, side)):
            raise AssertionError(f"border_fill {side} at 2048 x 3072 x 512"
                                 " differs from the torch-op loop")
        del got
        key = "ms_full" if side == "left" else "ms_full_right"
        entry[key] = time_events(
            lambda s=side: border_fill(volume, ndisp_full, s), 20)
    entry["plain_ms_full"] = time_events(
        lambda: border_fill_plain(volume, ndisp_full, "left"), 2)
    entry["bound_ms_full"], _ = fill_bound(height, ndisp_full, 2)
    del volume
    log(f"  {'border_fill':18s} left {entry['ms']:.4f}, right "
        f"{entry['ms_right']:.4f} ms; the loop {entry['plain_ms']:.4f} ms "
        f"(host {entry['plain_host_ms']:.4f}, its kernels "
        f"{entry['plain_device_ms']:.4f}); at {height} x {width} x {d_full},"
        f" ndisp {ndisp_full}: left {entry['ms_full']:.4f}, right "
        f"{entry['ms_full_right']:.4f} ms, the loop "
        f"{entry['plain_ms_full']:.4f} ms, bound "
        f"{entry['bound_ms_full']:.4f} ms")


def main_shape_kernels(device, errors: Errors) -> dict:
    """Phase 7: each kernel against its plain version at the main-path
    shapes (1000 x 1504, ndisp 200, D_pad 256; K1-K3 in bf16 as the serving
    path runs them, K5 and K7 in f32 and K4 on int8 as the batch matcher
    runs them, K4 timed on the 128-lane chunk the d-chunked run hands it;
    K8 and K9 in bf16 as the variant runs launch them, K9 per two-round
    pass; K6 on the f32 descriptors; K10 in bf16, flat, at K7's and K2's
    tile shapes on the volume padded to whole tiles; K2 and K8 in f32 and
    with bf16 operands on f32 storage, and K3 on penalty codes): outputs,
    then times and bounds."""
    import torch
    from mccnn_tpu_torch.ops.cbca import (
        cbca_round,
        compute_arms,
        inverse_region_size,
    )
    from mccnn_tpu_torch.ops.cbca_fused import (
        _quantize_int8,
        cbca_round_cuda,
        cbca_round_int8_cuda,
        cbca_round_int8_plain,
    )
    from mccnn_tpu_torch.ops.cbca_fused2 import cbca_two_rounds_cuda
    from mccnn_tpu_torch.ops.cbca_pallas import cbca_stencil_round_cuda
    from mccnn_tpu_torch.ops.cbca_rolling import cbca_rolling_round_cuda
    from mccnn_tpu_torch.ops.common import pad_disparities
    from mccnn_tpu_torch.ops.cost_volume import (
        band_pair,
        band_pair_plain,
        band_pair_scores,
        band_pair_scores_plain,
        band_side,
        band_side_plain,
        border_fill,
        border_fill_plain,
    )
    from mccnn_tpu_torch.ops.sgm import (
        _DIRECTIONS,
        penalty_scale_u8,
        sweep_cuda,
        sweep_plain,
    )
    from mccnn_tpu_torch.tools.bench_cbca_stream import (
        cbca_stream,
        cbca_stream_plain,
    )
    from mccnn_tpu_torch.utils.config import MatchConfig

    config = MatchConfig()
    distance = config.cbca_distance
    height, width = MAIN_SHAPE
    ndisp, d_pad, dtype = MAIN_NDISP, pad_disparities(MAIN_NDISP), \
        torch.bfloat16
    rng = np.random.default_rng(SEED)
    fl32 = unit_features(rng, height, width, device)
    fr32 = unit_features(rng, height, width, device)
    fl, fr = fl32.to(dtype), fr32.to(dtype)
    _, left, right = scene_images(height, width, "occlusion", rng, device,
                                  150)

    def compare(name, what, got, want, tol):
        compare_costs(errors, ndisp, name, what, got, want, tol)

    # the serving path's operands: (anchor, other) per side, arms of the
    # side's own image; sums of bf16 values round one ulp (2^-8) apart at
    # |cost| <= 1, SGM costs two ulps at the largest cost
    sides = {"left": (fl, fr, left, "L"), "right": (fr, fl, right, "R")}
    volumes = {}
    for side, (anchor, other, image, choice) in sides.items():
        volume = band_side(anchor, other, ndisp, d_pad, side, dtype)
        compare("band_side", side, volume,
                band_side_plain(anchor, other, ndisp, d_pad, side, dtype),
                2.0 ** -8)
        # K11 on a copy (the volume below stays unfilled): the torch-op
        # loop's values bit for bit
        compare("border_fill", side,
                border_fill(volume.clone(), ndisp, side),
                border_fill_plain(volume.clone(), ndisp, side), 0.0)
        arms = compute_arms(image, config.cbca_intensity, distance)
        inv = inverse_region_size(arms, distance).contiguous()
        aggregated = torch.empty_like(volume)
        cbca_round_cuda(volume, aggregated, arms, inv, distance)
        compare("cbca_round", side, aggregated,
                cbca_round(volume, arms, inv, distance), 2.0 ** -8)
        for direction in _DIRECTIONS:
            out_k = torch.empty_like(volume)
            out_p = torch.empty_like(volume)
            sweep_cuda(aggregated, out_k, left, right, choice, direction,
                       config)
            sweep_plain(aggregated, out_p, left, right, choice, direction,
                        config)
            top = out_p[..., :ndisp].float().abs().max().item()
            compare("sgm_sweep", f"{side} dir {direction}", out_k, out_p,
                    2 * bf16_ulp(top))
            # on a code volume: the same sweep (tolerance 0.0)
            codes = penalty_scale_u8(left, right, choice, direction, d_pad,
                                     config.sgm_d)
            sweep_cuda(aggregated, out_p, left, right, choice, direction,
                       config, codes)
            compare("sgm_sweep", f"{side} dir {direction} on codes", out_p,
                    out_k, 0.0)
            del codes
        # K8 and K9 in bf16: the plain rounds' f32 order (tolerance 0.0),
        # and equal to K2 (one round above; a second one here)
        rolled = torch.empty_like(volume)
        cbca_rolling_round_cuda(volume, rolled, arms, inv, distance)
        compare("cbca_rolling_round", side, rolled,
                cbca_round(volume, arms, inv, distance), 0.0)
        if not torch.equal(rolled, aggregated):
            raise AssertionError("cbca_rolling_round differs from cbca_round")
        twice = torch.empty_like(volume)
        cbca_two_rounds_cuda(volume, twice, arms, inv, distance)
        compare("cbca_two_rounds", side, twice,
                cbca_round(aggregated, arms, inv, distance), 0.0)
        cbca_round_cuda(aggregated, rolled, arms, inv, distance)
        if not torch.equal(twice, rolled):
            raise AssertionError("cbca_two_rounds differs from two launches "
                                 "of cbca_round")
        del rolled, twice
        # the int8 schedule's operand: this side's bf16 volume, quantized;
        # integer math, tolerance 0.0, at the full depth and at the
        # 128-lane chunk the d-chunked run hands the kernel
        q = _quantize_int8(aggregated)[0]
        for what, block in (("", q), (" 128-lane chunk",
                                      q[..., :128].contiguous())):
            got = torch.empty_like(block)
            cbca_round_int8_cuda(block, got, arms, inv, distance)
            want = cbca_round_int8_plain(block, arms, inv, distance)
            err = (got.int() - want.int()).abs().max().item()
            errors.record("cbca_round_int8", side + what, err, 0.0)
            if not bool((got[..., ndisp:] == 127).all()):
                raise AssertionError("cbca_round_int8: BIG lanes left 127")
        volumes[side] = (volume, arms, inv, aggregated, q)
    del out_k, out_p, got, want, block
    torch.cuda.synchronize()

    # the batch matcher's f32 operands: K5 builds both volumes from the f32
    # descriptors (tolerance 0.0 against its plain version and against two
    # K1 launches), K7 aggregates them
    pair32 = band_pair(fl32, fr32, ndisp, d_pad, torch.float32)
    plain32 = band_pair_plain(fl32, fr32, ndisp, d_pad, torch.float32)
    for side, got, want in zip(("left", "right"), pair32, plain32):
        compare("band_pair", f"{side} f32 vs plain", got, want, 0.0)
    del plain32
    ones = (band_side(fl32, fr32, ndisp, d_pad, "left", torch.float32),
            band_side(fr32, fl32, ndisp, d_pad, "right", torch.float32))
    for side, got, one in zip(("left", "right"), pair32, ones):
        compare("band_pair", f"{side} f32 vs two band_side", got, one, 0.0)
    for side, one, (anchor, other) in zip(("left", "right"), ones,
                                          ((fl32, fr32), (fr32, fl32))):
        compare_side_f32(errors, ndisp, f"{side} f32", one,
                         band_side_plain(anchor, other, ndisp, d_pad, side,
                                         torch.float32))
    del ones
    for side, vol32 in zip(("left", "right"), pair32):
        _, arms, inv, _, _ = volumes[side]
        got = torch.empty_like(vol32)
        cbca_stencil_round_cuda(vol32, got, arms, inv, distance)
        compare("cbca_stencil_round", f"{side} f32", got,
                cbca_round(vol32, arms, inv, distance), 0.0)
        # K2 and K8 on f32 storage equal K7; then with bf16 operands, V4's
        # launch of K8 (tolerance 0.0)
        other = torch.empty_like(vol32)
        rounds = (("cbca_round", cbca_round_cuda),
                  ("cbca_rolling_round", cbca_rolling_round_cuda))
        for name, fn in rounds:
            fn(vol32, other, arms, inv, distance)
            if not torch.equal(other, got):
                raise AssertionError(f"{name} f32 differs from "
                                     "cbca_stencil_round")
        want = cbca_round(vol32, arms, inv, distance, torch.bfloat16)
        for name, fn in rounds:
            fn(vol32, got, arms, inv, distance, torch.bfloat16)
            compare(name, f"{side} f32, bf16 operands", got, want, 0.0)
        del other, want
    # K6 on the f32 descriptors, raw scores on all 256 lanes (tolerance 0.0
    # against its plain version; -K6 == K5 with ndisp = d_pad)
    scores = band_pair_scores(fl32, fr32, d_pad)
    plain_scores = band_pair_scores_plain(fl32, fr32, d_pad)
    costs = band_pair(fl32, fr32, d_pad, d_pad, torch.float32)
    for side, score, want, cost in zip(("left", "right"), scores,
                                       plain_scores, costs):
        errors.record("band_scores", side,
                      (score - want).abs().max().item(), 0.0)
        if not torch.equal(-score, cost):
            raise AssertionError(f"band_scores {side}: -scores differ from "
                                 "band_pair")
    del scores, plain_scores, costs
    # K5 in bf16 (path T with --volume_dtype bfloat16) and K6 with bf16
    # output: equal to the f32 launches on the same values, rounded
    # (tolerance 0.0); then against their plain versions, one bf16 ulp at
    # |value| <= 1
    pair16 = band_pair(fl, fr, ndisp, d_pad, dtype)
    widened = band_pair(fl.float(), fr.float(), ndisp, d_pad, torch.float32)
    for side, band16, exact, reference in zip(
            ("left", "right"), pair16, widened,
            band_pair_plain(fl, fr, ndisp, d_pad, dtype)):
        compare("band_pair", f"{side} bf16 vs f32 launch, rounded", band16,
                exact.to(dtype), 0.0)
        compare("band_pair", f"{side} bf16 vs plain", band16, reference,
                2.0 ** -8)
    del pair16, widened
    scores16 = band_pair_scores(fl32, fr32, d_pad, dtype)
    for side, band16, exact, reference in zip(
            ("left", "right"), scores16, band_pair_scores(fl32, fr32, d_pad),
            band_pair_scores_plain(fl32, fr32, d_pad, dtype)):
        errors.record("band_scores", f"{side} bf16 out vs f32 out, rounded",
                      (band16.float() - exact.to(dtype).float()).abs().max()
                      .item(), 0.0)
        errors.record("band_scores", f"{side} bf16 out vs plain",
                      (band16.float() - reference.float()).abs().max()
                      .item(), 2.0 ** -8)
    del scores16, band16, exact, reference
    torch.cuda.synchronize()

    volume, arms, inv, out, q = volumes["left"]
    vol32, out32 = pair32[0], got
    # K4 as its path launches it: one 128-lane chunk of the quantized volume
    chunk_lanes = 128
    q_chunk = q[..., :chunk_lanes].contiguous()
    out8, out8_chunk = torch.empty_like(q), torch.empty_like(q_chunk)
    del volumes, pair32
    # K10's operand: the bf16 volume padded to whole 32-row tiles, as the
    # probe pads it; the output equals the input
    tiled = torch.zeros((-(-height // 32) * 32, width, d_pad), dtype=dtype,
                        device=device)
    tiled[:height] = volume
    for label, tiles in STREAM_TILES.items():
        err = (cbca_stream(tiled, *tiles).float() - tiled.float()).abs().max()
        errors.record("cbca_stream", f"tiles of {label}", err.item(), 0.0)
    times = {}

    def pair(name, kernel, plain, reps_k, reps_p):
        ms_p1 = time_events(plain, reps_p)
        ms_k1 = time_events(kernel, reps_k)
        ms_k2 = time_events(kernel, reps_k)
        ms_p2 = time_events(plain, reps_p)
        times[name] = {"ms": (ms_k1 + ms_k2) / 2,
                       "plain_ms": (ms_p1 + ms_p2) / 2}
        log(f"  {name:18s} kernel {ms_k1:.4f} / {ms_k2:.4f} ms, plain "
            f"{ms_p1:.4f} / {ms_p2:.4f} ms (plain, kernel, kernel, plain)")

    pair("band_side",
         lambda: band_side(fl, fr, ndisp, d_pad, "left", dtype),
         lambda: band_side_plain(fl, fr, ndisp, d_pad, "left", dtype),
         10, 2)
    border_times(times, fl, fr, ndisp, d_pad, dtype, pair)
    pair("cbca_round",
         lambda: cbca_round_cuda(volume, out, arms, inv, distance),
         lambda: cbca_round(volume, arms, inv, distance),
         20, 2)
    # K3 in place, as the chained serving path launches it (on a copy: each
    # launch sweeps the last one's output, which costs the kernel the same),
    # beside its plain version in place
    chained = volume.clone()
    for direction, label in (((0, 1), "horizontal"), ((1, 0), "vertical")):
        pair(f"sgm_sweep {label}",
             lambda d=direction: sweep_cuda(chained, chained, left, right,
                                            "L", d, config),
             lambda d=direction: sweep_plain(chained, chained, left, right,
                                             "L", d, config),
             10, 1)
    h, v = times.pop("sgm_sweep horizontal"), times.pop("sgm_sweep vertical")
    times["sgm_sweep"] = {k: (h[k] + v[k]) / 2 for k in h}
    times["sgm_sweep"].update(ms_horizontal=h["ms"], ms_vertical=v["ms"])
    del chained
    pair("cbca_round_int8 full depth",
         lambda: cbca_round_int8_cuda(q, out8, arms, inv, distance),
         lambda: cbca_round_int8_plain(q, arms, inv, distance),
         20, 2)
    del times["cbca_round_int8 full depth"]  # logged only: no path runs it
    pair("cbca_round_int8",
         lambda: cbca_round_int8_cuda(q_chunk, out8_chunk, arms, inv,
                                      distance),
         lambda: cbca_round_int8_plain(q_chunk, arms, inv, distance),
         20, 2)
    pair("band_pair",
         lambda: band_pair(fl32, fr32, ndisp, d_pad, torch.float32),
         lambda: band_pair_plain(fl32, fr32, ndisp, d_pad, torch.float32),
         10, 2)
    pair("cbca_stencil_round",
         lambda: cbca_stencil_round_cuda(vol32, out32, arms, inv, distance),
         lambda: cbca_round(vol32, arms, inv, distance),
         20, 2)
    pair("cbca_rolling_round",
         lambda: cbca_rolling_round_cuda(volume, out, arms, inv, distance),
         lambda: cbca_round(volume, arms, inv, distance),
         20, 2)
    pair("cbca_two_rounds",
         lambda: cbca_two_rounds_cuda(volume, out, arms, inv, distance),
         lambda: cbca_round(cbca_round(volume, arms, inv, distance), arms,
                            inv, distance),
         20, 1)
    pair("band_scores",
         lambda: band_pair_scores(fl32, fr32, d_pad),
         lambda: band_pair_scores_plain(fl32, fr32, d_pad),
         10, 2)
    # K10 beside the one PyTorch call that computes the same function, a
    # copy; its time in the summary is the one at the tiling of K2 and K7,
    # beside the floor of that tiling's window traffic: (1 + 32 / tile_h)
    # (1 + 32 / tile_w) reads and one write of the volume
    for label, tiles in STREAM_TILES.items():
        pair(f"cbca_stream {label}", lambda t=tiles: cbca_stream(tiled, *t),
             lambda: cbca_stream_plain(tiled), 20, 20)
    # and at the probe's default tiling, on the volume padded to whole
    # 128-column tiles as the probe pads it
    wide = torch.zeros((tiled.shape[0], -(-width // 128) * 128, d_pad),
                       dtype=dtype, device=device)
    wide[:, :width] = tiled
    err = (cbca_stream(wide, *STREAM_DEFAULT_TILES).float()
           - wide.float()).abs().max()
    errors.record("cbca_stream", "the probe's default tiles", err.item(),
                  0.0)
    pair("cbca_stream default",
         lambda: cbca_stream(wide, *STREAM_DEFAULT_TILES),
         lambda: cbca_stream_plain(wide), 20, 20)
    del wide
    stream_default = times.pop("cbca_stream default")
    (walk_label, (tile_h, tile_w, _)), (old_label, _) = STREAM_TILES.items()
    stream_old = times.pop(f"cbca_stream {old_label}")
    times["cbca_stream"] = times.pop(f"cbca_stream {walk_label}")
    reads = (1 + STREAM_HALO / tile_h) * (1 + STREAM_HALO / tile_w)
    times["cbca_stream"].update(
        library_ms=times["cbca_stream"]["plain_ms"],
        window_bound_ms=1e3 * (reads + 1) * tiled.numel() * 2
        / HBM_BYTES_PER_S,
        ms_at_32x32x8_tiles=stream_old["ms"],
        ms_at_default_tiles=stream_default["ms"],
        plain_ms_at_default_tiles=stream_default["plain_ms"])
    # K3 out of place (the paper mode) and in f32 in place (paths E and
    # T), each the mean of a horizontal and a vertical sweep
    chained32 = vol32.clone()
    for key, source, target in (("ms_out_of_place", volume, out),
                                ("ms_f32", chained32, chained32)):
        times["sgm_sweep"][key] = sum(
            time_events(lambda d=d, s=source, t=target: sweep_cuda(
                s, t, left, right, "L", d, config), 10)
            for d in ((0, 1), (1, 0))) / 2
        log(f"  {'sgm_sweep':18s} {key:28s} "
            f"{times['sgm_sweep'][key]:.4f} ms")
    del chained32
    # the flags, kernel only: K2 with bf16 operands on f32 storage beside K2
    # on f32, K3 on penalty codes beside the torch ops that build them;
    # extra keys of the K2 and K3 entries of the summary
    codes = penalty_scale_u8(left, right, "L", (0, 1), d_pad, config.sgm_d)
    extras = (
        ("band_side", "ms_f32", lambda: band_side(
            fl32, fr32, ndisp, d_pad, "left", torch.float32)),
        ("band_side", "ms_f32_right", lambda: band_side(
            fr32, fl32, ndisp, d_pad, "right", torch.float32)),
        ("band_pair", "ms_bf16", lambda: band_pair(
            fl, fr, ndisp, d_pad, dtype)),
        ("band_scores", "ms_bf16_out", lambda: band_pair_scores(
            fl32, fr32, d_pad, dtype)),
        ("cbca_round", "ms_f32", lambda: cbca_round_cuda(
            vol32, out32, arms, inv, distance)),
        ("cbca_round", "ms_f32_bf16_operands", lambda: cbca_round_cuda(
            vol32, out32, arms, inv, distance, torch.bfloat16)),
        ("sgm_sweep", "ms_horizontal_on_codes", lambda: sweep_cuda(
            volume, out, left, right, "L", (0, 1), config, codes)),
        ("sgm_sweep", "ms_codes_build_horizontal", lambda: penalty_scale_u8(
            left, right, "L", (0, 1), d_pad, config.sgm_d)),
    )
    # K9 on f32 storage, alone and with bf16 operands (path V3's launch),
    # and K8 on f32 storage; K9 f32 equals two K2 rounds (tolerance 0.0)
    twice32, spare32 = torch.empty_like(vol32), torch.empty_like(vol32)
    cbca_two_rounds_cuda(vol32, twice32, arms, inv, distance)
    cbca_round_cuda(vol32, out32, arms, inv, distance)
    cbca_round_cuda(out32, spare32, arms, inv, distance)
    errors.record("cbca_two_rounds", "left f32 vs two cbca_round",
                  (twice32 - spare32).abs().max().item(), 0.0)
    del twice32, spare32
    extras += (
        ("cbca_two_rounds", "ms_f32", lambda: cbca_two_rounds_cuda(
            vol32, out32, arms, inv, distance)),
        ("cbca_two_rounds", "ms_f32_bf16_operands",
         lambda: cbca_two_rounds_cuda(vol32, out32, arms, inv, distance,
                                      torch.bfloat16)),
        ("cbca_rolling_round", "ms_f32", lambda: cbca_rolling_round_cuda(
            vol32, out32, arms, inv, distance)),
        ("cbca_rolling_round", "ms_f32_bf16_operands",
         lambda: cbca_rolling_round_cuda(vol32, out32, arms, inv, distance,
                                         torch.bfloat16)),
    )
    for name, key, fn in extras:
        times[name][key] = time_events(fn, 10)
        log(f"  {name:18s} {key:28s} {times[name][key]:.4f} ms")
    del codes
    # K7 without its lever is K2's f32 instantiation: the same walk with 256
    # threads and 16-row steps, on the same operands
    times["cbca_stencil_round"]["ms_without_lever"] = \
        times["cbca_round"]["ms_f32"]
    # every arm at the radius (a constant image): what the two single-pass
    # rounds take when the data does not cut the sums short (the scene's
    # arms are short); K2 equals K8 there too
    flat = compute_arms(torch.zeros_like(left), config.cbca_intensity,
                        distance)
    flat_inv = inverse_region_size(flat, distance).contiguous()
    spare = torch.empty_like(volume)
    cbca_round_cuda(volume, out, flat, flat_inv, distance)
    cbca_rolling_round_cuda(volume, spare, flat, flat_inv, distance)
    if not torch.equal(out, spare):
        raise AssertionError("cbca_round differs from cbca_rolling_round at "
                             "full arms")
    for name, fn in (("cbca_round", cbca_round_cuda),
                     ("cbca_rolling_round", cbca_rolling_round_cuda)):
        times[name]["ms_full_arms"] = time_events(
            lambda: fn(volume, spare, flat, flat_inv, distance), 10)
        log(f"  {name:18s} {'ms_full_arms':28s} "
            f"{times[name]['ms_full_arms']:.4f} ms")
    # K9 and K4 at full arms: a pass equals two K2 rounds, K4 its plain
    # version (tolerance 0.0); then their times
    twice = torch.empty_like(volume)
    cbca_two_rounds_cuda(volume, twice, flat, flat_inv, distance)
    cbca_round_cuda(volume, out, flat, flat_inv, distance)
    cbca_round_cuda(out, spare, flat, flat_inv, distance)
    errors.record("cbca_two_rounds", "left bf16, every arm at the radius",
                  (twice.float() - spare.float()).abs().max().item(), 0.0)
    cbca_round_int8_cuda(q_chunk, out8_chunk, flat, flat_inv, distance)
    want8 = cbca_round_int8_plain(q_chunk, flat, flat_inv, distance)
    errors.record("cbca_round_int8",
                  "left 128-lane chunk, every arm at the radius",
                  (out8_chunk.int() - want8.int()).abs().max().item(), 0.0)
    del want8
    for name, fn in (
            ("cbca_two_rounds", lambda: cbca_two_rounds_cuda(
                volume, twice, flat, flat_inv, distance)),
            ("cbca_round_int8", lambda: cbca_round_int8_cuda(
                q_chunk, out8_chunk, flat, flat_inv, distance))):
        times[name]["ms_full_arms"] = time_events(fn, 10)
        log(f"  {name:18s} {'ms_full_arms':28s} "
            f"{times[name]['ms_full_arms']:.4f} ms")
    del flat, flat_inv, spare, twice
    k2, k3 = times["cbca_round"], times["sgm_sweep"]
    log(f"  one CBCA round at {height} x {width} x {d_pad}: K2 bf16 "
        f"{k2['ms']:.4f}, f32 {k2['ms_f32']:.4f}, f32 with bf16 operands "
        f"{k2['ms_f32_bf16_operands']:.4f}, bf16 with every arm at the "
        f"radius {k2['ms_full_arms']:.4f} ms (this scene's arms sum to "
        f"{sum(a.float().mean().item() for a in arms):.3f} pixels per "
        f"pixel); K8 bf16 {times['cbca_rolling_round']['ms']:.4f} (f32 "
        f"{times['cbca_rolling_round']['ms_f32']:.4f}, f32 with bf16 "
        f"operands {times['cbca_rolling_round']['ms_f32_bf16_operands']:.4f}"
        f", every arm at the radius "
        f"{times['cbca_rolling_round']['ms_full_arms']:.4f}); K9 per "
        f"pass bf16 {times['cbca_two_rounds']['ms']:.4f}, f32 "
        f"{times['cbca_two_rounds']['ms_f32']:.4f}, f32 with bf16 operands "
        f"{times['cbca_two_rounds']['ms_f32_bf16_operands']:.4f}, every arm "
        f"at the radius {times['cbca_two_rounds']['ms_full_arms']:.4f}; K4 "
        f"per 128-lane launch {times['cbca_round_int8']['ms']:.4f}, every "
        f"arm at the radius {times['cbca_round_int8']['ms_full_arms']:.4f}"
        f" ms; K7 f32 "
        f"{times['cbca_stencil_round']['ms']:.4f} ms (without its lever "
        f"{k2['ms_f32']:.4f}); K10's floor at the tiling of K2 and K7 "
        f"{STREAM_TILES[walk_label]} {times['cbca_stream']['ms']:.4f} ms "
        f"(window traffic {times['cbca_stream']['window_bound_ms']:.4f}, "
        f"clone {times['cbca_stream']['library_ms']:.4f}; at the probe's "
        "default "
        f"{STREAM_DEFAULT_TILES} "
        f"{times['cbca_stream']['ms_at_default_tiles']:.4f}); K1 "
        f"per side bf16 {times['band_side']['ms']:.4f}, f32 left "
        f"{times['band_side']['ms_f32']:.4f}, right "
        f"{times['band_side']['ms_f32_right']:.4f} ms; K5 f32 "
        f"{times['band_pair']['ms']:.4f}, bf16 "
        f"{times['band_pair']['ms_bf16']:.4f} ms; K6 f32 out "
        f"{times['band_scores']['ms']:.4f}, bf16 out "
        f"{times['band_scores']['ms_bf16_out']:.4f} ms; K3 per sweep in place "
        f"{k3['ms']:.4f} (horizontal {k3['ms_horizontal']:.4f}, vertical "
        f"{k3['ms_vertical']:.4f}), out of place {k3['ms_out_of_place']:.4f},"
        f" f32 {k3['ms_f32']:.4f} ms")

    # bounds from this run's inputs. Operations: a band output in range is
    # 64 multiply-adds, and K5 and K6 compute each once for both bands (the
    # right band's (w - d, d) is the left band's (w, d)); a CBCA output adds
    # one value per arm pixel (this image's arms) and multiplies once; an
    # SGM output takes about 8 f32 operations. The rate is that of the
    # operands' type: K1's bf16 descriptors multiply on the tensor cores at
    # the bf16 rate, K5's f32 ones at the f32 rate (TF32 would change the
    # result); the f32 adds of K2, K7 and K3 at the f32 rate; K4's integer
    # adds at the int8 rate, on the 128-lane chunk it is launched on.
    elements = height * width * d_pad
    planes = height * width * (4 * 4 + 4)  # four arm maps and 1 / region
    band_flop = 2 * 64 * height * sum(width - d for d in range(ndisp))
    scores_flop = 2 * 64 * height * sum(width - d for d in range(d_pad))
    adds_per_lane = float(sum(a.sum().item() for a in arms) + height * width)
    arm_adds = d_pad * adds_per_lane
    chunk = height * width * chunk_lanes
    bounds = {
        "band_side": bound(2 * height * width * 64 * 2 + elements * 2,
                           band_flop, "bf16"),
        "band_pair": bound(2 * height * width * 64 * 4 + 2 * elements * 4,
                           band_flop, "f32"),
        "cbca_round": bound(2 * elements * 2 + planes, arm_adds, "f32"),
        "cbca_stencil_round": bound(2 * elements * 4 + planes, arm_adds,
                                    "f32"),
        "cbca_round_int8": bound(2 * chunk + planes,
                                 chunk_lanes * adds_per_lane, "int8"),
        "sgm_sweep": bound(2 * elements * 2 + 2 * height * width,
                           8 * elements, "f32"),
        # K8 and K9 read and write the bf16 volume once, K9 for two rounds
        # of sums; K6 multiplies on all d_pad lanes; K10 moves the padded
        # volume once each way
        "cbca_rolling_round": bound(2 * elements * 2 + planes, arm_adds,
                                    "f32"),
        "cbca_two_rounds": bound(2 * elements * 2 + planes, 2 * arm_adds,
                                 "f32"),
        "band_scores": bound(
            2 * height * width * 64 * 4 + 2 * elements * 4, scores_flop,
            "f32"),
        "cbca_stream": bound(2 * tiled.numel() * 2, 0, "f32"),
        "border_fill": fill_bound(height, ndisp, 2),
    }
    for name, (ms, by) in bounds.items():
        times[name].update(bound_ms=ms, bound_by=by)
        log(f"  {name:18s} bound {ms:.4f} ms by {by}: the kernel takes "
            f"{times[name]['ms'] / ms:.1f} x that")
    # the other routes: K1's f32 one on either side (path E: f32
    # descriptors in, an f32 band out, its multiply-adds at the f32 rate;
    # the right side's in-range outputs are as many as the left's), K8's
    # f32 one (path V4: the f32 volume read and written once, the sums as
    # in bf16), K5 in bf16 (bf16 descriptors in, bf16 bands out; its
    # multiply-adds are the f32 fmaf chain on the widened values, at the
    # f32 rate) and K6 with bf16 output
    for name, key, moved, work in (
            ("band_side", "f32",
             2 * height * width * 64 * 4 + elements * 4, band_flop),
            ("band_side", "f32_right",
             2 * height * width * 64 * 4 + elements * 4, band_flop),
            ("cbca_rolling_round", "f32", 2 * elements * 4 + planes,
             arm_adds),
            ("band_pair", "bf16",
             2 * height * width * 64 * 2 + 2 * elements * 2, band_flop),
            ("band_scores", "bf16_out",
             2 * height * width * 64 * 4 + 2 * elements * 2, scores_flop)):
        ms, by = bound(moved, work, "f32")
        times[name].update({f"bound_ms_{key}": ms, f"bound_by_{key}": by})
        log(f"  {name + ' ' + key:18s} bound {ms:.4f} ms by {by}: the "
            f"kernel takes {times[name]['ms_' + key] / ms:.1f} x that")
    return times


def profiled(fn):
    """Run ``fn`` under ``torch.profiler``; returns (wall ms, kernel ms,
    kernel events by self device time, the averages)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    # the attribute was self_cuda_time_total before torch 2.4
    key = ("self_device_time_total"
           if hasattr(averages[0], "self_device_time_total")
           else "self_cuda_time_total")
    # kernels only: an operator's row repeats the time of its kernels
    events = [e for e in averages if getattr(e, key) > 0
              and e.device_type == DeviceType.CUDA]
    device_ms = sum(getattr(e, key) for e in events) / 1e3
    events.sort(key=lambda e: -getattr(e, key))
    log(f"  wall {wall_ms:.1f} ms, kernels {device_ms:.1f} ms "
        f"(device busy {100 * device_ms / wall_ms:.1f}%)")
    for e in events[:12]:
        log(f"    {getattr(e, key) / 1e3:9.2f} ms  {e.count:6d}x  "
            f"{e.key[:90]}")
    return wall_ms, device_ms, averages.table(sort_by=key, row_limit=60)


def profile_pair(pipeline) -> None:
    """Device time by kernel over one main-path pair (torch.profiler)."""
    from mccnn_tpu_torch.pipeline.match import standardize_image
    from mccnn_tpu_torch.utils.scenes import make_scene

    scene = make_scene("slanted", np.random.default_rng(SEED + 2),
                       *MAIN_SHAPE, 150)
    left = standardize_image(scene["left"])
    right = standardize_image(scene["right"])
    _, _, table = profiled(
        lambda: pipeline.fetch(pipeline.dispatch(left, right, MAIN_NDISP)))
    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_pair.txt"), "w") as f:
        f.write(table)


def write_training_scenes(root: str) -> None:
    """Phase 8 (a): the synthetic training scenes at the main shape in the
    Middlebury layout (im0.png, im1.png, disp0GT.pfm with inf where a left
    pixel has no match, calib.txt) and their train.txt / val.txt."""
    from mccnn_tpu_torch.io.pfm import write_pfm
    from mccnn_tpu_torch.utils.scenes import make_scene

    height, width = MAIN_SHAPE
    rng = np.random.default_rng(SEED + 4)
    lefts = []
    for family in TRAIN_SCENES:
        scene = make_scene(family, rng, height, width, 150)
        directory = os.path.join(root, "data", family)
        os.makedirs(directory)
        write_png(scene["left"], os.path.join(directory, "im0.png"))
        write_png(scene["right"], os.path.join(directory, "im1.png"))
        gt = np.where(scene["occluded"], np.inf, scene["gt"]).astype(
            np.float32)
        write_pfm(gt, os.path.join(directory, "disp0GT.pfm"))
        with open(os.path.join(directory, "calib.txt"), "w") as f:
            f.write(f"width={width}\nheight={height}\nndisp={MAIN_NDISP}\n")
        lefts.append(os.path.join(directory, "im0.png"))
    for split in ("train", "val"):
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(lefts) + "\n")


def drive_training(device, launches, smi: str):
    """Phase 8: the training path at full width (the fast net, 5 x 64 maps,
    11 x 11 patches, ``TrainConfig()``: batch 128, margin 0.2, lr 0.002,
    beta 0.9). (a) two scenes at the main shape; (b) ``cli.train.main`` on
    the card, 3 epochs, native sampler, prefetch on; (c) 3 steps on the card
    against 3 on the CPU from one set of weights; (d) steps/s on a fixed
    batch and fed by the sampler through the prefetcher; (e) the last
    checkpoint served through ``MatchPipeline``. Returns (summary, the
    serving run's launch counts)."""
    import shutil

    import torch
    from mccnn_tpu_torch import native
    from mccnn_tpu_torch.cli import train as cli
    from mccnn_tpu_torch.data.dataset import StereoDataset, load_grayscale
    from mccnn_tpu_torch.data.prefetch import BatchPrefetcher
    from mccnn_tpu_torch.data.sampler import TripletSampler
    from mccnn_tpu_torch.models.net import (
        extract_features,
        init_params,
        l2_normalize,
        params_from_numpy,
        params_to_numpy,
    )
    from mccnn_tpu_torch.models.params import load_any
    from mccnn_tpu_torch.pipeline.match import MatchPipeline, standardize_image
    from mccnn_tpu_torch.pipeline.train import (
        batch_to_device,
        make_optimizer,
        make_train_step,
        momentum_to_numpy,
    )
    from mccnn_tpu_torch.utils.checkpoint import latest_checkpoint
    from mccnn_tpu_torch.utils.config import TrainConfig

    config = TrainConfig()
    root = os.path.join(ROOT, "build", "train_smoke")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    write_training_scenes(root)
    log(f"  (a) {len(TRAIN_SCENES)} scenes {MAIN_SHAPE[0]} x {MAIN_SHAPE[1]} "
        f"written in {time.perf_counter() - t0:.2f} s")

    # (b) the CLI on the card
    checkpoints = os.path.join(root, "ckpt")
    logs = os.path.join(root, "logs")
    t0 = time.perf_counter()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        cli.main(["--list_dir", root, "--tensorboard_dir", logs,
                  "--checkpoint_dir", checkpoints, "--end_epoch",
                  str(TRAIN_EPOCHS), "--print_freq", "1", "--sampler_backend",
                  "native", "--device", str(device), "--seed", str(SEED)])
    cli_seconds = time.perf_counter() - t0
    if not native.available():
        raise AssertionError("the native sampler library did not load")
    for epoch in range(1, TRAIN_EPOCHS + 1):
        path = os.path.join(checkpoints, f"model_epoch{epoch}.npz")
        if not os.path.exists(path):
            raise AssertionError(f"cli.train wrote no {path}")
    with open(os.path.join(logs, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    events = {r["event"] for r in records}
    if not {"start", "train", "checkpoint", "val"} <= events:
        raise AssertionError(f"metrics.jsonl holds the events {events}")
    cli_losses = [r["hinge_loss"] for r in records if r["event"] == "train"]
    val_losses = [r["val_hinge_loss"] for r in records if r["event"] == "val"]
    if not np.isfinite(cli_losses + val_losses).all():
        raise AssertionError(f"non-finite CLI losses {cli_losses}")
    log(f"  (b) cli.train on {device}: {TRAIN_EPOCHS} epochs of "
        f"{len(TRAIN_SCENES)} steps in {cli_seconds:.2f} s (dataset load "
        f"included), model_epoch1..{TRAIN_EPOCHS}.npz and events "
        f"{sorted(events)}; losses {[round(x, 4) for x in cli_losses]}, val "
        f"{[round(x, 4) for x in val_losses]}")

    # (c) the card against the CPU on the same three sampler batches
    params = init_params(SEED)
    lists = os.path.join(root, "train.txt")
    sampler = TripletSampler(StereoDataset(lists, shuffle=True, seed=SEED),
                             seed=SEED, backend="native")
    batches = [sampler.next_batch(config.batch_size) for _ in range(3)]

    def steps_on(where):
        net = params_from_numpy(params).to(where)
        optimizer = make_optimizer(config, net)
        step = make_train_step(config, net, optimizer)
        losses = [float(step(batch_to_device(b, where))) for b in batches]
        return losses, params_to_numpy(net), momentum_to_numpy(net, optimizer)

    card, cpu = steps_on(device), steps_on("cpu")
    if (torch.backends.cudnn.allow_tf32
            or torch.backends.cuda.matmul.allow_tf32):
        raise AssertionError("TF32 is on for the train step")
    loss_err = max(abs(a - b) for a, b in zip(card[0], cpu[0]))
    errors = {"loss": loss_err}
    for what, index in (("params", 1), ("momentum", 2)):
        worst = 0.0
        for name, layer in cpu[index].items():
            for kind, want in layer.items():
                err = float(np.abs(card[index][name][kind] - want).max())
                scale = float(np.abs(want).max())
                worst = max(worst, err / scale)
                if not err <= TRAIN_REL_TOL * scale:
                    raise AssertionError(
                        f"{what} {name}/{kind}: card and CPU {err} apart at "
                        f"a scale of {scale}")
        errors[what] = worst
    log(f"  (c) 3 steps, card against CPU: losses {card[0]} / {cpu[0]}, "
        f"max |diff| {loss_err:.3e} (tol {TRAIN_LOSS_TOL:.0e}); largest "
        f"|diff| / max |leaf| over the 10 params {errors['params']:.3e}, "
        f"over the 10 momentum traces {errors['momentum']:.3e} (tol "
        f"{TRAIN_REL_TOL:.0e})")
    if not loss_err <= TRAIN_LOSS_TOL:
        raise AssertionError(f"card and CPU losses {loss_err} apart")

    # (d) steps/s: a fixed batch with no host sync between steps, then fed
    # by the sampler through the prefetcher
    net = params_from_numpy(params).to(device)
    step = make_train_step(config, net)
    fixed = batch_to_device(batches[0], device)
    for _ in range(5):  # first use: cuDNN's choices, the allocator
        step(fixed)
    torch.cuda.synchronize()
    # the fixed-batch rate is a device rate only if no step waits for it
    syncs = synchronizing_calls(lambda: step(fixed))
    log(f"  synchronizing calls in one train step: {len(syncs)}")
    if syncs:
        raise AssertionError(f"the train step synchronized: {syncs[:3]}")
    net = params_from_numpy(params).to(device)
    step = make_train_step(config, net)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = torch.stack([step(fixed) for _ in range(TRAIN_STEPS)])
    torch.cuda.synchronize()
    fixed_rate = TRAIN_STEPS / (time.perf_counter() - t0)
    losses = losses.cpu().numpy()
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"fixed-batch loss {losses[0]} -> {losses[-1]}")
    log(f"  (d) fixed batch: {fixed_rate:.1f} steps/s over {TRAIN_STEPS} "
        f"steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}; {smi}")
    _, kernel_ms, table = profiled(lambda: [step(fixed) for _ in range(20)])
    with open(os.path.join(ROOT, "build", "profile_train.txt"), "w") as f:
        f.write(table)

    sampler = TripletSampler(StereoDataset(lists, shuffle=True, seed=SEED),
                             seed=SEED, backend="native")
    t0 = time.perf_counter()
    for _ in range(50):
        sampler.next_batch(config.batch_size)
    sample_ms = (time.perf_counter() - t0) * 1e3 / 50
    t0 = time.perf_counter()
    for _ in range(50):
        batch_to_device(batches[0], device)
    torch.cuda.synchronize()
    copy_ms = (time.perf_counter() - t0) * 1e3 / 50
    net = params_from_numpy(params).to(device)
    step = make_train_step(config, net)
    sampler.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with BatchPrefetcher(sampler, config.batch_size,
                         epoch_len=TRAIN_STEPS) as feed:
        fed = torch.stack([
            step(batch_to_device(feed.next_batch(), device))
            for _ in range(TRAIN_STEPS)])
        torch.cuda.synchronize()
    fed_rate = TRAIN_STEPS / (time.perf_counter() - t0)
    # the same without the prefetch thread (--prefetch_batches 0): the
    # host samples, copies and steps in turn
    sampler.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fed = torch.stack([fed, torch.stack([
        step(batch_to_device(sampler.next_batch(config.batch_size), device))
        for _ in range(TRAIN_STEPS)])])
    torch.cuda.synchronize()
    sync_rate = TRAIN_STEPS / (time.perf_counter() - t0)
    if not bool(torch.isfinite(fed).all()):
        raise AssertionError("non-finite loss in the fed runs")
    log(f"  (d) fed by the native sampler through the prefetcher: "
        f"{fed_rate:.1f} steps/s over {TRAIN_STEPS} steps; without the "
        f"prefetch thread {sync_rate:.1f} (sampler alone {sample_ms:.3f} ms "
        f"a batch, host-to-card copy {copy_ms:.3f} ms); {smi}")

    # (e) serve the last checkpoint on the card
    path = latest_checkpoint(checkpoints)
    pipeline = MatchPipeline(load_any(path), volume_dtype="bfloat16",
                             bucket=8, device=device)
    scene_dir = os.path.join(root, "data", TRAIN_SCENES[0])
    left, right = (standardize_image(load_grayscale(
        os.path.join(scene_dir, name))) for name in ("im0.png", "im1.png"))
    pipeline(left, right, MAIN_NDISP)  # first use of these weights
    torch.cuda.synchronize()
    launches.reset()
    t0 = time.perf_counter()
    disparity = pipeline(left, right, MAIN_NDISP)
    serve_seconds = time.perf_counter() - t0
    counts = launches.snapshot()
    check_counts("trained serve", counts)
    if disparity.shape != MAIN_SHAPE or not np.isfinite(disparity).all():
        raise AssertionError("the trained weights served a bad disparity")
    # the ReLU written as max(x, 0) gives F.relu's features bit for bit
    image = pipeline._to_device(left)
    with torch.no_grad():
        x = torch.nn.functional.pad(image, (pipeline.net.pad,) * 4)[None, None]
        for i, conv in enumerate(pipeline.net.convs):
            x = conv(x)
            if i < len(pipeline.net.convs) - 1:
                x = torch.nn.functional.relu(x)
        relu_features = l2_normalize(x[0].permute(1, 2, 0), dim=-1)
        equal = torch.equal(extract_features(pipeline.net, image),
                            relu_features)
    if not equal:
        raise AssertionError("serving features differ from an F.relu forward")
    log(f"  (e) {os.path.basename(path)} served through MatchPipeline: "
        f"{serve_seconds:.4f} s/pair, launches "
        f"{ {k: v for k, v in counts.items() if v} }, finite; features equal "
        "an F.relu forward bit for bit")
    summary = {
        "net": "fast, 5 x 3x3 convs, 64 maps, 11 x 11 patches",
        "batch": config.batch_size, "card": smi,
        "fixed_batch_steps_per_s": fixed_rate,
        "fed_steps_per_s": fed_rate, "fed_sync_steps_per_s": sync_rate,
        "fixed_batch_loss": [float(losses[0]), float(losses[-1])],
        "kernel_ms_per_step": kernel_ms / 20,
        "sampler_ms_per_batch": sample_ms, "copy_ms_per_batch": copy_ms,
        "card_vs_cpu": errors, "cli_seconds": cli_seconds,
    }
    return summary, counts


def drive_quality(device, launches, smi: str):
    """Phase 9: the quality loop. (a) ``tools.train_fullscale`` for
    ``QUALITY_EPOCHS`` epochs (15 scenes, 3,000 steps), then its two
    evaluations (trained and random init, five families, fast schedule) at
    the main shape, ndisp 162; (b) ``tools.eval_fullscale`` on the first
    family with the exact cross-check; (c) ``tools.parity_eval`` on the
    card against the oracle chain. Returns (summary, launch counts by
    path)."""
    import shutil

    from mccnn_tpu_torch.tools import eval_fullscale, parity_eval
    from mccnn_tpu_torch.tools import train_fullscale

    counts = {}
    root = os.path.join(ROOT, "build", "quality")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    launches.reset()
    out = train_fullscale.run([
        "--epochs", str(QUALITY_EPOCHS), "--out", root, "--noise",
        str(QUALITY_NOISE), "--device", str(device)])
    counts["quality train_fullscale"] = launches.snapshot()
    seconds = {"train_fullscale": time.perf_counter() - t0}
    check_counts("quality train_fullscale", counts["quality train_fullscale"],
                 2 * len(eval_fullscale.FAMILIES))
    trained = out["results"]["self-trained"]["results"]
    random_init = out["results"]["random-init"]["results"]
    for row in trained + random_init:
        if row["nonfinite"]:
            raise AssertionError(f"{row['family']}: {row['nonfinite']} "
                                 "non-finite pixels")
    table = {mine["family"]: (mine["bad_2.0"], theirs["bad_2.0"])
             for mine, theirs in zip(trained, random_init)}
    for family, (mine, theirs) in table.items():
        if not mine <= theirs + QUALITY_BUDGET:
            raise AssertionError(f"{family}: trained bad-2.0 {mine} is worse "
                                 f"than random init's {theirs}")
    log(f"  (a) train_fullscale: {out['steps']} steps at "
        f"{out['steps_per_s']:.1f} steps/s ({out['train_seconds']:.1f} s with "
        f"the scenes' load), then 2 x {len(table)} pairs; {smi}")

    # (b) the exact cross-check on the first family, with the trained weights
    ckpt = os.path.join(root, "ckpt", f"model_epoch{QUALITY_EPOCHS}.npz")
    t0 = time.perf_counter()
    launches.reset()
    result = eval_fullscale.main([
        "--weights", ckpt, "--families", eval_fullscale.FAMILIES[0],
        "--noise", str(QUALITY_NOISE), "--device", str(device)])
    counts["quality eval_fullscale"] = launches.snapshot()
    seconds["eval_fullscale"] = time.perf_counter() - t0
    check_counts("quality eval_fullscale", counts["quality eval_fullscale"])
    fast, exact = result["results"]
    if fast["nonfinite"] or exact["nonfinite"]:
        raise AssertionError(f"non-finite pixels: {result['results']}")
    delta = abs(fast["bad_2.0"] - exact["bad_2.0"])
    if not delta <= QUALITY_BUDGET:
        raise AssertionError(f"fast and exact bad-2.0 {delta} apart")
    log(f"  (b) eval_fullscale {fast['family']}: fast {fast['bad_2.0']:.4f}, "
        f"exact {exact['bad_2.0']:.4f}, |delta| {delta:.4f} (budget "
        f"{QUALITY_BUDGET}); the fast pair in (a) {table[fast['family']][0]:.4f}"
        f"; launches {counts['quality eval_fullscale']}: the exact pair "
        "K1 0, K2 36, K3 8 beside the fast pair's K1 2, K2 36, K3 8")

    # (c) the port on the card against the oracle chain on the host
    t0 = time.perf_counter()
    launches.reset()
    parity = parity_eval.run(str(device), log=lambda line: log("    " + line))
    counts["quality parity_eval"] = launches.snapshot()
    seconds["parity_eval"] = time.perf_counter() - t0
    check_counts("quality parity_eval", counts["quality parity_eval"],
                 len(parity))
    worst = max(parity_eval.worst_delta(scores) for scores in parity.values())
    if not worst <= parity_eval.BUDGET:
        raise AssertionError(f"parity_eval: bad-2.0 {worst} from the oracle")
    log(f"  (c) parity_eval on {device}: {len(parity)} scenes, max |bad-2.0 "
        f"delta| to the oracle chain {worst:.4f} (budget {parity_eval.BUDGET})")
    summary = {
        "steps": out["steps"], "steps_per_s": out["steps_per_s"],
        "train_seconds": out["train_seconds"],
        "photo_source": result["photo_source"],
        "bad_2.0 trained, random init": table,
        "fast_vs_exact": delta, "parity_worst": worst, "seconds": seconds,
        "card": smi,
    }
    return summary, counts


def drive_sharded(device, smi: str):
    """Phase 10: ``parallel/`` on two ranks that share the card over gloo.
    (a) ``make_sharded_match`` (``tools/multichip_midscale.py``, one spawn)
    at the main shape on the serving (bf16, fused: K1, K2, K3), exact (f32,
    pallas: K7) and fused8 (K4, bit-equal) schedules, and fused2 (K9 with
    odd rounds) and rolling (K8) at the middle shape, each against the
    unsharded ``match_pair`` on the same card; (b) the data-parallel step
    on two ranks against the single-process step; (c) ``cli.train
    --data_parallel`` (NCCL, one rank) against the plain CLI; (d)
    ``cli.match --multihost`` in two processes over three scenes. Returns
    {path: rank 0's launch counts}."""
    import shutil

    import torch
    from mccnn_tpu_torch.cli import train as train_cli
    from mccnn_tpu_torch.data.dataset import StereoDataset
    from mccnn_tpu_torch.data.sampler import TripletSampler
    from mccnn_tpu_torch.io.pfm import read_pfm
    from mccnn_tpu_torch.models.net import (
        init_params,
        params_from_numpy,
        params_to_numpy,
    )
    from mccnn_tpu_torch.models.params import save_params
    from mccnn_tpu_torch.parallel.launch import run_ranks
    from mccnn_tpu_torch.pipeline.train import (
        batch_to_device,
        make_optimizer,
        make_train_step,
        momentum_to_numpy,
    )
    from mccnn_tpu_torch.tools import multichip_midscale as midscale
    from mccnn_tpu_torch.tools import multiprocess_bringup as bringup
    from mccnn_tpu_torch.utils.config import MatchConfig, TrainConfig
    from mccnn_tpu_torch.utils.scenes import make_scene

    backend = "gloo"
    log(f"  {SHARDED_RANKS} ranks on {device} over backend={backend!r} "
        "(chosen here: NCCL takes one rank per card)")
    odd = MatchConfig(cbca_num_iterations_1=SHARDED_ODD_ROUNDS[0],
                      cbca_num_iterations_2=SHARDED_ODD_ROUNDS[1])
    runs = [  # (path, job)
        ("sharded fused (per rank)", midscale.job(
            *MAIN_SHAPE, MAIN_NDISP, volume_dtype="bfloat16",
            cbca_impl="fused", pairs=2, seed=SEED)),
        ("sharded exact-f32 (per rank)", midscale.job(
            *MAIN_SHAPE, MAIN_NDISP, volume_dtype="float32",
            cbca_impl="pallas", seed=SEED)),
        ("sharded fused8 (per rank)", midscale.job(
            *MAIN_SHAPE, MAIN_NDISP, volume_dtype="bfloat16",
            cbca_impl="fused8", seed=SEED)),
        ("sharded fused2 (per rank)", midscale.job(
            *MIDDLE_SHAPE, 64, odd, volume_dtype="bfloat16",
            cbca_impl="fused2", seed=SEED)),
        ("sharded rolling (per rank)", midscale.job(
            *MIDDLE_SHAPE, 64, volume_dtype="bfloat16", cbca_impl="rolling",
            seed=SEED)),
        # no CBCA hook with "xla": each rank runs cbca_joint on its block
        ("sharded joint (per rank)", midscale.job(
            *MIDDLE_SHAPE, 64, MatchConfig(cbca_joint_regions=True,
                                           cbca_num_iterations_1=1,
                                           cbca_num_iterations_2=2),
            volume_dtype="float32", cbca_impl="xla", seed=SEED)),
    ]
    t0 = time.perf_counter()
    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    results = midscale.run([job for _, job in runs], SHARDED_RANKS,
                           str(device), backend, timeout_s=900.0)
    log(f"  (a) one spawn of {SHARDED_RANKS} ranks, {len(runs)} schedules: "
        f"{time.perf_counter() - t0:.1f} s")
    counts = {}
    summary = {}
    for (path, job), per_rank in zip(runs, results):
        impl, dtype = job["cbca_impl"], job["volume_dtype"]
        shape = job["left"].shape
        log(f"  {path}: {shape[0]} x {shape[1]}, ndisp {job['ndisp']}, "
            f"{dtype}, cbca_impl {impl}")
        for r in per_rank:
            traffic = r["traffic"]
            log(f"    rank {r['rank']} ({r['device']}, {r['backend']}): "
                f"pre-WTA max |diff| left {r['left_volume']['max_abs_diff']:.3e}"
                f" right {r['right_volume']['max_abs_diff']:.3e} (tol "
                f"{r['left_volume']['tol']:.3e}, bit-equal "
                f"{r['left_volume']['bit_equal'] and r['right_volume']['bit_equal']})"
                f"; sharded CBCA stage {r['cbca']['max_abs_diff']:.3e}; WTA "
                f"differing pixels L {r['left_disparity_differing']} R "
                f"{r['right_disparity_differing']}; bad-2.0 {r['bad2']:.4f} "
                f"(delta {r['bad2_delta']:.4f}); disparity max |diff| "
                f"{r['disparity_max_abs_diff']:.3e}")
            log(f"      launches {({k: v for k, v in r['launches'].items() if v})}"
                f"; halo {traffic.get('halo', 0) / 1e6:.1f} MB in "
                f"{traffic.get('halo_s', 0.0):.3f} s, reshard "
                f"{traffic.get('reshard', 0) / 1e6:.1f} MB in "
                f"{traffic.get('reshard_s', 0.0):.3f} s, gather "
                f"{traffic.get('gather', 0) / 1e6:.3f} MB in "
                f"{traffic.get('gather_s', 0.0):.3f} s, reduce "
                f"{traffic.get('reduce', 0)} B; a pair's peak "
                f"{r['peak_gb']:.2f} GB (unsharded "
                f"{r['plain_peak_gb']:.2f} GB); "
                f"{r['s_per_pair']:.4f} s/pair (unsharded "
                f"{r['plain_s_per_pair']:.4f} s/pair alone on the card)")
            bad = midscale.failures(r, exact=impl == "fused8")
            if bad:
                raise AssertionError(f"{path} rank {r['rank']}: {bad}")
            check_counts(path, r["launches"])
        counts[path] = per_rank[0]["launches"]
        summary[path] = [{k: r[k] for k in (
            "s_per_pair", "plain_s_per_pair", "peak_gb", "plain_peak_gb",
            "traffic", "bad2_delta", "left_disparity_differing",
            "right_disparity_differing")} for r in per_rank]
    log(f"  {smi}")

    # (b) the DP step on two ranks against one process, on the card
    config = TrainConfig()
    root = os.path.join(ROOT, "build", "train_smoke")
    lists = os.path.join(root, "train.txt")
    sampler = TripletSampler(StereoDataset(lists, shuffle=True, seed=SEED),
                             seed=SEED)
    batches = [sampler.next_batch(config.batch_size) for _ in range(3)]
    params = init_params(SEED)
    t0 = time.perf_counter()
    dp = run_ranks(bringup.dp_steps, SHARDED_RANKS, params, batches, config,
                   device=str(device), backend=backend, timeout_s=300.0)
    dp_seconds = time.perf_counter() - t0
    net = params_from_numpy(params).to(device)
    optimizer = make_optimizer(config, net)
    step = make_train_step(config, net, optimizer)
    losses = [float(step(batch_to_device(b, device))) for b in batches]
    single = {"params": params_to_numpy(net),
              "momentum": momentum_to_numpy(net, optimizer)}
    for tree in ("params_by_step", "momentum"):
        np.testing.assert_equal(dp[1][tree], dp[0][tree])
    if dp[0]["losses"] != dp[1]["losses"]:
        raise AssertionError("the DP replicas' losses differ")
    loss_err = max(abs(a - b) for a, b in zip(dp[0]["losses"], losses))
    worst = leaf_errors(dp[0], single)
    log(f"  (b) DP step, {SHARDED_RANKS} ranks x {config.batch_size // SHARDED_RANKS}"
        f" of batch {config.batch_size}, 3 steps in {dp_seconds:.1f} s (spawn "
        f"included): losses {dp[0]['losses']} / one process {losses}, max "
        f"|diff| {loss_err:.3e} (tol {TRAIN_LOSS_TOL:.0e}); largest |diff| / "
        f"max |leaf| params {worst['params']:.3e}, momentum "
        f"{worst['momentum']:.3e} (tol {TRAIN_REL_TOL:.0e}); replicas "
        "bit-identical")
    if not loss_err <= TRAIN_LOSS_TOL:
        raise AssertionError(f"DP and single losses {loss_err} apart")

    # (c) cli.train --data_parallel (NCCL, world size 1) against the plain
    # CLI, one epoch from the same seed
    weights = os.path.join(root, "dp_weights.npz")
    save_params(params, weights)
    runs_dir = {}
    for tag, extra in (("plain", []), ("dp", ["--data_parallel"])):
        out = os.path.join(root, f"cli_{tag}")
        shutil.rmtree(out, ignore_errors=True)
        with contextlib.redirect_stdout(io.StringIO()):
            train_cli.main(["--list_dir", root, "--tensorboard_dir", out,
                            "--checkpoint_dir", out, "--end_epoch", "1",
                            "--print_freq", "1", "--resume", weights,
                            "--seed", str(SEED), "--device", str(device),
                            *extra])
        runs_dir[tag] = out
    trees = {}
    records = {}
    for tag, out in runs_dir.items():
        with np.load(os.path.join(out, "model_epoch1.npz")) as f:
            trees[tag] = {key: f[key] for key in f.files
                          if f[key].dtype.kind == "f"}
        with open(os.path.join(out, "metrics.jsonl")) as f:
            records[tag] = [json.loads(line) for line in f]
    start = [r for r in records["dp"] if r["event"] == "start"][0]
    nccl = "nccl" if device.type == "cuda" else "gloo"
    if (start.get("backend"), start["devices"]) != (nccl, 1):
        raise AssertionError(f"--data_parallel started {start}")
    cli_losses = {tag: [r["hinge_loss"] for r in recs
                        if r["event"] == "train"]
                  for tag, recs in records.items()}
    cli_loss_err = max(abs(a - b) for a, b in zip(cli_losses["dp"],
                                                  cli_losses["plain"]))
    cli_worst = 0.0
    for key, want in trees["plain"].items():
        err = float(np.abs(trees["dp"][key] - want).max())
        scale = float(np.abs(want).max())
        cli_worst = max(cli_worst, err / scale)
        if not err <= TRAIN_REL_TOL * scale:
            raise AssertionError(f"--data_parallel {key}: {err} from the "
                                 f"plain CLI at a scale of {scale}")
    log(f"  (c) cli.train --data_parallel: backend {start['backend']}, "
        f"{start['devices']} rank; losses {cli_losses['dp']} / plain "
        f"{cli_losses['plain']}, max |diff| {cli_loss_err:.3e}; largest "
        f"|diff| / max |leaf| over model_epoch1.npz {cli_worst:.3e} (tol "
        f"{TRAIN_REL_TOL:.0e})")
    if not cli_loss_err <= TRAIN_LOSS_TOL:
        raise AssertionError(f"--data_parallel losses {cli_loss_err} apart")

    # (d) cli.match --multihost: two processes, three scenes
    height, width = MIDDLE_SHAPE
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        rng = np.random.default_rng(SEED + 10)
        lefts = []
        for i in range(MULTIHOST_SCENES):
            scene = make_scene("slanted", rng, height, width, 48)
            directory = os.path.join(tmp, "data", f"scene{i}")
            os.makedirs(directory)
            write_png(scene["left"], os.path.join(directory, "im0.png"))
            write_png(scene["right"], os.path.join(directory, "im1.png"))
            with open(os.path.join(directory, "calib.txt"), "w") as f:
                f.write(f"width={width}\nheight={height}\nndisp=64\n")
            lefts.append(os.path.join(directory, "im0.png"))
        with open(os.path.join(tmp, "list.txt"), "w") as f:
            f.write("\n".join(lefts) + "\n")
        save_params(params, os.path.join(tmp, "w.npz"))
        argv = [sys.executable, "-m", "mccnn_tpu_torch.cli.match",
                "--list_file", os.path.join(tmp, "list.txt"), "--resume",
                os.path.join(tmp, "w.npz"), "--data_dir",
                os.path.join(tmp, "data"), "--save_dir",
                os.path.join(tmp, "out"), "-t", "mh", "-s", "0", "-e",
                str(MULTIHOST_SCENES - 1), "--volume_dtype", "bfloat16",
                "--device", str(device), "--multihost"]
        t0 = time.perf_counter()
        ranks = [subprocess.Popen(
            argv, cwd=ROOT, env={**os.environ, "RANK": str(rank),
                                 "WORLD_SIZE": str(SHARDED_RANKS)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(SHARDED_RANKS)]
        try:
            outputs = [proc.communicate(timeout=300)[0] for proc in ranks]
        finally:
            for proc in ranks:
                proc.kill()
        seconds = time.perf_counter() - t0
        if any(proc.returncode for proc in ranks):
            raise AssertionError(f"cli.match --multihost failed: {outputs}")
        owners = {}
        for rank, text in enumerate(outputs):
            for line in text.splitlines():
                if "event=scene" in line:
                    index = int(line.split("index=")[1].split()[0])
                    if index in owners:
                        raise AssertionError(f"scene {index} matched twice")
                    owners[index] = rank
        want = {i: i % SHARDED_RANKS for i in range(MULTIHOST_SCENES)}
        if owners != want:
            raise AssertionError(f"scene owners {owners}, want {want}")
        for i in range(MULTIHOST_SCENES):
            disparity = read_pfm(os.path.join(
                tmp, "out", "submit_mh", f"scene{i}", "disp0MCCNN.pfm"))
            if disparity.shape != MIDDLE_SHAPE or not np.isfinite(
                    disparity).all():
                raise AssertionError(f"scene{i}: bad disparity")
    log(f"  (d) cli.match --multihost, {SHARDED_RANKS} processes with RANK / "
        f"WORLD_SIZE, {MULTIHOST_SCENES} scenes {height} x {width}: owners "
        f"{owners}, each written once, finite; {seconds:.1f} s")
    summary["dp"] = {"loss_err": loss_err, **worst,
                     "cli_loss_err": cli_loss_err, "cli_rel_err": cli_worst}
    return counts, summary


def full_pair(device):
    """The full config's ``init_params(0)`` net and its 2000 x 3072 pair on
    the card, as ``bench.bench_full`` makes them."""
    import torch
    from mccnn_tpu_torch import bench
    from mccnn_tpu_torch.models.net import init_params, params_from_numpy

    net = params_from_numpy(init_params(0)).to(device)
    height, width, _ = bench.FULL_SHAPE
    left, right = (torch.from_numpy(x).to(device)
                   for x in bench.bench_pair(height, width))
    return net, left, right


def full_depth_kernels(device, errors: Errors) -> None:
    """Phase 11 (b): K1, K2 and K3 as the full config launches them, at
    ndisp 400 and D_pad 512, on rows ``FULL_STRIP`` of its pair, against
    their plain versions with phase 7's tolerances: K1 on both sides in
    bf16 (four disparity blocks of 128) on those rows of the whole image's
    bf16 descriptors, and in f32 on their f32 descriptors (also against
    K5 f32, bit for bit); K2 through ``_run_cbca`` on the schedule's 256-lane
    chunks, copied out and back, which must also equal one launch over the
    whole depth bit for bit; K3 in place on K2's output in bf16 (its ring
    at its shallowest), every direction."""
    import torch
    from mccnn_tpu_torch import bench
    from mccnn_tpu_torch.models.net import extract_features
    from mccnn_tpu_torch.ops.cbca import (
        cbca_round,
        compute_arms,
        inverse_region_size,
    )
    from mccnn_tpu_torch.ops.cbca_fused import cbca_fused
    from mccnn_tpu_torch.ops.common import pad_disparities
    from mccnn_tpu_torch.ops.cost_volume import (
        band_pair,
        band_side,
        band_side_plain,
    )
    from mccnn_tpu_torch.ops.sgm import _DIRECTIONS, sweep_cuda, sweep_plain
    from mccnn_tpu_torch.pipeline.match import _run_cbca
    from mccnn_tpu_torch.utils.config import MatchConfig

    config = MatchConfig()
    distance = config.cbca_distance
    ndisp = bench.FULL_SHAPE[2]
    d_pad, dtype = pad_disparities(ndisp), torch.bfloat16
    chunk = bench.full_schedule()["cbca_chunk_d"]
    rows = slice(*FULL_STRIP)
    net, left, right = full_pair(device)
    with torch.no_grad():
        fl32, fr32 = (extract_features(net, image)[rows].contiguous()
                      for image in (left, right))
    left, right = left[rows].contiguous(), right[rows].contiguous()
    del net
    # K1's f32 route on those rows' f32 descriptors: against its plain
    # version, and the two sides against K5 f32 bit for bit
    pair32 = band_pair(fl32, fr32, ndisp, d_pad, torch.float32)
    for side, k5, (anchor, other) in zip(("left", "right"), pair32,
                                         ((fl32, fr32), (fr32, fl32))):
        got = band_side(anchor, other, ndisp, d_pad, side, torch.float32)
        compare_side_f32(errors, ndisp, f"{side} D_pad {d_pad} f32", got,
                         band_side_plain(anchor, other, ndisp, d_pad, side,
                                         torch.float32))
        if not torch.equal(got, k5):
            raise AssertionError(f"band_pair {side} D_pad {d_pad} f32: "
                                 "differs from band_side")
    del pair32, got, k5
    fl, fr = fl32.to(dtype), fr32.to(dtype)
    del fl32, fr32
    sides = {"left": (fl, fr, left, "L"), "right": (fr, fl, right, "R")}
    for side, (anchor, other, image, choice) in sides.items():
        what = f"{side} D_pad {d_pad}"
        # one bf16 ulp at the largest cost, as K3's tolerance: 2^-8 while
        # every |cost| < 1, as phase 7's; bf16 descriptors of one image
        # shifted can match to 1 and past it
        volume = band_side(anchor, other, ndisp, d_pad, side, dtype)
        want = band_side_plain(anchor, other, ndisp, d_pad, side, dtype)
        top = want[..., :ndisp].float().abs().max().item()
        compare_costs(errors, ndisp, "band_side", what, volume, want,
                      bf16_ulp(top))
        del want
        arms = compute_arms(image, config.cbca_intensity, distance)
        inv = inverse_region_size(arms, distance).contiguous()
        chunked = _run_cbca(cbca_fused, volume.clone(), arms, 1, distance,
                            chunk)
        compare_costs(errors, ndisp, "cbca_round",
                      f"{what}, {chunk}-lane chunks", chunked,
                      cbca_round(volume, arms, inv, distance), 2.0 ** -8)
        if not torch.equal(chunked, cbca_fused(volume, arms, 1, distance)):
            raise AssertionError(f"cbca_round {what}: the {chunk}-lane "
                                 "chunks differ from one launch")
        del volume
        for direction in _DIRECTIONS:
            want = torch.empty_like(chunked)
            sweep_plain(chunked, want, left, right, choice, direction,
                        config)
            got = chunked.clone()
            sweep_cuda(got, got, left, right, choice, direction, config)
            top = want[..., :ndisp].float().abs().max().item()
            compare_costs(errors, ndisp, "sgm_sweep",
                          f"{what} dir {direction} in place", got, want,
                          2 * bf16_ulp(top))
        del chunked, got, want
    torch.cuda.synchronize()


def profile_full_pair(device) -> None:
    """Device time by kernel over one pair of the full config
    (torch.profiler; the table in ``build/profile_full.txt``), and the
    chunk copies of ``_run_cbca`` timed alone (CUDA events), which the
    table counts under ``aten::copy_`` with every other copy: each of a
    pair's 2 volumes x 2 CBCA stages copies each 256-lane chunk of D_pad
    512 out and back once."""
    import torch
    from mccnn_tpu_torch import bench
    from mccnn_tpu_torch.ops.common import pad_disparities

    net, left, right = full_pair(device)
    height, width, ndisp = bench.FULL_SHAPE
    schedule = bench.full_schedule()
    fn = bench.matcher(net, ndisp, schedule)
    fn(left, right)
    _, _, table = profiled(lambda: fn(left, right))
    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_full.txt"), "w") as f:
        f.write(table)
    del net, fn
    d_pad, chunk = pad_disparities(ndisp), schedule["cbca_chunk_d"]
    volume = torch.zeros((height, width, d_pad), dtype=torch.bfloat16,
                         device=device)
    block = volume[:, :, :chunk].contiguous()
    out_ms = time_events(lambda: volume[:, :, :chunk].contiguous(), 5)
    back_ms = time_events(lambda: volume[:, :, :chunk].copy_(block), 5)
    copies = 2 * 2 * d_pad // chunk
    log(f"  chunk copies alone: out {out_ms:.4f} ms, back {back_ms:.4f} ms"
        f" ({block.numel() * 2 / 1e9:.2f} GB each); a pair's {copies} + "
        f"{copies}: {copies * (out_ms + back_ms):.1f} ms")


def drive_bench(device, smi: str, errors: Errors):
    """Phase 11: the port's bench entry points in this process, as a user
    runs them: ``bench``'s half, halfexact, quarter, full and train configs
    (each config's launches in one pair against ``PER_PAIR``, K1, K2 and
    K8 against their plain versions within the JAX bench's limits, finite
    disparities), the full config's kernels against their plain versions
    (``full_depth_kernels``) and a profile of one of its pairs,
    ``tools.bench_serve`` with ``BENCH_SERVE_SCENES`` scenes
    at the main shape for the pipelined and the sync client (every scene
    answered and written), ``tools.profile_pipeline`` at the main shape,
    ``tools.profile_fullres`` at 2000 x 3072, ndisp 400, and
    ``tools.warmup`` in a process of its own on the serve bench's scene
    list. Every record must name this card. Returns ({path: launches},
    [records])."""
    import torch
    from mccnn_tpu_torch import bench
    from mccnn_tpu_torch.tools import (
        bench_serve,
        profile_fullres,
        profile_pipeline,
    )

    counts, records = {}, []

    def quiet(fn, *args, **kwargs):
        """Run an entry point with its JSON line kept for the summary."""
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            record = fn(*args, **kwargs)
        lines = [line for line in out.getvalue().splitlines()
                 if line.startswith("{")]
        if len(lines) != 1 or json.loads(lines[0]) != json.loads(
                json.dumps(record)):
            raise AssertionError(f"{fn.__module__}: {len(lines)} JSON lines")
        if record["device"] != smi:
            raise AssertionError(f"record of {record['device']!r}")
        records.append(record)
        return record, time.perf_counter() - t0

    for config in BENCH_CONFIGS:
        torch.cuda.empty_cache()
        record, seconds = quiet(bench.CONFIGS[config], device=str(device))
        if config == "train":
            log(f"  train: {record['value']:.1f} steps/s at batch 128 (s a "
                f"step {record['samples_s']} after {record['warmup_steps']}"
                f" steps), loss {record['first_loss']:.4f} -> "
                f"{record['last_loss']:.4f}, peak "
                f"{record['peak_device_gb']} GB ({seconds:.1f} s)")
            continue
        path = f"bench {config}"
        counts[path] = {name: record["launches"].get(name, 0)
                        for name in KERNELS}
        check_counts(path, counts[path])
        if not record["finite"]:
            raise AssertionError(f"{path}: non-finite disparity")
        log(f"  {config}: {record['seconds_per_pair']:.4f} s/pair (means "
            f"{', '.join(f'{s:.4f}' for s in record['samples_s'])}), "
            f"{record['value']:.2f} MP/s, peak "
            f"{record['peak_device_gb']} GB, launches "
            f"{record['launches']}, first call {record['first_call_s']:.1f}"
            f" s; parity {record.get('parity')}; isolated stages (ms) "
            f"{record.get('stages_ms_isolated')} ({seconds:.1f} s)")
    if set(records[0]["parity"]) != {"band_left", "band_right",
                                     "cbca_fused", "cbca_rolling"}:
        raise AssertionError(f"parity check: {records[0]['parity']}")

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(f"  full config's kernels at D_pad 512, rows {FULL_STRIP}:")
    full_depth_kernels(device, errors)
    torch.cuda.empty_cache()
    log("  profile of one full pair:")
    profile_full_pair(device)
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    root = os.path.join(ROOT, "build", "bench_serve")
    for client in ("pipelined", "sync"):
        torch.cuda.empty_cache()
        record, seconds = quiet(bench_serve.run, [
            "--scenes", str(BENCH_SERVE_SCENES), "--client", client,
            "--root", root, "--device", str(device)])
        if (record["answered_ok"] != BENCH_SERVE_SCENES
                or record["missing_artifacts"] or record["value"] is None):
            raise AssertionError(f"serve bench, {client}: {record}")
        log(f"  serve ({client}): {record['value']:.3f} pairs/s steady, "
            f"latencies {record['latencies_s']} s ({seconds:.1f} s)")

    for tool, argv in ((profile_pipeline, [str(n) for n in (*MAIN_SHAPE,
                                                            MAIN_NDISP)]),
                       (profile_fullres, [])):
        torch.cuda.empty_cache()
        record, seconds = quiet(tool.main, argv)
        if not all(np.isfinite(v) and v > 0
                   for v in record["stages_ms"].values()):
            raise AssertionError(f"{record['tool']}: {record['stages_ms']}")
        log(f"  {record['tool']} {record['shape']}: {record['stages_ms']}"
            f" ({seconds:.1f} s)")

    # warm-up as a serving process pays it: a process of its own
    scene_list = os.path.join(root, "list.txt")
    with open(scene_list, "w") as f:
        for i in range(BENCH_SERVE_SCENES):
            f.write(os.path.join(root, "data", f"s{i:02d}", "im0.png") + "\n")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mccnn_tpu_torch.tools.warmup", "--list_file",
         scene_list, "--volume_dtype", "bfloat16", "--device", str(device)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    lines = [line for line in proc.stdout.splitlines()
             if line.startswith("{")]
    if proc.returncode or len(lines) != 1:
        raise AssertionError(f"warmup failed: {proc.stdout[-2000:]}"
                             f"{proc.stderr[-2000:]}")
    record = json.loads(lines[0])
    bucketed = [-(-n // 64) * 64 for n in MAIN_SHAPE]
    if (record["device"] != smi or record["scenes"] != BENCH_SERVE_SCENES
            or [b["bucket"] for b in record["buckets"]]
            != [[*bucketed, MAIN_NDISP]]):
        raise AssertionError(f"warmup: {record}")
    records.append(record)
    log(f"  warmup (own process, {seconds:.1f} s): {record}")
    return counts, records


def drive_cbca_tools(smi: str) -> str:
    """Phase 12: ``tools.bench_cbca_banded.main()`` and
    ``tools.bench_cbca_layout.main()`` in this process; raises on a record
    of another card, a non-finite output, dense and banded apart by more
    than ``round_tolerance`` anywhere, or layouts apart by more than
    ``LAYOUT_RTOL`` of the largest value; then profiles one dense and one
    banded round on the tools' inputs. Returns the summary line."""
    import torch
    from mccnn_tpu_torch.ops.cbca import compute_arms
    from mccnn_tpu_torch.ops.cbca_mxu import cbca_mxu
    from mccnn_tpu_torch.tools import bench_cbca_banded, bench_cbca_layout

    records = {}
    for tool in (bench_cbca_banded, bench_cbca_layout):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        record = tool.main()
        if record["device"] != smi or not record["finite"]:
            raise AssertionError(f"{record['tool']}: {record}")
        log(f"  ({record['tool']}: {time.perf_counter() - t0:.1f} s)")
        records[record["tool"]] = record
    banded, layout = (records["bench_cbca_banded"],
                      records["bench_cbca_layout"])
    if not banded["within_tolerance"]:
        raise AssertionError(
            f"dense and banded apart by {banded['max_abs_diff']}, past the "
            "per-element tolerance")
    if not layout["layout_diff"] <= LAYOUT_RTOL * layout["scale"]:
        raise AssertionError(
            f"layouts apart by {layout['layout_diff']} at a scale of "
            f"{layout['scale']}")

    torch.cuda.empty_cache()
    image, vol = bench_cbca_banded.random_inputs(torch.device("cuda"))
    dist = bench_cbca_banded.DIST
    arms = compute_arms(image, bench_cbca_banded.TAU, dist)
    for label, fn in (
            ("dense mxu", lambda: cbca_mxu(vol, arms, 1, dist)),
            ("banded", lambda: bench_cbca_banded.banded_round(vol, arms,
                                                              dist))):
        fn()  # warm
        log(f"  profile of one {label} round:")
        profiled(fn)
    del image, vol, arms
    torch.cuda.empty_cache()
    return (
        f"CBCA tools at {' x '.join(map(str, banded['shape']))} f32 [{smi}]:"
        f" dense mxu x1 {banded['dense_ms']:.2f} ms "
        f"({banded['dense_peak_gb']:.2f} GB), banded x1 "
        f"{banded['banded_ms']:.2f} ms ({banded['banded_peak_gb']:.2f} GB), "
        f"max abs diff {banded['max_abs_diff']} (largest tolerance "
        f"{banded['largest_tolerance']}); torch ops (H,W,D) x1 "
        f"{layout['hwd_ms']:.2f} ms ({layout['hwd_peak_gb']:.2f} GB), "
        f"(H,D,W) x1 {layout['hdw_ms']:.2f} ms ({layout['hdw_peak_gb']:.2f} "
        f"GB), x16 {layout['hdw_x16_ms']:.2f} ms; layout diff "
        f"{layout['layout_diff']}")


def leaf_errors(got: dict, want: dict) -> dict:
    """Largest |got - want| / max |want| over the leaves of the ``params``
    and ``momentum`` trees; raises past ``TRAIN_REL_TOL``."""
    out = {}
    for tree in ("params", "momentum"):
        worst = 0.0
        for name, layer in want[tree].items():
            for kind, value in layer.items():
                err = float(np.abs(got[tree][name][kind] - value).max())
                scale = float(np.abs(value).max())
                worst = max(worst, err / scale)
                if not err <= TRAIN_REL_TOL * scale:
                    raise AssertionError(
                        f"{tree} {name}/{kind}: {err} apart at a scale of "
                        f"{scale}")
        out[tree] = worst
    return out


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "mccnn_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    try:
        from mccnn_tpu_torch.kernels import build
    except ImportError as exc:
        print(f"chip_smoke: run it from a checkout of the repository ({exc})",
              file=sys.stderr)
        return 2
    device = torch.device("cuda")
    started = time.perf_counter()

    def phase(title: str) -> None:
        log(f"== [{time.perf_counter() - started:6.1f} s] {title}")

    phase("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    phase("build")
    path, seconds = build.build()
    log(f"  kernels built in {seconds:.2f} s -> {os.path.relpath(path, ROOT)}")
    source = None
    for line in (build.BUILD_DIR / "build.log").read_text().splitlines():
        if " -c -o " in line:  # a compile command: its source is last
            source = os.path.basename(line.split()[-1])
        elif "Used" in line or "spill" in line or "Compiling entry" in line:
            log("  " + line.strip())
            if source == "cbca_stream.cu" and "Used" in line:
                log("  K10 (cbca_stream.cu, TMA ring, one warp a block): "
                    + line.split(":", 1)[1].strip())
    build.library()

    phase("kernels against their plain versions (256 x 384)")
    errors = Errors()
    check_kernels(device, errors)

    phase(f"serving path: MatchPipeline {MAIN_SHAPE[0]} x {MAIN_SHAPE[1]}, "
        f"ndisp {MAIN_NDISP}, bf16, paper defaults")
    counts, pipeline, serving = drive_main_path(device, build.LAUNCHES)
    launches = {"serve": counts}

    phase(f"batch matcher: cli.match.main on one {MAIN_SHAPE[0]} x "
        f"{MAIN_SHAPE[1]} ndisp-{MAIN_NDISP} scene, three schedules and three "
        "CBCA variants; then sgm_u8, the raw bands and the stream probe")
    launches.update(drive_batch_matcher(device, build.LAUNCHES, smi))

    phase("whole pair: kernels against CPU copies (256 x 384), the "
        "bf16-operand modes, mxu and joint regions included")
    compare_whole_pair(device)

    phase("kernels against their plain versions at the main-path shapes "
        "(1000 x 1504 x 256): outputs, then times and bounds")
    times = main_shape_kernels(device, errors)

    phase("profile of one main-path pair")
    profile_pair(pipeline)

    phase(f"training: the fast net at full width, TrainConfig() defaults, "
          f"scenes {MAIN_SHAPE[0]} x {MAIN_SHAPE[1]}; cli.train, card "
          "against CPU, steps/s, the trained weights served")
    training, launches["trained serve"] = drive_training(
        device, build.LAUNCHES, smi)

    phase(f"quality: train_fullscale ({QUALITY_EPOCHS} epochs, 15 scenes), "
          f"per-family bad-2.0 at {MAIN_SHAPE[0]} x {MAIN_SHAPE[1]}, ndisp "
          "162, trained and random init; the exact cross-check; parity_eval "
          "against the oracle chain")
    quality_started = time.perf_counter()
    quality, quality_counts = drive_quality(device, build.LAUNCHES, smi)
    launches.update(quality_counts)
    quality["phase_seconds"] = time.perf_counter() - quality_started

    phase(f"sharded: parallel/ on {SHARDED_RANKS} ranks sharing the card "
          f"over gloo; make_sharded_match at {MAIN_SHAPE[0]} x "
          f"{MAIN_SHAPE[1]} (serving, exact, fused8) and {MIDDLE_SHAPE[0]} "
          f"x {MIDDLE_SHAPE[1]} (fused2, rolling) against match_pair; the DP "
          "step; cli.train --data_parallel (NCCL); cli.match --multihost")
    sharded_counts, sharded = drive_sharded(device, smi)
    launches.update(sharded_counts)

    phase("bench: mccnn_tpu_torch.bench half, halfexact, quarter, full and "
          "train; the full config's K1, K2 and K3 against their plain "
          "versions at D_pad 512 and a profile of its pair; "
          f"tools.bench_serve ({BENCH_SERVE_SCENES} scenes, pipelined and "
          "sync); tools.profile_pipeline; tools.profile_fullres; "
          "tools.warmup")
    bench_counts, bench_records = drive_bench(device, smi, errors)
    launches.update(bench_counts)

    torch.cuda.empty_cache()
    phase("tools: bench_cbca_banded and bench_cbca_layout at 1000 x 1504 x "
          "256")
    cbca_tools = drive_cbca_tools(smi)
    log("  " + cbca_tools)

    summary = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[OWN_PATH[name]][name],
            "max_abs_err": errors.worst[name],
            # no single PyTorch call computes a band read off a
            # correlation's diagonals, a sum over data-dependent cross
            # arms, or a directional DP sweep; K10's is Tensor.clone()
            "library_ms": None,
            **times[name],
            "launches_by_path": {path: c[name]
                                 for path, c in launches.items()},
        }
        for name, (source, replaces) in KERNELS.items()
    ]}
    phase("done")
    for record in bench_records:
        log(json.dumps(record))
    log(f"serving pair {MAIN_SHAPE[0]} x {MAIN_SHAPE[1]}, ndisp {MAIN_NDISP}, "
        f"bf16: {serving['s_per_pair']:.4f} s/pair, peak device memory "
        f"{serving['peak_gb']:.2f} GB")
    log(f"training (fast net, batch {training['batch']}): "
        f"{training['fixed_batch_steps_per_s']:.1f} steps/s on a fixed batch,"
        f" {training['fed_steps_per_s']:.1f} steps/s fed by the sampler "
        f"through the prefetcher; {json.dumps(training)}")
    log(f"quality ({quality['steps']} steps at {quality['steps_per_s']:.1f} "
        f"steps/s, phase {quality['phase_seconds']:.1f} s; photo source: "
        f"{quality['photo_source']}): {json.dumps(quality)}")
    serve = sharded["sharded fused (per rank)"]
    log(f"sharded serving pair on {SHARDED_RANKS} ranks (gloo, one card): "
        f"{max(r['s_per_pair'] for r in serve):.4f} s/pair, a pair's peak "
        f"{max(r['peak_gb'] for r in serve):.2f} GB a rank (unsharded "
        f"{max(r['plain_s_per_pair'] for r in serve):.4f} s/pair, "
        f"{max(r['plain_peak_gb'] for r in serve):.2f} GB); "
        f"{json.dumps(sharded)}")
    log(cbca_tools)
    log(smi)
    log(json.dumps(summary))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
