"""Benchmark: the full matching pipeline's throughput on one card (the JAX
repo's bench.py on PyTorch).

Runs the complete pipeline (features -> cost volume -> CBCA(2) -> SGM ->
CBCA(16) -> WTA -> LR -> subpixel -> median -> bilateral) with the paper's
Middlebury hyperparameters (``MatchConfig()``) and ``init_params(0)``
weights on a synthetic pair (``bench_pair``: seeded noise, the right image
shifted by 12 columns).

Configs (``--config``), each the JAX bench's schedule:

  half (default): 1000 x 1504, ndisp 200, bf16 volumes, ``cbca_impl``
                  "auto": per pair K1 2, K2 36 (bf16), K3 8.
  halfexact:      1000 x 1504, ndisp 200, f32 volumes, ``cbca_impl``
                  "fused": K1's f32 route 2, K2 36 in f32, K3 8.
  quarter:        500 x 736, ndisp 100, as half (D_pad 128).
  full:           2000 x 3072, ndisp 400, bf16 volumes, "fused",
                  ``cbca_chunk_d`` 256 (``CBCA_CHUNK_D``), D_pad 512: K1 2,
                  K2 72, K3 8.
  train:          training steps/s at batch 128 on a fixed batch: the
                  best of three means of 50 steps, after 200 warm-up
                  steps.

``seconds_per_pair`` is the best of three means of 3 pairs, each window
ending in ``torch.cuda.synchronize()``; ``samples_s`` holds the three
means. ``half`` also holds K1, K2 and K8 against their plain versions
(``_parity_check``) and, as ``halfexact`` does, times each stage in
isolation (``_stage_profile``; ``--no-stages`` skips it). Each record
names the device: ``nvidia-smi``'s name and power limit of the card, or
"cpu" with ``--device cpu`` (then ``peak_device_gb`` is null).

    python -m mccnn_tpu_torch.bench [--config half] [--device cpu]
        [--no-stages]

Prints exactly one JSON line on stdout; logs go to stderr. Any failure
raises, so the exit code is non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from mccnn_tpu_torch.kernels.build import LAUNCHES
from mccnn_tpu_torch.models.net import (
    disable_tf32,
    extract_features,
    init_params,
    params_from_numpy,
)
from mccnn_tpu_torch.ops.cbca import cbca, compute_arms
from mccnn_tpu_torch.ops.cbca_fused import cbca_fused
from mccnn_tpu_torch.ops.cbca_mxu import build_masks
from mccnn_tpu_torch.ops.cbca_rolling import cbca_fused_rolling
from mccnn_tpu_torch.ops.common import pad_disparities
from mccnn_tpu_torch.ops.cost_volume import (
    band_side,
    band_side_plain,
    cost_volume_pair,
)
from mccnn_tpu_torch.ops.filters import bilateral_filter, median_filter
from mccnn_tpu_torch.ops.lr_check import lr_consistency_interpolate
from mccnn_tpu_torch.ops.sgm import sweep
from mccnn_tpu_torch.ops.subpixel import subpixel_enhance
from mccnn_tpu_torch.ops.wta import wta_disparity
from mccnn_tpu_torch.pipeline.match import (
    _VOLUME_DTYPES,
    _cbca_aggregate,
    _run_cbca,
    match_pair,
)
from mccnn_tpu_torch.utils.config import MatchConfig

TARGET_MPS = (1000 * 1504 / 1e6) / 5.0  # the < 5 s half-res north star
HALF = {"volume_dtype": "bfloat16"}  # the serving schedule
FULL_SHAPE = (2000, 3072, 400)  # H, W, ndisp of the full config
PARITY_LIMITS = {"band": 1e-4, "cbca": 1e-3}  # the JAX bench's, absolute


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def resolve_device(name: str) -> torch.device:
    """``--device`` -> torch device; a CUDA request with no card raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not "
                           "available (pass --device cpu)")
    return device


def device_label(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_gb(device: torch.device):
    """The peak device memory since ``reset_peak`` in GB (None on the
    CPU)."""
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 1e9


def timed(fn, *args, device: torch.device, iters: int = 5):
    """(the last output, mean seconds of ``iters`` calls after a warm-up
    call): the calls are enqueued back to back and the window ends in a
    device sync."""
    out = fn(*args)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    sync(device)
    return out, (time.perf_counter() - t0) / iters


def bench_pair(height: int, width: int):
    """The JAX bench's synthetic pair (bench.py:284-290): standardized
    noise, and the same noise rolled by -12 columns plus 0.05 noise."""
    rng = np.random.default_rng(0)
    base = rng.normal(size=(height, width)).astype(np.float32)
    left = (base - base.mean()) / base.std()
    shifted = np.roll(base, -12, axis=1) + 0.05 * rng.normal(
        size=(height, width)
    ).astype(np.float32)
    right = (shifted - shifted.mean()) / shifted.std()
    return left, right


def matcher(net, ndisp: int, match_kwargs: dict,
            config: MatchConfig = MatchConfig()):
    """``fn(left, right)`` -> disparity: ``match_pair`` on one schedule."""

    def fn(left, right):
        return match_pair(net, left, right, ndisp, config, **match_kwargs)

    return fn


def bench_train(batch: int = 128, steps: int = 50, device: str = "cuda",
                warmup: int = 200, windows: int = 3) -> dict:
    """Training steps/s on a fixed batch of random (batch, 11, 11, 1)
    triplets (``TrainConfig()``, ``init_params(0)``): one step, ``warmup``
    - 1 more and a sync, then ``windows`` windows of ``steps`` steps
    enqueued back to back, each ending in a sync. ``seconds_per_step`` is
    the best window's mean, ``samples_s`` holds every window's (as the
    pair configs' are). The steps are host-bound on the card and a fresh
    process reads low over its first ones: hence the warm-up (the JAX
    bench times 50 steps after one)."""
    from mccnn_tpu_torch.pipeline.train import (
        batch_to_device,
        make_optimizer,
        make_train_step,
    )
    from mccnn_tpu_torch.utils.config import TrainConfig

    device = resolve_device(device)
    label = device_label(device)
    config = TrainConfig()
    net = params_from_numpy(init_params(0)).to(device)
    optimizer = make_optimizer(config, net)
    step = make_train_step(config, net, optimizer)
    rng = np.random.default_rng(0)
    triplets = batch_to_device(tuple(
        rng.normal(size=(batch, 11, 11, 1)).astype(np.float32)
        for _ in range(3)), device)
    t0 = time.perf_counter()
    first_loss = float(step(triplets))
    first_step_s = time.perf_counter() - t0
    log(f"first step loss {first_loss:.4f} ({first_step_s:.2f} s)")
    t0 = time.perf_counter()
    for _ in range(warmup - 1):
        step(triplets)
    sync(device)
    warmup_s = time.perf_counter() - t0
    reset_peak(device)
    samples = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = step(triplets)
        last_loss = float(loss)  # waits for the device
        samples.append((time.perf_counter() - t0) / steps)
    per_step = min(samples)
    log(f"{warmup} warm-up steps in {warmup_s:.2f} s; then s/step {samples}")
    record = {
        "metric": f"train_steps_per_s_batch{batch}",
        "value": 1.0 / per_step,
        "unit": "steps/s",
        "vs_baseline": 1.0,
        "seconds_per_step": per_step,
        "samples_s": samples,
        "steps": steps,
        "warmup_steps": warmup,
        "first_loss": first_loss,
        "last_loss": last_loss,
        "first_step_s": first_step_s,
        "warmup_s": warmup_s,
        "device": label,
        "peak_device_gb": peak_gb(device),
    }
    if not np.isfinite([first_loss, last_loss]).all():
        raise RuntimeError(f"non-finite training loss: {record}")
    print(json.dumps(record), flush=True)
    return record


def _parity_check(device: torch.device) -> dict:
    """K1 (both sides, f32), K2 and K8 (two rounds, f32) against their
    plain versions at 96 x 256, ndisp 32 (D_pad 128: K2's contract), with
    the JAX bench's absolute limits; raises past them. On the CPU the
    wrappers run the plain versions themselves."""
    rng = np.random.default_rng(1)
    height, width, ndisp = 96, 256, 32
    d_pad = pad_disparities(ndisp)

    def unit():
        f = rng.normal(size=(height, width, 64)).astype(np.float32)
        f /= np.linalg.norm(f, axis=-1, keepdims=True)
        return torch.from_numpy(f).to(device)

    fl, fr = unit(), unit()
    errors = {}
    for side, anchor, other in (("left", fl, fr), ("right", fr, fl)):
        got = band_side(anchor, other, ndisp, d_pad, side, torch.float32)
        want = band_side_plain(anchor, other, ndisp, d_pad, side,
                               torch.float32)
        errors[f"band_{side}"] = float((got - want).abs().max())
    image = torch.from_numpy(
        rng.normal(size=(height, width)).astype(np.float32)).to(device)
    volume = cost_volume_pair(fl, fr, ndisp, sides="left")
    arms = compute_arms(image, 0.02, 14)
    want = cbca(volume, arms, 2, 14)
    for name, aggregate in (("cbca_fused", cbca_fused),
                            ("cbca_rolling", cbca_fused_rolling)):
        errors[name] = float((aggregate(volume, arms, 2, 14) - want)
                             .abs().max())
    for name, err in errors.items():
        limit = PARITY_LIMITS[name.split("_")[0]]
        status = "OK" if err < limit else "FAIL"
        log(f"parity {name} vs plain: max abs err {err:.2e} (limit "
            f"{limit:.0e}) [{status}]")
        if not err < limit:
            raise RuntimeError(f"parity failure: {name} {err} >= {limit}")
    return errors


def _stage_profile(net, left, right, ndisp: int, config: MatchConfig,
                   match_kwargs: dict, device: torch.device,
                   pair_seconds: float | None = None) -> dict:
    """Each stage timed in isolation (ms) at the pipeline's types, and the
    achieved rates of the convolutions, the band and the CBCA round.

    The pipeline reuses buffers that isolated stages allocate anew, so
    these are attributions, not a decomposition (hence "isolated"). With
    ``pair_seconds`` the pair time split by the isolated fractions is
    added as ``stages_in_pipeline_est_ms``.
    """
    height, width = left.shape
    vdtype = _VOLUME_DTYPES[match_kwargs.get("volume_dtype", "float32")]
    method = match_kwargs.get("cost_volume_method", "auto")
    impl = match_kwargs.get("cbca_impl", "auto")
    chunk_d = match_kwargs.get("cbca_chunk_d", 0)
    band = method in ("auto", "pallas")
    distance = int(config.cbca_distance)
    disable_tf32()
    stages = {}
    with torch.no_grad():
        (fl, fr), dt = timed(lambda a, b: (extract_features(net, a),
                                           extract_features(net, b)),
                             left, right, device=device)
        stages["features"] = dt
        # 5-layer 3x3 stack, 1 -> 64 then 64 -> 64 x 4, both images
        conv_flops = 2 * height * width * 2 * 9 * 64 * (1 + 4 * 64)
        feat_tflops = conv_flops / dt / 1e12

        if band and vdtype == torch.bfloat16:
            fl, fr = fl.to(torch.bfloat16), fr.to(torch.bfloat16)

        def volumes(a, b):
            if band:  # one K1 launch a side, as the pipeline runs them
                return tuple(cost_volume_pair(a, b, ndisp, sides=side,
                                              dtype=vdtype)
                             for side in ("left", "right"))
            return cost_volume_pair(a, b, ndisp, dtype=vdtype, method=method)

        (volume, right_volume), dt = timed(volumes, fl, fr, device=device)
        stages["cost_volume"] = dt
        cv_tflops = 2 * height * width * ndisp * 64 * 2 / dt / 1e12  # useful
        del fl, fr, right_volume

        arms = compute_arms(left, config.cbca_intensity, distance)
        aggregate = _cbca_aggregate(impl)
        kwargs = {"masks": build_masks(arms)} if impl == "mxu" else {}
        rounds = 2 * (config.cbca_num_iterations_1
                      + config.cbca_num_iterations_2)
        _, dt = timed(lambda v: _run_cbca(aggregate, v, arms, 1, distance,
                                          chunk_d, **kwargs),
                      volume, device=device)
        stages["cbca"] = dt * rounds
        cbca_round_s = dt
        # the traffic-bound stage: the volume read and written per round
        cbca_gbps = (2 * volume.numel() * volume.element_size()) / dt / 1e9

        swept = torch.empty_like(volume)
        stages["sgm"] = 0.0
        for direction in ((0, 1), (1, 0)):  # a horizontal, a vertical sweep
            _, dt = timed(lambda v, d=direction: sweep(
                v, swept, left, right, "L", d, config), volume,
                device=device)
            stages["sgm"] += 4 * dt  # 2 directions x 2 volumes per axis
        del swept

        def post(lv, rv, image):
            disp = lr_consistency_interpolate(wta_disparity(lv),
                                              wta_disparity(rv), ndisp)
            disp = subpixel_enhance(disp, lv, ndisp)
            disp = median_filter(disp, config.median_filter_size,
                                 config.median_filter_size)
            return bilateral_filter(image, disp, config.bilateral_filter_size,
                                    config.bilateral_filter_size, 0.0,
                                    config.blur_sigma, config.blur_threshold)

        _, dt = timed(post, volume, volume, left, device=device)
        stages["post"] = dt

    result = {k: v * 1e3 for k, v in stages.items()}
    result["cbca_ms_per_round"] = cbca_round_s * 1e3
    record = {
        "stages_ms_isolated": result,
        "tflops": {"features": feat_tflops, "cost_volume": cv_tflops},
        "cbca_volume_gbps": cbca_gbps,
        "cbca_impl": impl,
    }
    if pair_seconds is not None:
        total = sum(stages.values())
        record["stages_in_pipeline_est_ms"] = {
            k: pair_seconds * v / total * 1e3 for k, v in stages.items()}
    return record


def main(height: int = 1000, width: int = 1504, ndisp: int = 200,
         label: str = "halfres_full_pipeline_megapixels_per_s",
         match_kwargs: dict | None = None, parity: bool = True,
         stages: bool = True, schedule: str | None = "bf16_fused",
         device: str = "cuda", windows: int = 3, pairs: int = 3) -> dict:
    """Time one schedule (the serving one by default); print and return
    its record. ``seconds_per_pair`` is the best of ``windows`` means of
    ``pairs`` pairs (3 and 3 in every config; fewer only to keep a test
    short)."""
    device = resolve_device(device)
    label_device = device_label(device)
    build_s = None
    if device.type == "cuda":
        from mccnn_tpu_torch.kernels import build

        _, build_s = build.build()
        build.library()
    config = MatchConfig()  # paper defaults: CBCA 2 + 16 rounds, 4-dir SGM
    if match_kwargs is None:
        match_kwargs = dict(HALF)
    net = params_from_numpy(init_params(0)).to(device)
    left_np, right_np = bench_pair(height, width)
    left = torch.from_numpy(left_np).to(device)
    right = torch.from_numpy(right_np).to(device)
    fn = matcher(net, ndisp, match_kwargs, config)

    LAUNCHES.reset()
    t0 = time.perf_counter()
    out = fn(left, right)  # one pair: its kernel launches
    finite = bool(torch.isfinite(out).all())  # waits for the device
    first_call_s = time.perf_counter() - t0
    launches = {k: v for k, v in LAUNCHES.snapshot().items() if v}
    log(f"first call: {first_call_s:.2f} s (kernel build {build_s} s; "
        f"checksum {float(out.sum()):.1f})")
    if tuple(out.shape) != (height, width) or not finite:
        raise RuntimeError(f"disparity of shape {tuple(out.shape)}, finite "
                           f"{finite}; want ({height}, {width}), finite")

    def timed_pairs(iters: int) -> float:
        sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(left, right)
        sync(device)  # the stream is in order: every pair has finished
        return (time.perf_counter() - t0) / iters

    reset_peak(device)
    samples = [timed_pairs(pairs) for _ in range(windows)]
    peak = peak_gb(device)
    best = min(samples)
    mpix_per_s = height * width / 1e6 / best
    log(f"steady state: {best:.4f} s per pair ({mpix_per_s:.2f} MP/s), "
        f"means {samples}, launches {launches}, peak {peak} GB")

    record = {
        "metric": label,
        "value": mpix_per_s,
        "unit": "MP/s",
        "vs_baseline": mpix_per_s / TARGET_MPS,
        "seconds_per_pair": best,
        "samples_s": samples,
        "shape": [height, width, ndisp],
        "device": label_device,
        "peak_device_gb": peak,
        "launches": launches,
        "first_call_s": first_call_s,
        "kernel_build_s": build_s,
        "finite": finite,
    }
    if schedule is not None:
        record["schedule"] = schedule
    if parity:
        record["parity"] = _parity_check(device)
    if stages:
        record.update(_stage_profile(net, left, right, ndisp, config,
                                     match_kwargs, device, best))
    print(json.dumps(record), flush=True)
    return record


def bench_quarter(device: str = "cuda", stages: bool = False) -> dict:
    return main(500, 736, 100, "quarterres_full_pipeline_megapixels_per_s",
                parity=False, stages=stages, device=device)


def bench_half_exact(device: str = "cuda", stages: bool = True) -> dict:
    """Half resolution with f32 volumes and the fused CBCA: K1's f32 route
    and K2 in f32 (the JAX bench's strict-parity configuration)."""
    return main(label="halfres_exact_f32_pipeline_megapixels_per_s",
                match_kwargs={"cbca_impl": "fused"}, parity=False,
                stages=stages, schedule="exact_f32", device=device)


def bench_full(device: str = "cuda", stages: bool = False) -> dict:
    """Full resolution: bf16 volumes, one volume live at a time, the
    fused CBCA on 256-lane chunks of D_pad 512 (``CBCA_CHUNK_D``), as in
    the JAX bench. Width 3072 is the bucket a ~3000-pixel Middlebury scene
    pads to."""
    return main(
        *FULL_SHAPE, "fullres_full_pipeline_megapixels_per_s",
        match_kwargs=full_schedule(), parity=False, stages=stages,
        schedule="bf16_fused_sequential", device=device)


def full_schedule() -> dict:
    """``match_pair``'s options in the full config."""
    return {"cbca_impl": "fused", "volume_dtype": "bfloat16",
            "cbca_chunk_d": int(os.environ.get("CBCA_CHUNK_D", "256"))}


CONFIGS = {"half": main, "halfexact": bench_half_exact,
           "quarter": bench_quarter, "full": bench_full,
           "train": bench_train}


def cli(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default="half", choices=sorted(CONFIGS))
    parser.add_argument("--device", default="cuda",
                        help="torch device; a CUDA request with no card fails")
    parser.add_argument("--no-stages", action="store_true",
                        help="skip the isolated stage profile")
    args = parser.parse_args(argv)
    options = {"device": args.device}
    if args.no_stages and args.config != "train":
        options["stages"] = False
    return CONFIGS[args.config](**options)


if __name__ == "__main__":
    cli()
