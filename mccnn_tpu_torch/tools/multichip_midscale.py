"""The sharded matcher against the unsharded one at a scale where sharding
matters (tools/multichip_midscale.py).

Spawns N ranks (``parallel/launch.py``); each runs an ``all_reduce``
across the ranks, one sharded CBCA stage (the ``--impl`` hook of
``parallel/pallas_shard.py``, two rounds) and then ``make_sharded_match``
on one synthetic occlusion scene with random seeded weights (the fast
MC-CNN at full width): a warm-up pair, then ``--pairs`` timed pairs, the
first with the launch counts, the collectives' bytes and seconds
(``mesh.traffic``) and the device's peak memory above what the rank held
before it taken, then one pair that returns its volumes. Then the ranks run
the unsharded ``match_pair`` on the same inputs one at a time (so its time
and peak memory are its own; the second of two pairs is timed), and each
holds its rows of the pre-WTA volumes, and the whole WTA maps and
disparity, against it:

  * f32 volumes within atol 1e-4 / rtol 1e-6, bf16 volumes within one bf16
    ulp at the volume's largest valid cost (``fused8``: bit for bit);
  * the WTA maps' differing pixels and the bad-2.0 delta of the
    disparity against the scene's ground truth (budget 0.005).

Prints one line per rank and ``BRINGUP OK`` when every check passes.

    python -m mccnn_tpu_torch.tools.multichip_midscale [--ranks 2]
        [--height 512 --width 768 --ndisp 128] [--impl fused]
        [--volume-dtype bfloat16] [--device cpu] [--backend gloo]

On ``cuda`` (the default) NCCL gives every rank a card of its own; with
``--backend gloo`` the ranks share the cards, one card among all of them
on a one-card machine, which proves the path but is no measure of what
sharding gains. ``run()`` runs several ``job``s on one spawn and returns
each rank's results.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

BAD_BUDGET = 0.005  # bad-2.0, sharded against unsharded (PARITY.md)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _bf16_ulp(magnitude: float) -> float:
    return float(2.0 ** (np.floor(np.log2(max(magnitude, 1e-30))) - 7))


def _reset_peak(device) -> int:
    """Start a peak-memory window; the bytes the process holds now."""
    import torch

    if device.type != "cuda":
        return 0
    torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.memory_allocated(device)


def _peak_gb(device, base: int):
    """The window's peak device memory above ``base``, in GB (None on the
    CPU): what one pair needs beyond the tensors the rank already held."""
    import torch

    if device.type != "cuda":
        return None
    return (torch.cuda.max_memory_allocated(device) - base) / 1e9


def _volume_check(got, want, dtype: str, exact: bool) -> dict:
    """Max |got - want| of a volume shard, and the tolerance it is held to:
    0 (bit for bit), one bf16 ulp at the largest valid cost, or f32's
    atol 1e-4 beyond rtol 1e-6."""
    import torch

    valid = want.float() < 1e8
    scale = float(want.float().abs()[valid].max()) if valid.any() else 1.0
    diff = (got.float() - want.float()).abs()
    out = {"max_abs_diff": float(diff.max()), "bit_equal": bool(
        torch.equal(got, want))}
    if exact:
        out.update(tol=0.0, ok=out["bit_equal"])
    elif dtype == "bfloat16":
        out.update(tol=_bf16_ulp(scale), ok=out["max_abs_diff"]
                   <= _bf16_ulp(scale))
    else:
        beyond = float((diff - 1e-6 * want.float().abs()).max())
        out.update(tol=1e-4, beyond_rtol=beyond, ok=beyond <= 1e-4)
    return out


def rank_program(mesh, params, left, right, gt, ndisp, config,
                 volume_dtype="bfloat16", cbca_impl="fused",
                 cost_volume_method="pallas", pairs=1) -> dict:
    """One rank of the comparison (see the module docstring)."""
    import torch
    import torch.distributed as dist

    from mccnn_tpu_torch.kernels.build import LAUNCHES
    from mccnn_tpu_torch.models.net import params_from_numpy
    from mccnn_tpu_torch.ops.cbca import compute_arms
    from mccnn_tpu_torch.ops.cost_volume import pad_disparities
    from mccnn_tpu_torch.parallel.match import make_sharded_match
    from mccnn_tpu_torch.parallel.mesh import all_reduce, shard_rows
    from mccnn_tpu_torch.parallel.pallas_shard import make_sharded_cbca_fn
    from mccnn_tpu_torch.pipeline.match import (
        _VOLUME_DTYPES,
        _cbca_aggregate,
        match_pair,
    )
    from mccnn_tpu_torch.utils.evaluate import bad_n

    device = mesh.device
    out = {"rank": mesh.rank, "device": str(device),
           "backend": mesh.backend}
    total = all_reduce(torch.ones(1, device=device), mesh)
    if total.item() != mesh.size:
        raise AssertionError(f"all_reduce gave {total.item()}")

    net = params_from_numpy(params).to(device)
    left_t = torch.from_numpy(left).to(device)
    right_t = torch.from_numpy(right).to(device)
    start, stop = shard_rows(left.shape[0], mesh)
    distance = int(config.cbca_distance)

    # one sharded CBCA stage (two rounds) against the unsharded call
    rng = np.random.default_rng(1)
    d_pad = pad_disparities(ndisp)
    volume = torch.from_numpy(rng.standard_normal(
        (left.shape[0], left.shape[1], d_pad)).astype(np.float32)).to(
        device, _VOLUME_DTYPES[volume_dtype])
    arms = compute_arms(left_t, config.cbca_intensity, distance)
    sharded = make_sharded_cbca_fn(distance, mesh, cbca_impl)(
        volume[start:stop].contiguous(), arms, 2)
    whole = _cbca_aggregate(cbca_impl)(volume, arms, 2, distance)
    out["cbca"] = _volume_check(sharded, whole[start:stop], volume_dtype,
                                cbca_impl == "fused8")
    del volume, sharded, whole

    options = dict(volume_dtype=volume_dtype, cbca_impl=cbca_impl,
                   cost_volume_method=cost_volume_method)
    serve = make_sharded_match(ndisp, config, mesh, **options)
    serve(net, left_t, right_t)  # warm-up: cuDNN's choice, the pools
    _sync(device)
    dist.barrier()
    LAUNCHES.reset()
    mesh.traffic.clear()
    base = _reset_peak(device)
    seconds = []
    for pair in range(pairs):
        t0 = time.perf_counter()
        serve(net, left_t, right_t)
        _sync(device)
        seconds.append(time.perf_counter() - t0)
        if pair == 0:  # what one pair launches, moves and holds
            out["launches"] = LAUNCHES.snapshot()
            out["traffic"] = dict(mesh.traffic)
            out["peak_gb"] = _peak_gb(device, base)
    out["s_per_pair"] = float(np.mean(seconds))
    got = make_sharded_match(ndisp, config, mesh, return_volumes=True,
                             **options)(net, left_t, right_t)

    # the unsharded pair, one rank at a time
    for turn in range(mesh.size):
        dist.barrier()
        if turn != mesh.rank:
            continue
        match_pair(net, left_t, right_t, ndisp, config, **options)
        _sync(device)  # its first pair: the allocator's pools grow
        base = _reset_peak(device)
        t0 = time.perf_counter()
        match_pair(net, left_t, right_t, ndisp, config, **options)
        _sync(device)
        out["plain_s_per_pair"] = time.perf_counter() - t0
        out["plain_peak_gb"] = _peak_gb(device, base)
        plain = match_pair(net, left_t, right_t, ndisp, config,
                           return_volumes=True, **options)
        for key in ("left_volume", "right_volume"):
            out[key] = _volume_check(got[key], plain[key][start:stop],
                                     volume_dtype, cbca_impl == "fused8")
        for key in ("left_disparity", "right_disparity"):
            out[f"{key}_differing"] = int(
                (got[key] != plain[key]).sum().item())
        disparity = got["disparity"].cpu().numpy()
        want = plain["disparity"].cpu().numpy()
        out["disparity_max_abs_diff"] = float(np.abs(disparity - want).max())
        out["bad2"] = float(bad_n(disparity, gt, 2.0))
        out["bad2_delta"] = abs(out["bad2"] - float(bad_n(want, gt, 2.0)))
        out["finite"] = bool(np.isfinite(disparity).all())
        del plain
    dist.barrier()
    return out


def failures(result: dict, exact: bool = False) -> list:
    """What a rank's result fails (an empty list when it passes)."""
    bad = [key for key in ("cbca", "left_volume", "right_volume")
           if not result[key]["ok"]]
    if not result["finite"]:
        bad.append("non-finite disparity")
    differing = (result["left_disparity_differing"]
                 + result["right_disparity_differing"])
    if exact and (differing or result["disparity_max_abs_diff"]):
        bad.append("fused8 maps or disparity not bit-equal")
    if differing and result["bad2_delta"] > BAD_BUDGET:
        bad.append(f"bad-2.0 delta {result['bad2_delta']} > {BAD_BUDGET}")
    if not differing and result["disparity_max_abs_diff"] > 1e-5:
        bad.append("disparity off with equal WTA maps")
    return bad


def scene(height: int, width: int, ndisp: int, seed: int = 0):
    """A synthetic occlusion scene: standardized left, right and the
    ground truth."""
    from mccnn_tpu_torch.pipeline.match import standardize_image
    from mccnn_tpu_torch.utils.scenes import make_scene

    s = make_scene("occlusion", np.random.default_rng(seed), height, width,
                   max(1, ndisp * 3 // 4))
    return (standardize_image(s["left"]), standardize_image(s["right"]),
            s["gt"])


def job(height=512, width=768, ndisp=128, config=None,
        volume_dtype="bfloat16", cbca_impl="fused",
        cost_volume_method="pallas", pairs=1, seed=0) -> dict:
    """The arguments of one ``rank_program`` run: a synthetic scene and
    the seeded weights."""
    from mccnn_tpu_torch.models.net import init_params
    from mccnn_tpu_torch.utils.config import MatchConfig

    left, right, gt = scene(height, width, ndisp, seed)
    return dict(params=init_params(seed), left=left, right=right, gt=gt,
                ndisp=ndisp, config=config or MatchConfig(),
                volume_dtype=volume_dtype, cbca_impl=cbca_impl,
                cost_volume_method=cost_volume_method, pairs=pairs)


def rank_jobs(mesh, jobs) -> list:
    """``rank_program`` on each job in turn, on one spawn of the ranks."""
    return [rank_program(mesh, **kwargs) for kwargs in jobs]


def run(jobs, ranks=2, device="cuda", backend=None,
        timeout_s=600.0) -> list:
    """Spawn the ranks once, run the ``job`` dicts; ``[job][rank]``
    results."""
    from mccnn_tpu_torch.parallel.launch import run_ranks

    per_rank = run_ranks(rank_jobs, ranks, list(jobs), device=device,
                         backend=backend, timeout_s=timeout_s)
    return [list(results) for results in zip(*per_rank)]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=2)
    parser.add_argument("--height", type=int, default=512)
    parser.add_argument("--width", type=int, default=768)
    parser.add_argument("--ndisp", type=int, default=128)
    parser.add_argument("--impl", default="fused")
    parser.add_argument("--volume-dtype", default="bfloat16",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--cost-volume-method", default="pallas")
    parser.add_argument("--iterations", default="2,16",
                        help="CBCA rounds before and after SGM")
    parser.add_argument("--pairs", type=int, default=1)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--backend", default=None)
    parser.add_argument("--timeout", type=float, default=600.0)
    args = parser.parse_args(argv)

    from mccnn_tpu_torch.utils.config import MatchConfig

    first, second = (int(n) for n in args.iterations.split(","))
    config = MatchConfig(cbca_num_iterations_1=first,
                         cbca_num_iterations_2=second)
    [results] = run([job(args.height, args.width, args.ndisp, config,
                         args.volume_dtype, args.impl,
                         args.cost_volume_method, args.pairs)],
                    args.ranks, args.device, args.backend, args.timeout)
    bad = []
    for result in results:
        print(json.dumps(result), flush=True)
        bad += [f"rank {result['rank']}: {b}"
                for b in failures(result, args.impl == "fused8")]
    if bad:
        print("\n".join(bad), file=sys.stderr)
        return 1
    print("BRINGUP OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
