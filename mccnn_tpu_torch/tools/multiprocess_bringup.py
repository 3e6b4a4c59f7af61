"""Multi-process bring-up of the sharded port (tools/multiprocess_bringup.py).

Spawns N ranks on this host (``parallel/launch.py``), starts the process
group and, on every rank,

  1. checks the collectives: an ``all_reduce`` (sum and max) across the
     ranks, a halo exchange (neighbours' rows, zeros at the global ends)
     and the rows -> columns -> rows reshard at a width that does not
     divide by N;
  2. runs a row-sharded CBCA (the torch stencil, ``parallel/cbca.py``, and
     the kernel hook of ``parallel/pallas_shard.py``) whose halo exchange
     crosses the process boundary;
  3. runs the sharded matcher (``parallel/match.py``) on a synthetic pair;

and the parent holds the gathered results against the unsharded calls.
Prints ``BRINGUP OK`` when every rank agrees.

    python -m mccnn_tpu_torch.tools.multiprocess_bringup [--ranks 2]
        [--device cpu] [--backend gloo]

On ``cuda`` (the default) every rank takes a card, or shares the one card
with ``--backend gloo``. The functions taking a ``mesh`` first are the rank
programs; the port's CPU tests run them too (``run_cases`` runs several in
one spawn).
"""

from __future__ import annotations

import argparse
import sys
import traceback

import numpy as np


def _on(mesh, array):
    import torch

    return torch.from_numpy(np.ascontiguousarray(array)).to(mesh.device)


def collectives(mesh, width: int = 7, radius: int = 2) -> dict:
    """The raw collectives on rank-coded data: the sum and max of the
    ranks, this rank's halo-extended block of an (N * 4, width) array and
    the same array after a rows -> columns -> rows round trip."""
    import torch

    from mccnn_tpu_torch.parallel import mesh as m

    total = m.all_reduce(torch.tensor([mesh.rank + 1.0],
                                      device=mesh.device), mesh)
    top = m.all_reduce(torch.tensor([float(mesh.rank)], device=mesh.device),
                       mesh, "max")
    rows = 4
    whole = torch.arange(mesh.size * rows * width * 3, dtype=torch.float32)
    whole = whole.reshape(mesh.size * rows, width, 3).to(mesh.device)
    local = whole[mesh.rank * rows:(mesh.rank + 1) * rows].contiguous()
    columns, col0 = m.rows_to_columns(local, mesh)
    back = m.columns_to_rows(columns, width, mesh)
    bf16 = local.to(torch.bfloat16)
    return {
        "sum": total.item(), "max": top.item(),
        "halo": m.exchange_halo(local, radius, mesh).cpu().numpy(),
        "halo_bf16": m.exchange_halo(bf16, radius, mesh).float().cpu()
        .numpy(),
        "columns": columns.cpu().numpy(), "col0": col0,
        "round_trip": back.cpu().numpy(),
        "gathered": m.gather_rows(local, mesh).cpu().numpy(),
    }


def sharded_cbca(mesh, volume: np.ndarray, image: np.ndarray,
                 intensity: float, distance: int, iterations: int,
                 impl: str | None = None) -> np.ndarray:
    """This rank's rows of the aggregated ``volume``: the torch stencil
    (``cbca_sharded``) when ``impl`` is None, else the kernel hook of
    ``make_sharded_cbca_fn(impl=impl)``."""
    from mccnn_tpu_torch.ops.cbca import compute_arms
    from mccnn_tpu_torch.parallel.cbca import cbca_sharded
    from mccnn_tpu_torch.parallel.mesh import shard_rows
    from mccnn_tpu_torch.parallel.pallas_shard import make_sharded_cbca_fn

    arms = compute_arms(_on(mesh, image), intensity, distance)
    start, stop = shard_rows(volume.shape[0], mesh)
    local = _on(mesh, volume[start:stop])
    if impl is None:
        out = cbca_sharded(local, arms, iterations, distance, mesh)
    else:
        out = make_sharded_cbca_fn(distance, mesh, impl)(local, arms,
                                                         iterations)
    return out.float().cpu().numpy()


def sharded_match(mesh, params, left: np.ndarray, right: np.ndarray,
                  ndisp: int, config, cost_volume_method: str = "pallas",
                  cbca_impl: str = "fused",
                  volume_dtype: str = "float32") -> dict:
    """``make_sharded_match(..., return_volumes=True)`` on the pair; numpy
    arrays (the volumes are this rank's rows, in f32)."""
    from mccnn_tpu_torch.models.net import params_from_numpy
    from mccnn_tpu_torch.parallel.match import make_sharded_match

    net = params_from_numpy(params).to(mesh.device)
    fn = make_sharded_match(ndisp, config, mesh, cost_volume_method,
                            cbca_impl, volume_dtype, return_volumes=True)
    out = fn(net, _on(mesh, left), _on(mesh, right))
    return {key: (value.float().cpu().numpy() if hasattr(value, "cpu")
                  else value) for key, value in out.items()}


def dp_steps(mesh, params, batches, config) -> dict:
    """``make_dp_train_step`` over the global ``batches`` (each rank keeps
    its slice): the losses, the params after each step and the last
    momentum traces (HWIO numpy trees)."""
    from mccnn_tpu_torch.models.net import params_from_numpy, params_to_numpy
    from mccnn_tpu_torch.parallel.train import make_dp_train_step, shard_batch
    from mccnn_tpu_torch.pipeline.train import (
        make_optimizer,
        momentum_to_numpy,
    )

    net = params_from_numpy(params).to(mesh.device)
    optimizer = make_optimizer(config, net)
    step = make_dp_train_step(config, net, mesh, optimizer)
    losses, params_by_step = [], []
    for batch in batches:
        losses.append(float(step(shard_batch(batch, mesh))))
        params_by_step.append(params_to_numpy(net))
    return {"losses": losses, "params_by_step": params_by_step,
            "params": params_by_step[-1],
            "momentum": momentum_to_numpy(net, optimizer)}


def run_cases(mesh, cases) -> dict:
    """Run ``(name, program, kwargs)`` cases in order on this rank:
    ``{name: result}``. A case that raises stops the run with ``{name:
    CaseError}``: the other ranks' next collective then fails too."""
    out = {}
    for name, program, kwargs in cases:
        try:
            out[name] = program(mesh, **kwargs)
        except Exception:  # reported per case; the other ranks time out
            out[name] = CaseError(traceback.format_exc())
            break
    return out


class CaseError(str):
    """The traceback of a case that raised on a rank."""


def case(results: list, name: str) -> list:
    """Every rank's result of case ``name`` (raises if one failed)."""
    for rank, got in enumerate(results):
        if name not in got:
            raise AssertionError(f"rank {rank} never ran {name}: an earlier "
                                 f"case failed ({sorted(got)})")
        if isinstance(got[name], CaseError):
            raise AssertionError(f"rank {rank} failed {name}:\n{got[name]}")
    return [got[name] for got in results]


def excess(got: np.ndarray, want: np.ndarray, rtol: float = 0.0) -> float:
    """Largest ``|got - want| - rtol |want|``: the atol that
    ``np.testing.assert_allclose(got, want, rtol=rtol)`` needs."""
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    return float((diff - rtol * np.abs(want.astype(np.float64))).max())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=2)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--backend", default=None,
                        help="nccl or gloo (default: nccl on cuda, gloo on "
                             "cpu); gloo lets ranks share one card")
    parser.add_argument("--timeout", type=float, default=300.0)
    args = parser.parse_args(argv)

    import torch

    from mccnn_tpu_torch.models.net import init_params, params_from_numpy
    from mccnn_tpu_torch.ops.cbca import cbca, compute_arms
    from mccnn_tpu_torch.parallel.launch import run_ranks
    from mccnn_tpu_torch.pipeline.match import match_pair
    from mccnn_tpu_torch.tools.multichip_midscale import scene
    from mccnn_tpu_torch.utils.config import MatchConfig

    n = args.ranks
    rng = np.random.default_rng(0)
    height, width, ndisp, distance = 32 * n, 48, 8, 5
    image = rng.standard_normal((height, width)).astype(np.float32)
    volume = rng.standard_normal((height, width, 8)).astype(np.float32)
    left, right, _ = scene(height, width, ndisp)
    params = init_params(0)
    config = MatchConfig(cbca_distance=distance, cbca_num_iterations_1=1,
                         cbca_num_iterations_2=2)
    cases = [
        ("collectives", collectives, {}),
        ("cbca_sharded", sharded_cbca,
         dict(volume=volume, image=image, intensity=0.8, distance=distance,
              iterations=2)),
        ("match", sharded_match,
         dict(params=params, left=left, right=right, ndisp=ndisp,
              config=config, cost_volume_method="matmul", cbca_impl="xla")),
    ]
    results = run_ranks(run_cases, n, cases, device=args.device,
                        backend=args.backend, timeout_s=args.timeout)

    sums = {r["sum"] for r in case(results, "collectives")}
    if sums != {n * (n + 1) / 2.0}:
        raise AssertionError(f"all_reduce sums {sums}")
    want = cbca(torch.from_numpy(volume),
                compute_arms(torch.from_numpy(image), 0.8, distance), 2,
                distance).numpy()
    got = np.concatenate(case(results, "cbca_sharded"))
    cbca_err = float(np.abs(got - want).max())
    if cbca_err > 1e-4:
        raise AssertionError(f"sharded CBCA off by {cbca_err}")
    device = torch.device(args.device)
    plain = match_pair(params_from_numpy(params).to(device),
                       torch.from_numpy(left).to(device),
                       torch.from_numpy(right).to(device), ndisp, config,
                       return_volumes=True, cost_volume_method="matmul",
                       cbca_impl="xla")
    plain = {key: value.cpu().numpy() for key, value in plain.items()}
    match = case(results, "match")
    # f32 volumes: atol 1e-4 and rtol 1e-6 (one ulp of the 1e9 pad lanes)
    volume_err = max(excess(r[key], plain[key][slice(*r["rows"])], 1e-6)
                     for r in match for key in ("left_volume",
                                                "right_volume"))
    maps_equal = all(np.array_equal(r[key], plain[key]) for r in match
                     for key in ("left_disparity", "right_disparity"))
    disparity_err = max(excess(r["disparity"], plain["disparity"])
                        for r in match)
    print(f"{n} ranks on {args.device}: all_reduce {sorted(sums)}, sharded "
          f"CBCA max err {cbca_err:.2e}, match volumes {volume_err:.2e} "
          f"beyond rtol 1e-6, WTA maps equal {maps_equal}, disparity "
          f"{disparity_err:.2e}")
    if volume_err > 1e-4 or not maps_equal or disparity_err > 1e-5:
        raise AssertionError("sharded match differs from match_pair")
    print("BRINGUP OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
