"""The port's kernels per row shard (mccnn_tpu/parallel/pallas_shard.py).

The kernels are single-device programs; these hooks run them on each
rank's rows:

  * cost volume (K1): rows are independent (the correlation spans columns
    of the same row only), so the band kernel runs on this rank's rows of
    the descriptor maps with no communication at all;
  * CBCA (K2, K4, K7, K8, K9): each pass exchanges the halo rows with the
    neighbouring ranks (``mesh.exchange_halo``, zeros at the global ends),
    runs one kernel call on the extended block and keeps the interior
    rows. The round kernels zero-fill rows beyond their block, and rows
    beyond the image carry zero arms, so the interior rows equal the whole
    volume's.

``fused2`` and ``fused2_16`` run two rounds per pass on a halo of twice the
radius, and an odd last round on a halo of one radius (K2), as the JAX
hook does. ``fused8`` quantizes once for the whole volume: the amax of
every shard is reduced to its maximum over the ranks, so every shard has
the scale of the unsharded call and the sharded result is bit-equal to it;
the passes then run raw int8 rounds (K4) and the result is dequantized.
"""

from __future__ import annotations

import torch

from mccnn_tpu_torch.ops.cbca import CrossArms
from mccnn_tpu_torch.ops.cbca_mxu import build_masks
from mccnn_tpu_torch.ops.cbca_fused import (
    _dequantize_int8,
    int8_amax,
    int8_scale,
    quantize_int8,
)
from mccnn_tpu_torch.ops.cost_volume import cost_volume_pair
from mccnn_tpu_torch.parallel.cbca import shard_arms
from mccnn_tpu_torch.pipeline.match import _CBCA_IMPLS, _cbca_aggregate
from mccnn_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce,
    exchange_halo,
    shard_rows,
)


def make_sharded_cost_volume_fn(ndisp: int, mesh: Mesh,
                                dtype: torch.dtype = torch.float32,
                                method: str = "auto"):
    """A ``cost_volume_fn(features_left, features_right, sides)`` hook: the
    whole image's descriptor maps in, this rank's rows of the ``sides``
    volume out (K1 with the band methods, torch ops with "matmul" and
    "rolldot")."""

    def fn(features_left, features_right, sides):
        start, stop = shard_rows(features_left.shape[0], mesh)
        return cost_volume_pair(features_left[start:stop],
                                features_right[start:stop], ndisp,
                                sides=sides, dtype=dtype, method=method)

    return fn


def make_sharded_cbca_fn(distance_threshold: int, mesh: Mesh,
                         impl: str = "fused"):
    """A ``cbca_fn(volume, arms, iterations)`` hook: this rank's row shard
    of the volume and the whole image's arms in, the aggregated shard out;
    one halo exchange and one kernel call per pass ("mxu": torch ops on
    the extended block). Every name of the matcher's ``cbca_impl`` runs:
    "auto" and "xla" are K2's exact f32 sums, as unsharded."""
    if impl not in _CBCA_IMPLS:
        raise ValueError(f"unknown cbca_impl {impl!r}; use one of "
                         f"{_CBCA_IMPLS}")
    aggregate = _cbca_aggregate(impl)
    radius = distance_threshold - 1
    rounds_per_pass = 2 if impl in ("fused2", "fused2_16") else 1

    def run_pass(volume, arms_h, halo, rounds, rows, **kwargs):
        extended = exchange_halo(volume, halo, mesh)
        out = aggregate(extended, arms_h, rounds, distance_threshold,
                        **kwargs)
        return out.narrow(0, halo, rows)

    def fn(volume: torch.Tensor, arms: CrossArms, num_iterations: int):
        if num_iterations == 0:
            return volume
        halo = radius * rounds_per_pass
        (start, stop), arms_h = shard_arms(arms, volume, halo, mesh)
        rows = stop - start
        scale = None
        if impl == "fused8":
            amax = all_reduce(int8_amax(volume).reshape(1), mesh, "max")[0]
            scale = int8_scale(amax)
            out = quantize_int8(volume, scale)
        else:
            out = volume
        # the "mxu" mask stacks serve every pass
        kwargs = {"masks": build_masks(arms_h)} if impl == "mxu" else {}
        n_passes, rem = divmod(num_iterations, rounds_per_pass)
        for _ in range(n_passes):
            out = run_pass(out, arms_h, halo, rounds_per_pass, rows,
                           **kwargs)
        if rem:
            # the odd round's halo is one radius: trim the arm planes
            trim = halo - radius * rem
            arms_r = CrossArms(*(p.narrow(0, trim, p.shape[0] - 2 * trim)
                                 for p in arms_h))
            out = run_pass(out, arms_r, radius * rem, rem, rows)
        if scale is not None:
            out = _dequantize_int8(out, scale, volume.dtype)
        return out

    return fn
