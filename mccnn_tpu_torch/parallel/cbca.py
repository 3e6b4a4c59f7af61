"""Row-sharded CBCA with an explicit halo exchange
(mccnn_tpu/parallel/cbca.py).

The volume is sharded over rows; each aggregation round exchanges exactly
the radius rows with the neighbouring ranks (``mesh.exchange_halo``, zeros
at the global ends, the ``lax.ppermute`` convention) and then runs the
separable torch stencil of ``ops/cbca.py`` on the extended block, keeping
its interior rows. The arms are computed on the whole image on every rank
(two int planes, small beside the volume), so their halos are cut from them
and never exchanged; rows beyond the image are zero arms, which aggregate
nothing, as the JAX package's zero-filled halos do.

This is the template of ``parallel/pallas_shard.py``, which runs the CUDA
round kernels per shard the same way, and of ``cbca_joint_sharded``, the
joint-region CBCA (``ops/cbca_joint.py``) per shard, which GSPMD
partitions in the JAX package.
"""

from __future__ import annotations

import torch

from mccnn_tpu_torch.ops.cbca import CrossArms, _arm_stencil_sum
from mccnn_tpu_torch.ops.cbca_joint import cbca_joint
from mccnn_tpu_torch.parallel.mesh import Mesh, exchange_halo, shard_rows


def halo_rows(plane: torch.Tensor, start: int, stop: int,
              halo: int) -> torch.Tensor:
    """Rows ``start - halo .. stop + halo - 1`` of a whole-image plane,
    zeros where they lie beyond the image."""
    height = plane.shape[0]
    lo, hi = max(0, start - halo), min(height, stop + halo)
    out = plane.new_zeros((stop - start + 2 * halo, *plane.shape[1:]))
    out[lo - (start - halo):hi - (start - halo)] = plane[lo:hi]
    return out


def shard_arms(arms: CrossArms, volume: torch.Tensor, halo: int,
               mesh: Mesh) -> tuple:
    """Check a row shard against the whole image's arms; return this
    rank's ``(start, stop)`` rows and the arms of its halo-extended block.
    The checks are the JAX package's: H divides over the ranks, and a
    shard is at least a halo high."""
    height = arms.up.shape[0]
    start, stop = shard_rows(height, mesh)
    if volume.shape[0] != stop - start:
        raise ValueError(f"a shard of {volume.shape[0]} rows for rows "
                         f"[{start}, {stop}) of {height}")
    if stop - start < halo:
        raise ValueError(f"shard height {stop - start} smaller than the "
                         f"halo {halo}")
    return (start, stop), CrossArms(
        *(halo_rows(plane, start, stop, halo) for plane in arms))


def cbca_sharded(volume: torch.Tensor, arms: CrossArms, num_iterations: int,
                 distance_threshold: int, mesh: Mesh) -> torch.Tensor:
    """Aggregate this rank's row shard ``volume`` (H / N, W, D) of an f32
    cost volume; ``arms`` are the whole image's. Semantics ==
    ``ops.cbca.cbca`` on the whole volume."""
    if num_iterations == 0:
        return volume
    radius = distance_threshold - 1
    (start, stop), arms_h = shard_arms(arms, volume, radius, mesh)
    rows = stop - start
    # the region normalizer needs the halo'd horizontal counts
    h_count = halo_rows((arms.left + arms.right + 1).float(), start, stop,
                        radius)
    region = _arm_stencil_sum(h_count, arms_h.up, arms_h.down, 0,
                              distance_threshold).narrow(0, radius, rows)
    inv_region = (1.0 / region)[..., None]
    for _ in range(num_iterations):
        extended = exchange_halo(volume, radius, mesh)
        mid = _arm_stencil_sum(extended, arms_h.left, arms_h.right, 1,
                               distance_threshold)
        out = _arm_stencil_sum(mid, arms_h.up, arms_h.down, 0,
                               distance_threshold).narrow(0, radius, rows)
        volume = out * inv_region
    return volume


def cbca_joint_sharded(volume: torch.Tensor, arms_self: CrossArms,
                       arms_other: CrossArms, num_iterations: int,
                       distance_threshold: int, ndisp: int, choice: str,
                       mesh: Mesh) -> torch.Tensor:
    """Aggregate this rank's row shard ``volume`` over joint regions;
    ``arms_self`` and ``arms_other`` are the whole images' arms. Semantics
    == ``ops.cbca_joint.cbca_joint`` on the whole volume.

    A round reads rows up to the radius away through the vertical arms
    and nothing across rows otherwise (the other image's arms are probed
    along the row), so each round exchanges the radius rows and runs
    ``cbca_joint`` on the extended block with both images' halo-extended
    arms, keeping its interior rows.
    """
    if num_iterations == 0:
        return volume
    radius = distance_threshold - 1
    (start, stop), own = shard_arms(arms_self, volume, radius, mesh)
    other = CrossArms(*(halo_rows(plane, start, stop, radius)
                        for plane in arms_other))
    for _ in range(num_iterations):
        extended = exchange_halo(volume, radius, mesh)
        volume = cbca_joint(extended, own, other, 1, distance_threshold,
                            ndisp, choice).narrow(0, radius, stop - start)
    return volume
