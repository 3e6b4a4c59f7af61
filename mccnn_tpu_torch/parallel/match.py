"""Sharded matching: row-sharded cost volumes over the ranks of a mesh
(mccnn_tpu/parallel/match.py).

The cost volume is the memory problem of this system (2 volumes x ndisp x
H x W values; the reference's only answer was a commented-out quadrant
fallback, reference: src/process_functional.py:46-60). Here each rank holds
H / N rows of each volume:

  * every rank receives the whole standardized images (small) and returns
    the whole disparity map;
  * the descriptor maps and the CBCA arms are computed on the whole images
    on every rank and cut to the rank's rows, so they equal the unsharded
    ones bit for bit (the convolutions are repeated on every rank);
  * the cost volume runs K1 on the rank's rows (``pallas_shard.py``), the
    CBCA passes exchange their halo rows and run the round kernels on the
    extended blocks (``pallas_shard.py``), the SGM sweeps reshard rows to
    columns and back around the vertical sweeps (``sgm.py``), and WTA runs
    on the rank's rows;
  * the two WTA maps are gathered before the LR check, which searches
    across rows; subpixel runs on the rank's rows against its own shard of
    the left volume, and the median and bilateral filters on the gathered
    map.

The stage order is ``pipeline/match.py::match_pair``'s (right volume first;
CBCA 1, SGM, CBCA 2, WTA), driven through its hooks. ``cbca_chunk_d`` does
not apply (as under the JAX package's ``cbca_fn``).

``MatchConfig.cbca_joint_regions`` is read as the JAX package reads it:
with a kernel impl (its list below) the CBCA hook takes precedence and the
flag is not read; with "auto", "xla" or "mxu", where the JAX package has
no hook and GSPMD partitions ``cbca_joint``, each rank runs
``parallel/cbca.py::cbca_joint_sharded`` on its halo-extended block.
"""

from __future__ import annotations

import functools

import torch

from mccnn_tpu_torch.models.net import FeatureNet
from mccnn_tpu_torch.parallel.cbca import cbca_joint_sharded
from mccnn_tpu_torch.parallel.mesh import Mesh, gather_rows, shard_rows
from mccnn_tpu_torch.parallel.pallas_shard import (
    make_sharded_cbca_fn,
    make_sharded_cost_volume_fn,
)
from mccnn_tpu_torch.parallel.sgm import make_sharded_sgm_fn
from mccnn_tpu_torch.pipeline.match import _VOLUME_DTYPES, match_pair
from mccnn_tpu_torch.utils.config import MatchConfig

# the JAX package's CBCA impls that run through its shard_map hook
# (mccnn_tpu/parallel/match.py); the joint-region flag is not read for them
KERNEL_CBCA_IMPLS = ("fused", "fused16", "fused8", "fused2", "fused2_16",
                     "pallas", "rolling", "rolling16")


class RowShards:
    """This rank's rows of an H-row image: ``local(whole)`` cuts them,
    ``gather(local)`` rebuilds the whole array on every rank."""

    def __init__(self, height: int, mesh: Mesh):
        self.mesh = mesh
        self.start, self.stop = shard_rows(height, mesh)

    def local(self, whole: torch.Tensor) -> torch.Tensor:
        return whole[self.start:self.stop]

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        return gather_rows(local, self.mesh)


def make_sharded_match(ndisp: int, config: MatchConfig, mesh: Mesh,
                       cost_volume_method: str = "pallas",
                       cbca_impl: str = "fused",
                       volume_dtype: str = "float32",
                       return_volumes: bool = False):
    """``fn(net, left, right)``: the whole (H, W) standardized pair on this
    rank's device in, the whole disparity map out, with row-sharded
    volumes. H must divide over the ranks, and a shard must be at least a
    CBCA halo high (``pallas_shard.py``).

    ``cost_volume_method`` "pallas" (or "auto") builds the volumes with K1,
    "matmul" and "rolldot" with torch ops; ``cbca_impl`` takes the
    matcher's names. With ``return_volumes`` the result is a dict: the
    disparity, the whole WTA maps, this rank's rows of the pre-WTA volumes
    and their ``rows`` range ``(start, stop)``.

    With ``config.cbca_joint_regions`` a kernel impl
    (``KERNEL_CBCA_IMPLS``) aggregates as without the flag, as in the JAX
    package; "auto", "xla" and "mxu" aggregate over joint regions.
    """
    cost_volume_fn = make_sharded_cost_volume_fn(
        ndisp, mesh, _VOLUME_DTYPES[volume_dtype], cost_volume_method)
    cbca_fn = make_sharded_cbca_fn(int(config.cbca_distance), mesh,
                                   cbca_impl)
    cbca_joint_fn = None
    if config.cbca_joint_regions and cbca_impl not in KERNEL_CBCA_IMPLS:
        cbca_fn = None
        cbca_joint_fn = functools.partial(cbca_joint_sharded, mesh=mesh)
    sgm_fn = make_sharded_sgm_fn(mesh)

    def sharded_match(net: FeatureNet, left_image: torch.Tensor,
                      right_image: torch.Tensor):
        rows = RowShards(left_image.shape[0], mesh)
        out = match_pair(
            net, left_image, right_image, ndisp, config,
            volume_dtype=volume_dtype, cbca_impl=cbca_impl,
            return_volumes=return_volumes,
            cost_volume_method=cost_volume_method,
            cost_volume_fn=cost_volume_fn, cbca_fn=cbca_fn,
            cbca_joint_fn=cbca_joint_fn, sgm_fn=sgm_fn, rows=rows)
        if return_volumes:
            out["rows"] = (rows.start, rows.stop)
        return out

    return sharded_match
