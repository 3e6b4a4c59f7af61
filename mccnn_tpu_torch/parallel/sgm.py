"""SGM on a row-sharded volume: the counterpart of what GSPMD inferred.

In the JAX package the sharded matcher leaves the SGM sweeps to GSPMD
(mccnn_tpu/parallel/match.py:7-11): the horizontal sweeps are parallel
over row shards and XLA reshards the volume for the vertical ones. Here
that plan is written out:

  1. the two horizontal sweeps (right, left) run on this rank's rows as
     they are: their lines are rows, their penalties row-local;
  2. ``mesh.rows_to_columns`` reshards the volume to a column shard (all
     rows, a block of columns);
  3. the two vertical sweeps (up, down) run on the column shard, K3 (or
     its plain version) reading the whole images at the shard's column
     offset (``ops/sgm.py``, ``col0``);
  4. ``mesh.columns_to_rows`` reshards back.

The chained order is the reference's (right, left, up, down,
``ops/sgm.py``). The paper mode sweeps the same input four times and
averages: two horizontal results on the rows, two vertical ones on the
columns, resharded back and summed in the unsharded order.
"""

from __future__ import annotations

import torch

from mccnn_tpu_torch.ops.sgm import _DIRECTIONS, sweep
from mccnn_tpu_torch.parallel.mesh import (
    Mesh,
    columns_to_rows,
    rows_to_columns,
    shard_rows,
)
from mccnn_tpu_torch.utils.config import MatchConfig

_HORIZONTAL = _DIRECTIONS[:2]
_VERTICAL = _DIRECTIONS[2:]


def make_sharded_sgm_fn(mesh: Mesh):
    """An ``sgm_fn(volume, left_image, right_image, choice, ndisp,
    config)`` hook: this rank's row shard of the volume and the whole
    images in, the shard after four sweeps out."""

    def fn(volume: torch.Tensor, left_image: torch.Tensor,
           right_image: torch.Tensor, choice: str, ndisp: int,
           config: MatchConfig) -> torch.Tensor:
        del ndisp  # the semantics live in the BIG_COST disparity padding
        height, width = left_image.shape
        start, stop = shard_rows(height, mesh)
        if volume.shape[:2] != (stop - start, width):
            raise ValueError(f"a shard of shape {tuple(volume.shape)} for "
                             f"rows [{start}, {stop}) of {height} x {width}")
        rows_left, rows_right = left_image[start:stop], right_image[start:stop]

        def horizontal(vol_in, vol_out, direction):
            sweep(vol_in, vol_out, rows_left, rows_right, choice, direction,
                  config)

        def vertical(vol_in, vol_out, col0, direction):
            sweep(vol_in, vol_out, left_image, right_image, choice,
                  direction, config, col0)

        if config.sgm_paper_mode:
            swept = []
            for direction in _HORIZONTAL:
                out = torch.empty_like(volume)
                horizontal(volume, out, direction)
                swept.append(out)
            columns, col0 = rows_to_columns(volume, mesh)
            for direction in _VERTICAL:
                out = torch.empty_like(columns)
                vertical(columns, out, col0, direction)
                swept.append(columns_to_rows(out, width, mesh))
            return (swept[0] + swept[1] + swept[2] + swept[3]) / 4.0
        for direction in _HORIZONTAL:
            horizontal(volume, volume, direction)
        columns, col0 = rows_to_columns(volume, mesh)
        for direction in _VERTICAL:
            vertical(columns, columns, col0, direction)
        return columns_to_rows(columns, width, mesh)

    return fn
