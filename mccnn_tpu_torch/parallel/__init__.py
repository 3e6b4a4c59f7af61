"""Sharded matching and data-parallel training over torch.distributed
ranks (mccnn_tpu/parallel/)."""

from mccnn_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from mccnn_tpu_torch.parallel.train import (  # noqa: F401
    make_dp_train_step,
    shard_batch,
)
from mccnn_tpu_torch.parallel.match import make_sharded_match  # noqa: F401
