"""Hyperparameter configs (the port's own copy of mccnn_tpu/utils/config.py).

Field for field the JAX package's dataclasses, so a config written for
one package drives the other.

Defaults are the paper's Middlebury values, identical to the reference's
argparse/ctor defaults (reference: src/model.py:14-16, src/match.py:31-43,
src/train.py:17-33, src/datagenerator.py:17-24).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class NetConfig:
    """Fast-architecture Siamese net (reference: src/model.py:11-31)."""

    patch_size: int = 11
    num_layers: int = 5
    num_maps: int = 64
    kernel_size: int = 3
    input_channels: int = 1
    groups: int = 1  # grouped conv (reference supports it, never uses >1)

    @property
    def receptive_field(self) -> int:
        """Total spatial shrinkage of the VALID conv stack (patch -> 1x1)."""
        return self.num_layers * (self.kernel_size - 1)


@dataclass(frozen=True)
class MatchConfig:
    """Full matching-pipeline hyperparameters (reference: src/match.py:31-43).

    ``sgm_paper_mode=False`` reproduces the reference's actual behavior: the
    four SGM directional sweeps share one buffer and run *sequentially
    in-place* (reference: src/process_functional.py:544 aliases instead of
    copying, so the 'average' at :210 averages four references to the same
    array). ``True`` gives the paper's independent-direction average.
    """

    cbca_intensity: float = 0.02
    cbca_distance: int = 14
    cbca_num_iterations_1: int = 2
    cbca_num_iterations_2: int = 16
    sgm_p1: float = 2.3
    sgm_p2: float = 55.9
    sgm_q1: float = 4.0
    sgm_q2: float = 8.0
    sgm_d: float = 0.08
    sgm_v: float = 1.5
    blur_sigma: float = 6.0
    blur_threshold: float = 2.0
    median_filter_size: int = 5
    bilateral_filter_size: int = 5
    sgm_paper_mode: bool = False
    # the JAX package's scan-unroll knob (lines per SGM scan step,
    # semantics-neutral); kept so configs stay interchangeable, unused by
    # the port, whose sweep is one kernel launch
    sgm_chunk: int = 0
    # precompute the SGM penalty scales as a uint8 code volume per
    # direction (ops/sgm.py::penalty_scale_u8); the same predicate, so the
    # same result bit for bit
    sgm_u8: bool = False
    # the paper's disparity-conditioned joint-region CBCA (present but
    # disabled in the reference, src/process_functional.py:122-144,661-729);
    # see ops/cbca_joint.py for the semantics and documented deviations
    cbca_joint_regions: bool = False

    def replace(self, **kw) -> "MatchConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (reference: src/train.py:17-33)."""

    batch_size: int = 128
    margin: float = 0.2
    learning_rate: float = 0.002
    beta: float = 0.9  # momentum
    start_epoch: int = 0
    end_epoch: int = 14
    print_freq: int = 10
    save_freq: int = 1
    val_freq: int = 1
    # triplet sampling policy (reference: src/datagenerator.py:17-24)
    dataset_pos: float = 0.5
    dataset_neg_low: float = 1.5
    dataset_neg_high: float = 6.0

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
