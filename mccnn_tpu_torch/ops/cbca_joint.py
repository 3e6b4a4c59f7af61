"""Disparity-conditioned joint-region CBCA, the paper's full variant
(mccnn_tpu/ops/cbca_joint.py, ``MatchConfig.cbca_joint_regions``).

At disparity d, a member q = (h_, w_) of p = (h, w)'s support region
survives iff

  * q has no correspondent (left volume: ``w_ < d``; right: ``w_ + d >= W``),
    or
  * q's correspondent lies in the support region, in the OTHER image, of
    p's correspondent (left volume: ``(h_, w_ - d)`` in region_R(h, w - d)).

Pixels whose own correspondent is out of range keep their raw region. The
average runs over the surviving members. With offsets (ov, oh) membership
factors as ``gLv(ov) gLh(oh) [B(oh) + (1 - B(oh)) gRv(ov) gRh(oh)]`` (own
arm gates, the other image's arm gates probed at the correspondent column,
and the no-correspondent test B), so each disparity aggregates with gated
horizontal-then-vertical stencils, as in the JAX package.

Torch ops only. The JAX version loops over disparities; here a chunk of
disparities is processed at once as (H, W, chunk) tensors, each element
summed in the JAX order (offset 0, then +1, -1, +2, -2, ...), so the values
are the same and the op count per round does not grow with ``ndisp``.
Lanes d >= ndisp are aggregated over the plain regions.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from mccnn_tpu_torch.ops.cbca import CrossArms, cbca

_DISPARITY_CHUNK = 32  # disparities per (H, W, chunk) working set


def _probe_columns(plane: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """(H, W, n): plane[h, w + shifts[n]], -1 where the column is outside."""
    width = plane.shape[1]
    cols = torch.arange(width, device=plane.device)[:, None] + shifts[None, :]
    inside = (cols >= 0) & (cols < width)
    probed = plane[:, cols.clamp(0, width - 1)]
    return torch.where(inside, probed, -1)


def _shifted(block: torch.Tensor, dim: int, offset: int,
             radius: int) -> torch.Tensor:
    """block[... i + offset ...] along ``dim`` (0 or 1), 0 outside."""
    pad = [0, 0] * block.ndim
    at = 2 * (block.ndim - 1 - dim)
    pad[at] = pad[at + 1] = radius
    return F.pad(block, pad).narrow(dim, radius + offset, block.shape[dim])


def cbca_joint(volume: torch.Tensor, arms_self: CrossArms,
               arms_other: CrossArms, num_iterations: int,
               distance_threshold: int, ndisp: int,
               choice: str) -> torch.Tensor:
    """Aggregate an (H, W, D) volume over disparity-conditioned regions.

    ``arms_self`` are the arms of the volume's own image (the left image
    for the left volume), ``arms_other`` the other image's; ``choice`` is
    "L" or "R".
    """
    if num_iterations == 0:
        return volume
    height, width, _ = volume.shape
    radius = distance_threshold - 1
    sign = -1 if choice == "L" else +1
    cols = torch.arange(width, device=volume.device)[None, :, None]

    def gated_hsum(block, gate):
        acc = torch.where(gate(0), block, 0.0)
        for oh in range(1, radius + 1):
            acc = acc + torch.where(gate(oh), _shifted(block, 1, oh, radius),
                                    0.0)
            acc = acc + torch.where(gate(-oh),
                                    _shifted(block, 1, -oh, radius), 0.0)
        return acc

    def gated_vsum(mid, up_arm, down_arm):
        acc = mid
        for ov in range(1, radius + 1):
            acc = acc + torch.where(down_arm >= ov,
                                    _shifted(mid, 0, ov, radius), 0.0)
            acc = acc + torch.where(up_arm >= ov,
                                    _shifted(mid, 0, -ov, radius), 0.0)
        return acc

    def joint_lanes(block, disps):
        """The joint-region average of lanes ``disps`` ((H, W, n) f32)."""
        d = disps[None, None, :]
        oth = CrossArms(*(_probe_columns(a, sign * disps)
                          for a in arms_other))
        own_up = arms_self.up[..., None]
        own_down = arms_self.down[..., None]

        def border(oh):  # the member has no correspondent
            if choice == "L":
                return cols + oh < d
            return cols + oh + d >= width

        def own_h(oh):
            arm = arms_self.right if oh >= 0 else arms_self.left
            return (arm >= abs(oh))[..., None]

        def oth_h(oh):
            return (oth.right if oh >= 0 else oth.left) >= abs(oh)

        def gate_border(oh):
            return own_h(oh) & border(oh)

        def gate_joint(oh):
            return own_h(oh) & oth_h(oh) & ~border(oh)

        def gate_plain(oh):
            return own_h(oh).expand(block.shape)

        ones = torch.ones_like(block)
        # term 1: members kept by the no-correspondent rule (own vertical)
        t1 = gated_vsum(gated_hsum(block, gate_border), own_up, own_down)
        n1 = gated_vsum(gated_hsum(ones, gate_border), own_up, own_down)
        # term 2: members kept by joint membership (own AND other vertical)
        joint_up = torch.minimum(own_up, oth.up.clamp(min=0))
        joint_down = torch.minimum(own_down, oth.down.clamp(min=0))
        t2 = gated_vsum(gated_hsum(block, gate_joint), joint_up, joint_down)
        n2 = gated_vsum(gated_hsum(ones, gate_joint), joint_up, joint_down)
        out = (t1 + t2) / torch.clamp(n1 + n2, min=1.0)
        # pixels whose own correspondent is out of range keep the raw region
        raw_pixel = (cols < d) if choice == "L" else (cols + d >= width)
        plain = gated_vsum(gated_hsum(block, gate_plain), own_up, own_down)
        plain_n = gated_vsum(gated_hsum(ones, gate_plain), own_up, own_down)
        return torch.where(raw_pixel, plain / plain_n, out)

    for _ in range(num_iterations):
        # real disparities get joint regions; pad lanes keep plain regions
        out = cbca(volume, arms_self, 1, distance_threshold)
        for start in range(0, ndisp, _DISPARITY_CHUNK):
            stop = min(start + _DISPARITY_CHUNK, ndisp)
            disps = torch.arange(start, stop, device=volume.device)
            out[:, :, start:stop] = joint_lanes(
                volume[:, :, start:stop].float(), disps).to(volume.dtype)
        volume = out
    return volume
