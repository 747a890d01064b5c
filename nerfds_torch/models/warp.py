"""SE(3) deformation field (L3), counterpart of ``SE3Field`` in
``nerfds_tpu/models/warp.py``.

The field is evaluated once per point as a screw motion
(``screw(points, embed) -> rigid.Screw``); callers apply the ``rigid``
functions to that one screw for the point warp and the normal transport.
The translation and dual-quaternion fields and ``warp_jacobian`` are not
ported yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from nerfds_torch.models import mlp as mlp_lib
from nerfds_torch.ops import math as math_ops
from nerfds_torch.ops import rigid


class SE3Field(nn.Module):
  """posenc(x) ⊕ embed -> trunk -> (w, v) heads -> screw motion."""

  def __init__(self, metadata_dim: int, min_deg: int = 0, max_deg: int = 8,
               use_posenc_identity: bool = False, trunk_depth: int = 6,
               trunk_width: int = 128, skips: Tuple[int, ...] = (4,),
               activation: str = 'relu', generator=None):
    super().__init__()
    self.min_deg, self.max_deg = min_deg, max_deg
    self.use_posenc_identity = use_posenc_identity
    in_dim = math_ops.posenc_dim(3, min_deg, max_deg,
                                 use_posenc_identity) + metadata_dim
    self.trunk = mlp_lib.MLP(in_dim, trunk_depth, trunk_width, skips,
                             activation, generator=generator)
    # Tiny uniform head init: the field starts near the identity.
    head_init = mlp_lib.uniform_init(1e-4)
    self.w = mlp_lib.Dense(trunk_width, 3, head_init, generator=generator)
    self.v = mlp_lib.Dense(trunk_width, 3, head_init, generator=generator)

  def screw(self, points: torch.Tensor, metadata_embed: torch.Tensor,
            warp_alpha=None) -> rigid.Screw:
    """Per-point screw motion. points: [N, 3]."""
    points_embed = math_ops.posenc(points, self.min_deg, self.max_deg,
                                   self.use_posenc_identity, warp_alpha)
    trunk_out = self.trunk([points_embed, metadata_embed])
    return rigid.screw_from_raw(self.w(trunk_out), self.v(trunk_out))

  motion = screw

  def warp(self, points: torch.Tensor, metadata_embed: torch.Tensor,
           warp_alpha=None) -> torch.Tensor:
    """Point warp x -> exp(θS) x."""
    return rigid.transform_point(
        self.screw(points, metadata_embed, warp_alpha), points)
