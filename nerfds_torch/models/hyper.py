"""Hyper-coordinate slicing surface and 3D mask field (L3), counterpart of
``nerfds_tpu/models/hyper.py``. Both are posenc(x) ⊕ embed -> small MLP
over flattened ``[N, C]`` tensors."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from nerfds_torch.models import mlp as mlp_lib
from nerfds_torch.ops import math as math_ops


class HyperSheetMLP(nn.Module):
  """The HyperNeRF 'bendy sheet': maps (x, embed) to ambient coordinates.

  ``point_dim`` is the width of ``x``: 3 for the hyper sheet's points; the
  hyper-c sheet posencs the whole ``points ⊕ viewdirs [⊕ normal]
  [⊕ reflection]`` vector (6, 9 or 12 channels). ``embed`` may be None
  (``embed_dim`` 0)."""

  def __init__(self, embed_dim: int, output_channels: int = 2,
               min_deg: int = 0, max_deg: int = 1, depth: int = 6,
               width: int = 64, skips: Tuple[int, ...] = (4,),
               use_residual: bool = False, point_dim: int = 3,
               generator=None, concat_input: bool = False):
    super().__init__()
    self.min_deg, self.max_deg = min_deg, max_deg
    self.use_residual = use_residual
    in_dim = math_ops.posenc_dim(point_dim, min_deg, max_deg) + embed_dim
    self.mlp = mlp_lib.MLP(in_dim, depth, width, skips, 'relu',
                           output_channels=output_channels,
                           output_init=mlp_lib.normal_init(1e-5),
                           generator=generator,
                           concat_input=concat_input)

  def forward(self, points: torch.Tensor, embed: Optional[torch.Tensor],
              alpha=None, dtype=None, storage_dtype=None) -> torch.Tensor:
    points_feat = math_ops.posenc(points, self.min_deg, self.max_deg,
                                  use_identity=False, alpha=alpha)
    out = self.mlp([points_feat] if embed is None else [points_feat, embed],
                   dtype=dtype, storage_dtype=storage_dtype)
    if self.use_residual:
      out = out + embed
    return out


class MaskMLP(nn.Module):
  """3D foreground-mask field over observation-space points."""

  def __init__(self, embed_dim: int, output_channels: int = 1,
               min_deg: int = 0, max_deg: int = 6, depth: int = 8,
               width: int = 128, skips: Tuple[int, ...] = (4,),
               output_activation: Optional[str] = 'relu', generator=None,
               concat_input: bool = False):
    super().__init__()
    self.min_deg, self.max_deg = min_deg, max_deg
    in_dim = math_ops.posenc_dim(3, min_deg, max_deg) + embed_dim
    self.mlp = mlp_lib.MLP(in_dim, depth, width, skips, 'relu',
                           output_channels=output_channels,
                           output_activation=output_activation,
                           output_init=mlp_lib.normal_init(1e-5),
                           generator=generator,
                           concat_input=concat_input)

  def forward(self, points: torch.Tensor, embed: torch.Tensor, alpha=None,
              use_embed: bool = True, dtype=None,
              storage_dtype=None) -> torch.Tensor:
    points_feat = math_ops.posenc(points, self.min_deg, self.max_deg,
                                  use_identity=False, alpha=alpha)
    return self.mlp([points_feat, embed] if use_embed else points_feat,
                    dtype=dtype, storage_dtype=storage_dtype)
