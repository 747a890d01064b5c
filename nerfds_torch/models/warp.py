"""Deformation (warp) fields (L3), counterparts of ``SE3Field``,
``DualQuaternionField`` and ``TranslationField`` in
``nerfds_tpu/models/warp.py``.

The rigid fields are evaluated once per point as a motion
(``motion(points, embed)``: a ``rigid.Screw`` or a
``dual_quaternion.DualQuatMotion``); callers apply the ``rigid`` functions
to that one motion for the point warp and the normal transport. Every field
has ``warp`` and ``warp_jacobian`` (``rigid.batched_jacobian``).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from nerfds_torch.models import mlp as mlp_lib
from nerfds_torch.ops import dual_quaternion as dq_lib
from nerfds_torch.ops import math as math_ops
from nerfds_torch.ops import quaternion as quaternion_ops
from nerfds_torch.ops import rigid


class SE3Field(nn.Module):
  """posenc(x) ⊕ embed -> trunk -> (w, v) heads -> screw motion."""

  def __init__(self, metadata_dim: int, min_deg: int = 0, max_deg: int = 8,
               use_posenc_identity: bool = False, trunk_depth: int = 6,
               trunk_width: int = 128, skips: Tuple[int, ...] = (4,),
               activation: str = 'relu', generator=None,
               concat_input: bool = False):
    super().__init__()
    self.min_deg, self.max_deg = min_deg, max_deg
    self.use_posenc_identity = use_posenc_identity
    in_dim = math_ops.posenc_dim(3, min_deg, max_deg,
                                 use_posenc_identity) + metadata_dim
    self.trunk = mlp_lib.MLP(in_dim, trunk_depth, trunk_width, skips,
                             activation, generator=generator,
                             concat_input=concat_input)
    # Tiny uniform head init: the field starts near the identity.
    head_init = mlp_lib.uniform_init(1e-4)
    self.w = mlp_lib.Dense(trunk_width, 3, head_init, generator=generator)
    self.v = mlp_lib.Dense(trunk_width, 3, head_init, generator=generator)

  def screw(self, points: torch.Tensor, metadata_embed: torch.Tensor,
            warp_alpha=None, dtype=None, storage_dtype=None) -> rigid.Screw:
    """Per-point screw motion. points: [N, 3]. ``dtype`` and
    ``storage_dtype`` apply to the MLPs (``models/mlp.py``); the screw math
    runs in float32 whatever they are."""
    points_embed = math_ops.posenc(points, self.min_deg, self.max_deg,
                                   self.use_posenc_identity, warp_alpha)
    trunk_out = self.trunk([points_embed, metadata_embed], dtype=dtype,
                           storage_dtype=storage_dtype)
    w = mlp_lib.dense_apply(self.w, trunk_out, dtype)
    v = mlp_lib.dense_apply(self.v, trunk_out, dtype)
    return rigid.screw_from_raw(w.float(), v.float())

  motion = screw

  def warp(self, points: torch.Tensor, metadata_embed: torch.Tensor,
           warp_alpha=None, dtype=None, storage_dtype=None) -> torch.Tensor:
    """Point warp x -> exp(θS) x."""
    return rigid.transform_point(
        self.screw(points, metadata_embed, warp_alpha, dtype, storage_dtype),
        points)

  def warp_jacobian(self, points: torch.Tensor, metadata_embed: torch.Tensor,
                    warp_alpha=None) -> torch.Tensor:
    """∂warp/∂x, ``[N, 3, 3]``, in float32."""
    return rigid.batched_jacobian(
        lambda p: self.warp(p, metadata_embed, warp_alpha), points)


class DualQuaternionField(nn.Module):
  """The SE(3) field's trunk with heads for a rotation quaternion increment
  (4) and a translation (3), joined into a unit dual quaternion. The tiny
  head init starts the field near the identity."""

  def __init__(self, metadata_dim: int, min_deg: int = 0, max_deg: int = 8,
               use_posenc_identity: bool = False, trunk_depth: int = 6,
               trunk_width: int = 128, skips: Tuple[int, ...] = (4,),
               activation: str = 'relu', generator=None,
               concat_input: bool = False):
    super().__init__()
    self.min_deg, self.max_deg = min_deg, max_deg
    self.use_posenc_identity = use_posenc_identity
    in_dim = math_ops.posenc_dim(3, min_deg, max_deg,
                                 use_posenc_identity) + metadata_dim
    self.trunk = mlp_lib.MLP(in_dim, trunk_depth, trunk_width, skips,
                             activation, generator=generator,
                             concat_input=concat_input)
    head_init = mlp_lib.uniform_init(1e-4)
    self.q = mlp_lib.Dense(trunk_width, 4, head_init, generator=generator)
    self.t = mlp_lib.Dense(trunk_width, 3, head_init, generator=generator)

  def motion(self, points: torch.Tensor, metadata_embed: torch.Tensor,
             warp_alpha=None, dtype=None,
             storage_dtype=None) -> dq_lib.DualQuatMotion:
    """Per-point unit dual quaternion; its math runs in float32."""
    points_embed = math_ops.posenc(points, self.min_deg, self.max_deg,
                                   self.use_posenc_identity, warp_alpha)
    trunk_out = self.trunk([points_embed, metadata_embed], dtype=dtype,
                           storage_dtype=storage_dtype)
    q_raw = mlp_lib.dense_apply(self.q, trunk_out, dtype).float()
    t = mlp_lib.dense_apply(self.t, trunk_out, dtype).float()
    # The identity offset on the real part, then a unit quaternion.
    q = quaternion_ops.normalize(
        q_raw + quaternion_ops.identity(q_raw.dtype, q_raw.device))
    return dq_lib.DualQuatMotion(dq_lib.from_rotation_translation(q, t))

  screw = motion

  def warp(self, points: torch.Tensor, metadata_embed: torch.Tensor,
           warp_alpha=None, dtype=None, storage_dtype=None) -> torch.Tensor:
    return self.motion(points, metadata_embed, warp_alpha, dtype,
                       storage_dtype).transform_point(points)

  def warp_jacobian(self, points: torch.Tensor, metadata_embed: torch.Tensor,
                    warp_alpha=None) -> torch.Tensor:
    return rigid.batched_jacobian(
        lambda p: self.warp(p, metadata_embed, warp_alpha), points)


class TranslationField(nn.Module):
  """Nerfies-style translation-only warp: x -> x + MLP(posenc(x) ⊕ embed).
  It has no motion object, so the model applies no normal transport."""

  def __init__(self, metadata_dim: int, min_deg: int = 0, max_deg: int = 8,
               use_posenc_identity: bool = True, depth: int = 6,
               width: int = 128, skips: Tuple[int, ...] = (4,),
               activation: str = 'relu', generator=None,
               concat_input: bool = False):
    super().__init__()
    self.min_deg, self.max_deg = min_deg, max_deg
    self.use_posenc_identity = use_posenc_identity
    in_dim = math_ops.posenc_dim(3, min_deg, max_deg,
                                 use_posenc_identity) + metadata_dim
    self.mlp = mlp_lib.MLP(in_dim, depth, width, skips, activation,
                           output_channels=3,
                           output_init=mlp_lib.uniform_init(1e-4),
                           generator=generator,
                           concat_input=concat_input)

  def warp(self, points: torch.Tensor, metadata_embed: torch.Tensor,
           warp_alpha=None, dtype=None, storage_dtype=None) -> torch.Tensor:
    points_embed = math_ops.posenc(points, self.min_deg, self.max_deg,
                                   self.use_posenc_identity, warp_alpha)
    translation = self.mlp([points_embed, metadata_embed], dtype=dtype,
                           storage_dtype=storage_dtype)
    return points + translation.float()

  def warp_jacobian(self, points: torch.Tensor, metadata_embed: torch.Tensor,
                    warp_alpha=None) -> torch.Tensor:
    return rigid.batched_jacobian(
        lambda p: self.warp(p, metadata_embed, warp_alpha), points)
