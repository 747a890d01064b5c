"""Skeleton (bone) warp field (L3), counterpart of
``nerfds_tpu/models/bones.py``.

Per-bone SE(3) screws from an MLP over (one-hot bone id ⊕ warp embedding);
the bones' Gaussians, carried by those screws, give each point Mahalanobis
skinning probabilities and their softmax weights; the point's inverse warps
by each bone are blended by them (inverse LBS), and a moving-mask MLP gates
the blend against the identity. Everything is batched as ``[N, B, ...]``,
the JAX package's corrected batched form of its reference.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from nerfds_torch.models import mlp as mlp_lib
from nerfds_torch.ops import quaternion, rigid


def bone_probs(points: torch.Tensor, bone_centers: torch.Tensor,
               bone_scales: torch.Tensor, bone_rotations: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
  """Gaussian membership ``[N, B]`` of ``points [N, 3]`` in oriented bones:
  centres ``[N, B, 3]``, variances ``bone_scales [B, 3]`` and rotations
  ``[N, B, 3, 3]``."""
  delta = points[:, None, :] - bone_centers                       # N, B, 3
  delta = torch.einsum('nbij,nbi->nbj', bone_rotations, delta)    # Rᵀ δ
  scales = bone_scales.abs() + eps                                # B, 3
  m_sq = (delta ** 2 / scales[None]).sum(-1)                      # N, B
  normalizer = 1.0 / torch.sqrt(2 * math.pi * scales.prod(-1))
  return normalizer[None] * torch.exp(-0.5 * m_sq)


class BoneSE3Field(nn.Module):
  """Per-bone rigid motion, Mahalanobis skinning and a moving-mask gate.
  ``metadata_dim``: the width of the warp embedding (with its mask channel
  where the model adds one)."""

  def __init__(self, metadata_dim: int, num_bones: int = 3,
               trunk_depth: int = 4, trunk_width: int = 32,
               skips: Tuple[int, ...] = (4,), moving_mlp_depth: int = 6,
               moving_mlp_width: int = 128, generator=None):
    super().__init__()
    self.num_bones = num_bones
    self.trunk = mlp_lib.MLP(num_bones + metadata_dim, trunk_depth,
                             trunk_width, skips, generator=generator)
    head_init = mlp_lib.uniform_init(1e-4)
    self.w = mlp_lib.Dense(trunk_width, 3, head_init, generator=generator)
    self.v = mlp_lib.Dense(trunk_width, 3, head_init, generator=generator)
    self.bone_centers = nn.Parameter(torch.empty(num_bones, 3))
    self.bone_scales = nn.Parameter(torch.empty(num_bones, 3))
    self.bone_quaternions = nn.Parameter(torch.empty(num_bones, 4))
    for p in (self.bone_centers, self.bone_scales, self.bone_quaternions):
      mlp_lib.glorot_uniform(p, generator)
    self.moving_mlp = mlp_lib.MLP(3 + metadata_dim, moving_mlp_depth,
                                  moving_mlp_width, output_channels=1,
                                  output_init=head_init, generator=generator)

  def bone_screws(self, metadata_embed: torch.Tensor) -> rigid.Screw:
    """Per-(point, bone) screws ``[N, B]`` from one-hot bone id ⊕ embed."""
    n, b = metadata_embed.shape[0], self.num_bones
    bone_idx = torch.eye(b, dtype=metadata_embed.dtype,
                         device=metadata_embed.device).expand(n, b, b)
    embed = metadata_embed[:, None, :].expand(n, b, metadata_embed.shape[-1])
    flat = torch.cat([bone_idx, embed], -1).reshape(n * b, -1)
    trunk_out = self.trunk(flat)
    screw = rigid.screw_from_raw(mlp_lib.dense_apply(self.w, trunk_out),
                                 mlp_lib.dense_apply(self.v, trunk_out))
    return rigid.Screw(*(x.reshape(n, b, *x.shape[1:]) for x in screw))

  def moving_mask(self, points: torch.Tensor,
                  metadata_embed: torch.Tensor) -> torch.Tensor:
    """σ(MLP(points ⊕ embed)), ``[N, 1]``."""
    return torch.sigmoid(self.moving_mlp(torch.cat([points, metadata_embed],
                                                   -1)))

  def warp(self, points: torch.Tensor, metadata_embed: torch.Tensor
           ) -> Dict[str, torch.Tensor]:
    """Inverse-LBS warp of observation points ``[N, 3]`` into canonical
    space: ``warped_points [N, 3]``, ``bone_weights [N, B]`` and
    ``moving_mask [N, 1]``."""
    n, b = points.shape[0], self.num_bones
    screws = self.bone_screws(metadata_embed)                     # N, B
    # The bones carried forward by the screws, for the skinning weights.
    centers = self.bone_centers[None].expand(n, b, 3)
    warped_centers = rigid.transform_point(screws, centers)
    base_rot = quaternion.to_rotation_matrix(
        quaternion.normalize(self.bone_quaternions))              # B, 3, 3
    eye = torch.eye(3, dtype=points.dtype, device=points.device)
    screw_rot = torch.stack(
        [rigid.rotate(screws, eye[i].expand(n, b, 3)) for i in range(3)],
        dim=-1)
    warped_rot = torch.einsum('nbij,bjk->nbik', screw_rot, base_rot)
    weights = torch.softmax(
        bone_probs(points, warped_centers, self.bone_scales, warped_rot),
        dim=-1)                                                   # N, B
    # The point warped back by each bone, blended by the weights.
    back = rigid.transform_point_inverse(
        screws, points[:, None, :].expand(n, b, 3))               # N, B, 3
    blended = (weights[..., None] * back).sum(1)                  # N, 3
    moving = self.moving_mask(points, metadata_embed)
    warped = moving * blended + (1.0 - moving) * points
    return {'warped_points': warped, 'bone_weights': weights,
            'moving_mask': moving}
