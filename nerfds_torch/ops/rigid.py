"""Batched rigid-body math (L0), counterpart of ``nerfds_tpu/ops/rigid.py``.

Closed Rodrigues forms over ``[..., 3]`` tensors (Modern Robotics eqns 3.51
and 3.88):
  R x = x cosθ + (w × x) sinθ + w (w·x)(1 − cosθ)
  p   = θ v + (1 − cosθ)(w × v) + (θ − sinθ)(w (w·v) − v)
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Screw(NamedTuple):
  """A batch of screw motions: unit rotation axis, translation part, angle."""
  w: torch.Tensor      # [..., 3] unit rotation axis
  v: torch.Tensor      # [..., 3] translation part of the screw axis
  theta: torch.Tensor  # [...] rotation magnitude

  @property
  def axis(self) -> torch.Tensor:
    """The 6-dim screw axis [w, v]."""
    return torch.cat([self.w, self.v], dim=-1)


def screw_from_raw(w_raw: torch.Tensor, v_raw: torch.Tensor,
                   eps: float = 1e-12) -> Screw:
  """Normalises raw (w, v) MLP outputs into a screw, θ = ‖w‖.

  The ``eps`` clamp turns an exact-zero ``w_raw`` row into the identity
  instead of NaN. At such a row the gradient of ‖w‖ differs between
  frameworks (torch gives 0, JAX NaN), so parity tests keep rows nonzero.
  """
  theta = torch.linalg.vector_norm(w_raw, dim=-1)
  denom = torch.clamp(theta, min=eps)[..., None]
  return Screw(w=w_raw / denom, v=v_raw / denom, theta=theta)


def _cross(a, b):
  return torch.linalg.cross(a, b, dim=-1)


def rotate(screw: Screw, x: torch.Tensor) -> torch.Tensor:
  """Applies R = exp(θ[w]ₓ) to vectors x, Rodrigues form."""
  theta = screw.theta[..., None]
  cos, sin = torch.cos(theta), torch.sin(theta)
  w = screw.w
  return (x * cos + _cross(w, x) * sin
          + w * (w * x).sum(-1, keepdim=True) * (1.0 - cos))


def rotate_inverse(screw: Screw, x: torch.Tensor) -> torch.Tensor:
  """Applies Rᵀ to vectors x (rotation by −θ about the same axis)."""
  theta = screw.theta[..., None]
  cos, sin = torch.cos(theta), torch.sin(theta)
  w = screw.w
  return (x * cos - _cross(w, x) * sin
          + w * (w * x).sum(-1, keepdim=True) * (1.0 - cos))


def translation(screw: Screw) -> torch.Tensor:
  """p = (θI + (1−cosθ)[w]ₓ + (θ−sinθ)[w]ₓ²) v."""
  theta = screw.theta[..., None]
  cos, sin = torch.cos(theta), torch.sin(theta)
  w, v = screw.w, screw.v
  wxv = _cross(w, v)
  wwv = w * (w * v).sum(-1, keepdim=True) - v  # [w]ₓ² v
  return theta * v + (1.0 - cos) * wxv + (theta - sin) * wwv


def transform_point(screw: Screw, x: torch.Tensor) -> torch.Tensor:
  """Full SE(3) action R x + p."""
  return rotate(screw, x) + translation(screw)
