"""Batched rigid-body math (L0), counterpart of ``nerfds_tpu/ops/rigid.py``.

Closed Rodrigues forms over ``[..., 3]`` tensors (Modern Robotics eqns 3.51
and 3.88):
  R x = x cosθ + (w × x) sinθ + w (w·x)(1 − cosθ)
  p   = θ v + (1 − cosθ)(w × v) + (θ − sinθ)(w (w·v) − v)

The appliers take a :class:`Screw`, or any motion object with the same
methods (``ops.dual_quaternion.DualQuatMotion``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

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


def rotate(screw, x: torch.Tensor) -> torch.Tensor:
  """Applies R = exp(θ[w]ₓ) to vectors x, Rodrigues form."""
  if not isinstance(screw, Screw):
    return screw.rotate(x)
  theta = screw.theta[..., None]
  cos, sin = torch.cos(theta), torch.sin(theta)
  w = screw.w
  return (x * cos + _cross(w, x) * sin
          + w * (w * x).sum(-1, keepdim=True) * (1.0 - cos))


def rotate_inverse(screw, x: torch.Tensor) -> torch.Tensor:
  """Applies Rᵀ to vectors x (rotation by −θ about the same axis)."""
  if not isinstance(screw, Screw):
    return screw.rotate_inverse(x)
  theta = screw.theta[..., None]
  cos, sin = torch.cos(theta), torch.sin(theta)
  w = screw.w
  return (x * cos - _cross(w, x) * sin
          + w * (w * x).sum(-1, keepdim=True) * (1.0 - cos))


def translation(screw) -> torch.Tensor:
  """p = (θI + (1−cosθ)[w]ₓ + (θ−sinθ)[w]ₓ²) v."""
  if not isinstance(screw, Screw):
    return screw.translation_vec()
  theta = screw.theta[..., None]
  cos, sin = torch.cos(theta), torch.sin(theta)
  w, v = screw.w, screw.v
  wxv = _cross(w, v)
  wwv = w * (w * v).sum(-1, keepdim=True) - v  # [w]ₓ² v
  return theta * v + (1.0 - cos) * wxv + (theta - sin) * wwv


def transform_point(screw, x: torch.Tensor) -> torch.Tensor:
  """Full SE(3) action R x + p."""
  if not isinstance(screw, Screw):
    return screw.transform_point(x)
  return rotate(screw, x) + translation(screw)


def batched_jacobian(fn: Callable[..., torch.Tensor], points: torch.Tensor,
                     *args) -> torch.Tensor:
  """J[..., i, j] = ∂out_i/∂x_j of a pointwise-batched
  ``fn(points, *args) -> [..., 3]``, as ``[..., 3, 3]``.

  Three reverse passes, one for each basis cotangent eᵢ, give the rows;
  JAX's counterpart pushes three basis tangents forward instead. Reverse
  mode runs through every op of the warp fields, and with grad mode on each
  pass keeps
  its graph (``create_graph``), so a loss on J reaches the parameters: the
  caller's backward then differentiates twice. ``points`` is taken as a
  fresh leaf; ``args`` keep their graphs.
  """
  create_graph = torch.is_grad_enabled()
  with torch.enable_grad():
    p = points.detach().requires_grad_()
    out = fn(p, *args)
    rows = [torch.autograd.grad(out[..., i], p,
                                grad_outputs=torch.ones_like(out[..., i]),
                                retain_graph=True, create_graph=create_graph,
                                materialize_grads=True)[0]
            for i in range(3)]
  return torch.stack(rows, dim=-2)
