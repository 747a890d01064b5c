"""Batched rigid-body math (L0), counterpart of ``nerfds_tpu/ops/rigid.py``.

Closed Rodrigues forms over ``[..., 3]`` tensors (Modern Robotics eqns 3.51
and 3.88):
  R x = x cosθ + (w × x) sinθ + w (w·x)(1 − cosθ)
  p   = θ v + (1 − cosθ)(w × v) + (θ − sinθ)(w (w·v) − v)

The appliers take a :class:`Screw`, or any motion object with the same
methods (``ops.dual_quaternion.DualQuatMotion``). The matrix forms
(``skew``, ``exp_so3``, ``exp_se3_matrix``) are the golden versions that
tests hold the closed forms against.
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
  """a × b in the wider of the two dtypes, as ``jnp.cross`` promotes (the
  warp's float32 screw against float64 points)."""
  dtype = torch.promote_types(a.dtype, b.dtype)
  return torch.linalg.cross(a.to(dtype), b.to(dtype), dim=-1)


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


def transform_point_inverse(screw: Screw, x: torch.Tensor) -> torch.Tensor:
  """Inverse SE(3) action Rᵀ(x − p)."""
  return rotate_inverse(screw, x - translation(screw))


def rotation_matrix(screw: Screw) -> torch.Tensor:
  """R as ``[..., 3, 3]``: its columns are the basis vectors rotated."""
  eye = torch.eye(3, dtype=screw.theta.dtype, device=screw.theta.device)
  eye = eye.expand(*screw.theta.shape, 3, 3)
  return torch.stack([rotate(screw, eye[..., i, :]) for i in range(3)],
                     dim=-1)


# -- The matrix forms: the golden exp maps, for tests and diagnostics. -------


def skew(w: torch.Tensor) -> torch.Tensor:
  """The cross-product matrix of ``w [..., 3]``, ``[..., 3, 3]``."""
  zeros = torch.zeros_like(w[..., 0])
  wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
  return torch.stack([
      torch.stack([zeros, -wz, wy], dim=-1),
      torch.stack([wz, zeros, -wx], dim=-1),
      torch.stack([-wy, wx, zeros], dim=-1),
  ], dim=-2)


def exp_so3(w: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
  """Rodrigues' formula I + sinθ W + (1 − cosθ) W², ``[..., 3, 3]``."""
  big_w = skew(w)
  theta = theta[..., None, None]
  eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(big_w.shape)
  return (eye + torch.sin(theta) * big_w
          + (1.0 - torch.cos(theta)) * torch.matmul(big_w, big_w))


def exp_se3_matrix(screw_axis: torch.Tensor, theta: torch.Tensor,
                   rotation_only: bool = False,
                   inverse: bool = False) -> torch.Tensor:
  """The 4x4 homogeneous exp map of the screw axis ``[w, v] [..., 6]``
  and angle ``theta [...]``; ``inverse`` gives [Rᵀ, −Rᵀp]."""
  w, v = screw_axis[..., :3], screw_axis[..., 3:]
  big_w = skew(w)
  rot = exp_so3(w, theta)
  th = theta[..., None, None]
  eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(big_w.shape)
  p_mat = (th * eye + (1.0 - torch.cos(th)) * big_w
           + (th - torch.sin(th)) * torch.matmul(big_w, big_w))
  p = torch.matmul(p_mat, v[..., None])[..., 0]
  if rotation_only:
    p = p * 0
  if inverse:
    rot = rot.transpose(-1, -2)
    p = -torch.matmul(rot, p[..., None])[..., 0]
  top = torch.cat([rot, p[..., None]], dim=-1)
  bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                        device=top.device).expand(*top.shape[:-2], 1, 4)
  return torch.cat([top, bottom], dim=-2)


def to_homogenous(v: torch.Tensor) -> torch.Tensor:
  return torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)


def from_homogenous(v: torch.Tensor) -> torch.Tensor:
  return v[..., :3] / v[..., -1:]


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
