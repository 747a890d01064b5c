"""Quaternion math (L0), counterpart of ``nerfds_tpu/ops/quaternion.py``.

xyzw convention, batched over leading dims: ``q[..., :3]`` is the vector
part, ``q[..., 3]`` the scalar part.
"""
from __future__ import annotations

import torch

from nerfds_torch.ops.math import safe_norm


def im(q: torch.Tensor) -> torch.Tensor:
  """Imaginary (vector) part."""
  return q[..., :3]


def re(q: torch.Tensor) -> torch.Tensor:
  """Real (scalar) part, keeping its axis."""
  return q[..., 3:]


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
  return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)


def conjugate(q: torch.Tensor) -> torch.Tensor:
  return torch.cat([-im(q), re(q)], dim=-1)


def norm(q: torch.Tensor) -> torch.Tensor:
  return safe_norm(q, axis=-1, keepdims=True)


def normalize(q: torch.Tensor) -> torch.Tensor:
  return q / norm(q)


def inverse(q: torch.Tensor) -> torch.Tensor:
  return conjugate(q) / (q * q).sum(-1, keepdim=True)


def multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
  """Hamilton product (xyzw)."""
  c = (re(q1) * im(q2) + re(q2) * im(q1)
       + torch.linalg.cross(im(q1), im(q2), dim=-1))
  w = re(q1) * re(q2) - (im(q1) * im(q2)).sum(-1, keepdim=True)
  return torch.cat([c, w], dim=-1)


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Rotates vectors ``v`` by unit quaternions ``q``: im(q (v, 0) q*)."""
  qv = torch.cat([v, torch.zeros_like(v[..., :1])], dim=-1)
  return im(multiply(multiply(q, qv), conjugate(q)))


def log(q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
  """Quaternion logarithm."""
  mag = norm(q)
  v, s = im(q), re(q)
  w = torch.log(mag)
  denom = torch.clamp(safe_norm(v, axis=-1, keepdims=True), min=eps)
  xyz = v / denom * torch.acos(torch.clamp(s / mag, -1.0, 1.0))
  return torch.cat([xyz, w], dim=-1)


def exp(q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
  """Quaternion exponential."""
  v, s = im(q), re(q)
  norm_v = torch.clamp(safe_norm(v, axis=-1, keepdims=True), min=eps)
  scale = torch.exp(s)
  xyz = scale * v / norm_v * torch.sin(norm_v)
  w = scale * torch.cos(norm_v)
  return torch.cat([xyz, w], dim=-1)


def from_axis_angle(axis: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
  """Unit quaternion from a unit rotation axis ``[..., 3]`` and an angle
  ``[...]``."""
  half = theta[..., None] * 0.5
  return torch.cat([axis * torch.sin(half), torch.cos(half)], dim=-1)


def to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
  """Unit quaternion (xyzw) -> rotation matrix ``[..., 3, 3]``."""
  x, y, z, w = q.unbind(-1)
  rows = [
      [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
      [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
  ]
  return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def from_rotation_matrix(m: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
  """Rotation matrix ``[..., 3, 3]`` -> unit quaternion (xyzw), by the
  branchless trace construction."""
  trace = m.diagonal(dim1=-2, dim2=-1).sum(-1)
  w = 0.5 * torch.sqrt(torch.clamp(trace + 1.0, min=eps))
  denom = torch.clamp(4.0 * w, min=eps)
  x = (m[..., 2, 1] - m[..., 1, 2]) / denom
  y = (m[..., 0, 2] - m[..., 2, 0]) / denom
  z = (m[..., 1, 0] - m[..., 0, 1]) / denom
  return normalize(torch.stack([x, y, z, w], dim=-1))
