"""Dual-quaternion math and rigid motion (L0), counterpart of
``nerfds_tpu/ops/dual_quaternion.py``.

A dual quaternion r + εd is stored as ``[rx, ry, rz, rw, dx, dy, dz, dw]``
with xyzw quaternions (``ops/quaternion.py``), batched over leading dims.

:class:`DualQuatMotion` gives a unit dual quaternion the motion surface of
:class:`ops.rigid.Screw` (``rotate``, ``rotate_inverse``,
``translation_vec``, ``transform_point``, ``axis``), so the ``rigid.*``
appliers and the model's normal transport take either.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from nerfds_torch.ops import quaternion


def real_part(dq: torch.Tensor) -> torch.Tensor:
  return dq[..., :4]


def dual_part(dq: torch.Tensor) -> torch.Tensor:
  return dq[..., 4:]


def join_parts(real: torch.Tensor, dual: torch.Tensor) -> torch.Tensor:
  return torch.cat([real, dual], dim=-1)


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
  return torch.tensor([0., 0., 0., 1., 0., 0., 0., 0.], dtype=dtype,
                      device=device)


def multiply(dq1: torch.Tensor, dq2: torch.Tensor) -> torch.Tensor:
  """(a + εb)(c + εd) = ac + ε(ad + bc)."""
  a, b = real_part(dq1), dual_part(dq1)
  c, d = real_part(dq2), dual_part(dq2)
  real = quaternion.multiply(a, c)
  dual = quaternion.multiply(a, d) + quaternion.multiply(b, c)
  return join_parts(real, dual)


def quaternion_conjugate(dq: torch.Tensor) -> torch.Tensor:
  return join_parts(quaternion.conjugate(real_part(dq)),
                    quaternion.conjugate(dual_part(dq)))


def dual_conjugate(dq: torch.Tensor) -> torch.Tensor:
  return join_parts(real_part(dq), -dual_part(dq))


def quaternion_dual_conjugate(dq: torch.Tensor) -> torch.Tensor:
  return join_parts(-quaternion.conjugate(real_part(dq)),
                    -quaternion.conjugate(dual_part(dq)))


def normalize(dq: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
  real, dual = real_part(dq), dual_part(dq)
  real_norm = torch.clamp(quaternion.norm(real), min=eps)
  return join_parts(real / real_norm, dual / real_norm)


def get_rotation(dq: torch.Tensor) -> torch.Tensor:
  return real_part(dq)


def get_translation(dq: torch.Tensor) -> torch.Tensor:
  """t = 2 · Im(d r*) for a unit dual quaternion."""
  real, dual = real_part(dq), dual_part(dq)
  return 2.0 * quaternion.im(
      quaternion.multiply(dual, quaternion.conjugate(real)))


def from_rotation_translation(q: torch.Tensor,
                              t: torch.Tensor) -> torch.Tensor:
  """Unit dual quaternion for 'rotate by q, then translate by t'."""
  t4 = torch.cat([t, torch.zeros_like(t[..., -1:])], dim=-1)
  ident = quaternion.identity(q.dtype, q.device).expand(q.shape)
  dq_t = join_parts(ident, 0.5 * t4)
  dq_r = join_parts(q, torch.zeros_like(q))
  return multiply(dq_t, dq_r)


def transform_point(dq: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
  """The rigid motion p' = R(r) p + t, computed quaternionically."""
  return quaternion.rotate(real_part(dq), p) + get_translation(dq)


class DualQuatMotion(NamedTuple):
  """A batch of rigid motions parameterised by unit dual quaternions."""
  dq: torch.Tensor  # [..., 8], the real part normalised

  def rotate(self, x: torch.Tensor) -> torch.Tensor:
    return quaternion.rotate(real_part(self.dq), x)

  def rotate_inverse(self, x: torch.Tensor) -> torch.Tensor:
    return quaternion.rotate(quaternion.conjugate(real_part(self.dq)), x)

  def translation_vec(self) -> torch.Tensor:
    return get_translation(self.dq)

  def transform_point(self, x: torch.Tensor) -> torch.Tensor:
    return transform_point(self.dq, x)

  @property
  def axis(self) -> torch.Tensor:
    """The 6-dim unit screw axis [w, v], as :attr:`ops.rigid.Screw.axis`.

    w is the unit rotation axis; v is recovered from (R, t) by the closed
    SE(3) log, t = G(θ, w) v with G⁻¹ = I/θ − [w]ₓ/2 + (1/θ − cot(θ/2)/2)
    [w]ₓ². θ/2 = atan2(‖im‖, re) stays accurate at small angles, and
    c(θ) = 1/θ − cot(θ/2)/2 takes its Taylor form θ/12 below 1e-3.
    """
    eps = 1e-12
    qn = quaternion.normalize(real_part(self.dq))
    v_im = quaternion.im(qn)
    sin_half = torch.linalg.vector_norm(v_im, dim=-1)
    theta = 2.0 * torch.atan2(sin_half, qn[..., 3])
    w = v_im / torch.clamp(sin_half, min=eps)[..., None]
    t = self.translation_vec()
    safe_theta = torch.clamp(theta, min=eps)[..., None]
    small = theta < 1e-3
    guarded = torch.where(small, torch.ones_like(theta), theta)
    c_exact = 1.0 / guarded - 0.5 / torch.tan(guarded / 2.0)
    c = torch.where(small, theta / 12.0, c_exact)[..., None]
    wxt = torch.linalg.cross(w, t, dim=-1)
    v = (t / safe_theta - 0.5 * wxt
         + c * torch.linalg.cross(w, wxt, dim=-1))
    return torch.cat([w, v], dim=-1)
