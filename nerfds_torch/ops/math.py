"""Core math primitives (L0), counterpart of ``nerfds_tpu/ops/math.py``.

Positional encoding with windowed annealing, safe normalisation and the
safe norm with its zeroed gradient near 0. Shape-polymorphic over leading
batch dims.
"""
from __future__ import annotations

import math

import torch

F32_EPS = float(torch.finfo(torch.float32).eps)


def posenc_window(min_deg: int, max_deg: int, alpha,
                  device=None) -> torch.Tensor:
  """Truncated-Hann coarse-to-fine window over frequency bands, shape
  ``[max_deg - min_deg]``: band ``b`` eases in as ``alpha`` sweeps past it."""
  bands = torch.arange(min_deg, max_deg, dtype=torch.float32, device=device)
  alpha = torch.as_tensor(alpha, dtype=torch.float32, device=device)
  x = torch.clamp(alpha - bands, 0.0, 1.0)
  return 0.5 * (1.0 + torch.cos(math.pi * x + math.pi))


def posenc(x: torch.Tensor, min_deg: int, max_deg: int,
           use_identity: bool = False, alpha=None) -> torch.Tensor:
  """Sinusoidal encoding at frequencies 2^[min_deg, max_deg).

  Band-major layout: per band ``[sin(sx), sin(sy), sin(sz), cos(sx),
  cos(sy), cos(sz)]``, optionally prefixed by the identity. cos is computed
  as sin(x + π/2), as the JAX package and its reference do.
  """
  if max_deg == min_deg:
    return x if use_identity else x[..., :0]
  batch_shape = x.shape[:-1]
  num_bands = max_deg - min_deg
  channels = x.shape[-1]
  scales = 2.0 ** torch.arange(min_deg, max_deg, dtype=x.dtype,
                               device=x.device)
  xb = (x[..., None, :] * scales[:, None]).reshape(*batch_shape, -1)
  sin_feat = torch.sin(xb)
  cos_feat = torch.sin(xb + 0.5 * math.pi)
  if alpha is not None:
    window = posenc_window(min_deg, max_deg, alpha, device=x.device)
    window = window.repeat_interleave(channels)
    sin_feat = window * sin_feat
    cos_feat = window * cos_feat
  four_feat = torch.cat(
      [sin_feat.reshape(*batch_shape, num_bands, 1, channels),
       cos_feat.reshape(*batch_shape, num_bands, 1, channels)],
      dim=-2).reshape(*batch_shape, -1)
  if use_identity:
    return torch.cat([x, four_feat], dim=-1)
  return four_feat


def posenc_dim(in_dim: int, min_deg: int, max_deg: int,
               use_identity: bool = False) -> int:
  """Static channel count of :func:`posenc`."""
  return in_dim * 2 * (max_deg - min_deg) + (in_dim if use_identity else 0)


def normalize(v: torch.Tensor, eps: float = F32_EPS) -> torch.Tensor:
  """Safe L2 normalisation."""
  return v / torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=eps))


class _SafeNorm(torch.autograd.Function):
  """L2 norm whose gradient is zeroed where the norm is below ``tol``."""

  @staticmethod
  def forward(ctx, x, dim, keepdim, tol):
    y = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    ctx.save_for_backward(x, y)
    ctx.dim, ctx.keepdim, ctx.tol = dim, keepdim, tol
    return y if keepdim else y.squeeze(dim)

  @staticmethod
  def backward(ctx, g):
    x, y = ctx.saved_tensors
    if not ctx.keepdim:
      g = g.unsqueeze(ctx.dim)
    safe_tol = max(ctx.tol, 1e-30)
    y_safe = torch.clamp(y, min=ctx.tol)
    grad = torch.where(y > safe_tol, g * x / y_safe, torch.zeros_like(x))
    return grad, None, None, None


def safe_norm(x: torch.Tensor, axis: int = -1, keepdims: bool = False,
              tol: float = 1e-9) -> torch.Tensor:
  return _SafeNorm.apply(x, axis, keepdims, tol)
