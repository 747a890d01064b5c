"""Core math primitives (L0), counterpart of ``nerfds_tpu/ops/math.py``.

Positional encoding with windowed annealing, safe normalisation, the safe
norm with its zeroed gradient near 0, the robust and shrinkage losses, PSNR
and gradient clipping. Shape-polymorphic over leading batch dims.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

F32_EPS = float(torch.finfo(torch.float32).eps)


def _scalar(v, dtype, device) -> torch.Tensor:
  """``v`` as a tensor of ``dtype`` on ``device``. A Python number is
  filled in on the device: making it on the host and copying it over would
  make the host wait for the card."""
  if isinstance(v, torch.Tensor):
    return v.to(dtype=dtype, device=device)
  return torch.full((), v, dtype=dtype, device=device)


def posenc_window(min_deg: int, max_deg: int, alpha,
                  device=None) -> torch.Tensor:
  """Truncated-Hann coarse-to-fine window over frequency bands, shape
  ``[max_deg - min_deg]``: band ``b`` eases in as ``alpha`` sweeps past it."""
  bands = torch.arange(min_deg, max_deg, dtype=torch.float32, device=device)
  alpha = _scalar(alpha, torch.float32, device)
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
  """L2 norm, keeping ``dim``, whose gradient is zeroed where the norm is
  below ``tol``.

  The norm ``y`` is this Function's own output, so the backward's use of
  ``y`` stays on the graph: a second derivative takes its ∂y/∂x term, as
  JAX's ``custom_jvp`` does. ``safe_norm`` squeezes outside the Function;
  squeezing inside would save a tensor that is not the output and lose that
  term.
  """

  @staticmethod
  def forward(ctx, x, dim, tol):
    y = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    ctx.save_for_backward(x, y)
    ctx.tol = tol
    return y

  @staticmethod
  def backward(ctx, g):
    x, y = ctx.saved_tensors
    safe_tol = max(ctx.tol, 1e-30)
    y_safe = torch.clamp(y, min=ctx.tol)
    grad = torch.where(y > safe_tol, g * x / y_safe, torch.zeros_like(x))
    return grad, None, None


def safe_norm(x: torch.Tensor, axis: int = -1, keepdims: bool = False,
              tol: float = 1e-9) -> torch.Tensor:
  y = _SafeNorm.apply(x, axis, tol)
  return y if keepdims else y.squeeze(axis)


def safe_sqrt(x: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
  return torch.sqrt(torch.where(x == 0, torch.full_like(x, eps), x))


def general_loss_with_squared_residual(x_sq, alpha, scale):
  """Barron's general robust loss on squared residuals.

  alpha=-2 -> Geman-McClure, 0 -> Cauchy, 2 -> L2, ±inf -> Welsch/exp.
  ``alpha`` and ``scale`` may be numbers or tensors.
  """
  eps = F32_EPS
  alpha = _scalar(alpha, x_sq.dtype, x_sq.device)
  scale = torch.clamp(_scalar(scale, x_sq.dtype, x_sq.device), min=eps)
  loss_two = 0.5 * x_sq / (scale ** 2)
  log1p_safe = lambda v: torch.log1p(torch.clamp(v, max=3e37))
  expm1_safe = lambda v: torch.expm1(torch.clamp(v, max=87.5))
  a = torch.where(alpha >= 0, torch.ones_like(alpha),
                  -torch.ones_like(alpha)) * torch.clamp(alpha.abs(), min=eps)
  b = torch.clamp((alpha - 2).abs(), min=eps)
  loss_ow = (b / a) * ((loss_two / (0.5 * b) + 1) ** (0.5 * alpha) - 1)
  return scale * torch.where(
      alpha == -math.inf, -expm1_safe(-loss_two),
      torch.where(
          alpha == 0, log1p_safe(loss_two),
          torch.where(alpha == 2, loss_two,
                      torch.where(alpha == math.inf, expm1_safe(loss_two),
                                  loss_ow))))


def l2_loss(x: torch.Tensor) -> torch.Tensor:
  return x ** 2


def shrinkage_loss(x: torch.Tensor, a: float = 10.0,
                   c: float = 1e-2) -> torch.Tensor:
  return (x ** 2) / (1 + torch.exp(a * (c - x)))


def compute_psnr(mse: torch.Tensor) -> torch.Tensor:
  """PSNR from MSE for pixel values in [0, 1]."""
  return -10.0 * torch.log(mse) / math.log(10.0)


def clip_gradients(grads: Dict[str, torch.Tensor], grad_max_val: float = 0.0,
                   grad_max_norm: float = 0.0,
                   eps: float = 1e-7) -> Dict[str, torch.Tensor]:
  """Value- then global-norm-clips a dict of gradients."""
  if grad_max_val > 0:
    grads = {k: torch.clamp(g, -grad_max_val, grad_max_val)
             for k, g in grads.items()}
  if grad_max_norm > 0:
    grad_norm = safe_sqrt(sum((g ** 2).sum() for g in grads.values()))
    mult = torch.clamp(grad_max_norm / (eps + grad_norm), max=1.0)
    grads = {k: mult * g for k, g in grads.items()}
  return grads
