"""Core math primitives (L0), counterpart of ``nerfds_tpu/ops/math.py``.

Positional encoding with windowed annealing, safe normalisation, the safe
norm with its zeroed derivative near 0, the reflected direction, the robust,
Geman-McClure and shrinkage losses, PSNR, the divergence and curl of a warp
Jacobian, gradient clipping, bilinear image sampling and trilinear
coefficients. Shape-polymorphic over leading batch dims.
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
  """L2 norm, keeping ``dim``, whose derivative is zeroed where the norm is
  below ``tol``, in reverse mode (``backward``) and in forward mode
  (``jvp``, the same rule as JAX's ``custom_jvp``).

  The norm ``y`` is this Function's own output, so the backward's and the
  jvp's use of ``y`` stay on the graph: a second derivative (reverse over
  reverse, or reverse over forward) takes its ∂y/∂x term, as JAX's
  ``custom_jvp`` does. ``safe_norm`` squeezes outside the Function;
  squeezing inside would save a tensor that is not the output and lose that
  term.
  """

  @staticmethod
  def forward(ctx, x, dim, tol):
    y = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    ctx.save_for_backward(x, y)
    ctx.save_for_forward(x, y)
    ctx.tol, ctx.dim = tol, dim
    return y

  @staticmethod
  def jvp(ctx, x_dot, dim_dot, tol_dot):
    x, y = ctx.saved_tensors
    y_safe = torch.clamp(y, min=ctx.tol)
    y_dot = (x * x_dot).sum(ctx.dim, keepdim=True) / y_safe
    return torch.where(y > max(ctx.tol, 1e-30), y_dot, torch.zeros_like(y))

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


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
  """The reflected direction 2(d·n)n − d, both inputs normalised first."""
  d, n = normalize(d), normalize(n)
  return 2.0 * (d * n).sum(-1, keepdim=True) * n - d


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


def jacobian_to_curl(jacobian: torch.Tensor) -> torch.Tensor:
  """Curl of a field from its ``[..., 3, 3]`` Jacobian,
  J[..., i, j] = ∂f_i/∂x_j."""
  j = jacobian
  return torch.stack([j[..., 2, 1] - j[..., 1, 2],
                      j[..., 0, 2] - j[..., 2, 0],
                      j[..., 1, 0] - j[..., 0, 1]], dim=-1)


def jacobian_to_div(jacobian: torch.Tensor) -> torch.Tensor:
  """Divergence of the displacement x ↦ f(x) − x: trace(J) − 3."""
  return jacobian.diagonal(dim1=-2, dim2=-1).sum(-1) - 3.0


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


def matmul_hp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """A float32 product at full precision: ``torch.matmul``, since the port
  never lowers float32 products to TF32 unless the caller switches that on
  (``torch.backends.cuda.matmul.allow_tf32``)."""
  return torch.matmul(a, b)


def gm_loss(x: torch.Tensor, scale) -> torch.Tensor:
  """Geman-McClure loss."""
  square = (x / scale) ** 2
  return 2 * square / torch.clamp(square + 4, min=F32_EPS)


def grid_sample(image: torch.Tensor, coord: torch.Tensor) -> torch.Tensor:
  """Bilinear sample of an ``[H, W]`` image at float (x, y) coordinates
  ``coord [..., 2]``, edge-padded and clamped to the bounds. As in the JAX
  package, a coordinate clamps to [0, H] and [0, W], so it may land on the
  padded edge; a corner index past the padded image clamps too (JAX's
  gather clamps), where its bilinear weight is 0."""
  batch_shape = coord.shape[:-1]
  coord = coord.reshape(-1, 2)
  coord = torch.stack([coord[:, 1], coord[:, 0]], dim=-1)  # (y, x)
  height, width = image.shape
  max_bounds = torch.tensor([height, width], dtype=coord.dtype,
                            device=coord.device)
  coord = torch.minimum(torch.clamp(coord, min=0), max_bounds)
  image = torch.nn.functional.pad(image[None, None], (1, 1, 1, 1),
                                  mode='replicate')[0, 0]
  coord = coord + 1
  floor_coord = torch.floor(coord).long()
  offsets = torch.tensor([[0, 0], [0, 1], [1, 0], [1, 1]],
                         device=coord.device)
  corner = floor_coord[:, None, :] + offsets                    # N x 4 x 2
  cy = corner[..., 0].clamp(0, height + 1)
  cx = corner[..., 1].clamp(0, width + 1)
  corner_values = image[cy, cx]                                 # N x 4
  local = coord - floor_coord
  ly, lx = local[..., 0], local[..., 1]
  weights = torch.stack([(1 - lx) * (1 - ly), lx * (1 - ly), (1 - lx) * ly,
                         lx * ly], dim=-1)
  return (corner_values * weights).sum(-1).reshape(batch_shape)


def get_trilinear_coefficient(pos: torch.Tensor) -> torch.Tensor:
  """Trilinear weights of unit-cube positions ``pos [N, 3]``, ``[N, 8]`` in
  the vertex order [C000, C100, C010, C110, C001, C101, C011, C111]."""
  neg = 1.0 - pos
  x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
  nx, ny, nz = neg[:, 0], neg[:, 1], neg[:, 2]
  cx = torch.stack([nx, x, nx, x, nx, x, nx, x], dim=-1)
  cy = torch.stack([ny, ny, y, y, ny, ny, y, y], dim=-1)
  cz = torch.stack([nz, nz, nz, nz, z, z, z, z], dim=-1)
  return cx * cy * cz
