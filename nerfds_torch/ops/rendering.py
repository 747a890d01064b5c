"""Volume rendering / compositing (L0), counterpart of
``nerfds_tpu/ops/rendering.py``.

``volumetric_rendering(..., use_kernel=True)`` composites through the
hand-written CUDA kernel (``kernels/composite.py``); weight sharpening
reorders the reductions, so it always takes the plain formula.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from nerfds_torch.kernels import composite as composite_lib
from nerfds_torch.ops import sampling


def compute_alpha_and_weights(sigma, z_vals, dirs, sample_at_infinity=True,
                              eps=1e-10, scale=1.0):
  """alpha = 1−exp(−σ·δ) and exclusive-cumprod compositing weights.

  sigma: [R, S] (post-activation), z_vals: [R, S], dirs: [R, 3]
  (unnormalised; their norm scales the distances).
  Returns (alpha [R, S], weights [R, S], accum_prod [R, S]).
  """
  last_sample_z = 1e10 if sample_at_infinity else 1e-19
  dists = torch.cat([
      z_vals[..., 1:] - z_vals[..., :-1],
      torch.full_like(z_vals[..., :1], last_sample_z),
  ], -1)
  dists = dists * torch.linalg.vector_norm(dirs[..., None, :], dim=-1)
  alpha = 1.0 - torch.exp(-scale * sigma * dists)
  accum_prod = torch.cat([
      torch.ones_like(alpha[..., :1]),
      torch.cumprod(1.0 - alpha[..., :-1] + eps, dim=-1),
  ], -1)
  weights = alpha * accum_prod
  return alpha, weights, accum_prod


def cal_weights(sigma, z_vals, dirs, sample_at_infinity=True, eps=1e-10,
                scale=1.0):
  """Weights only (``scale`` boosts σ for the mask weights)."""
  _, weights, _ = compute_alpha_and_weights(
      sigma, z_vals, dirs, sample_at_infinity, eps, scale)
  return weights


def _normal_pdf(x, loc, scale):
  """Gaussian density, written as ``jax.scipy.stats.norm.pdf`` writes it."""
  scale_sq = scale * scale
  log_normalizer = math.log(2 * math.pi * scale_sq)
  quadratic = (x - loc) ** 2 / scale_sq
  return torch.exp((log_normalizer + quadratic) / -2.0)


def sharpen_weights(weights, z_vals, std=0.01):
  """Reweight samples by a Gaussian centred at each ray's own max-weight z.

  Per ray, as the JAX package does (its reference indexed whole rows of
  other rays, which depends on batch composition).
  """
  max_idx = torch.argmax(weights, dim=-1)
  max_z = torch.gather(z_vals, -1, max_idx[..., None])  # [R, 1]
  sharp = weights * _normal_pdf(z_vals, max_z, std)
  # +eps: all-zero rows divide to 0, not NaN.
  return sharp / (sharp.sum(-1, keepdim=True) + 1e-12)


def compute_opaqueness_mask(weights, depth_threshold=0.5):
  """One-hot mask at the sample where accumulated weight crosses threshold."""
  cum = torch.cumsum(weights, dim=-1)
  opaqueness = cum >= depth_threshold
  padded = torch.cat(
      [torch.zeros_like(opaqueness[..., :1]), opaqueness[..., :-1]], -1)
  return torch.logical_xor(opaqueness, padded).to(weights.dtype)


def compute_depth_index(weights, depth_threshold=0.5):
  return torch.argmax(compute_opaqueness_mask(weights, depth_threshold), -1)


def compute_depth_map(weights, z_vals, depth_threshold=0.5):
  """Median-accumulation depth."""
  return (compute_opaqueness_mask(weights, depth_threshold) * z_vals).sum(-1)


def volumetric_rendering(rgb, sigma, z_vals, dirs, use_white_background,
                         sample_at_infinity=True, eps=1e-10,
                         use_sharp_weights=False, sharp_weights_std=1.0,
                         use_kernel: bool = False
                         ) -> Dict[str, torch.Tensor]:
  """Composite per-sample (rgb, σ) into per-ray rgb/depth/acc."""
  if use_kernel and not use_sharp_weights:
    out_rgb, exp_depth, acc, weights, alpha, accum_prod = (
        composite_lib.composite(rgb, sigma, z_vals, dirs, sample_at_infinity,
                                eps))
  else:
    alpha, weights, accum_prod = compute_alpha_and_weights(
        sigma, z_vals, dirs, sample_at_infinity, eps)
    if use_sharp_weights:
      weights = sharpen_weights(weights, z_vals, std=sharp_weights_std)
    out_rgb = (weights[..., None] * rgb).sum(-2)
    exp_depth = (weights * z_vals).sum(-1)
    acc = weights.sum(-1)
  med_depth = compute_depth_map(weights, z_vals)
  if use_white_background:
    out_rgb = out_rgb + (1.0 - acc[..., None])
  if sample_at_infinity:
    acc = weights[..., :-1].sum(-1)
  return {
      'rgb': out_rgb,
      'depth': exp_depth,
      'med_depth': med_depth,
      'acc': acc,
      'weights': weights,
      'alpha': alpha,
      'accum_prod': accum_prod,
  }


def noise_regularize_sigma(sigma, noise_std: Optional[float],
                           use_stratified_sampling: bool,
                           generator: Optional[torch.Generator] = None):
  """Gaussian noise on raw σ."""
  if noise_std is not None and noise_std > 0.0 and use_stratified_sampling:
    noise = sampling.draw(torch.randn, sigma.shape, generator,
                          device=sigma.device, dtype=sigma.dtype)
    sigma = sigma + noise * noise_std
  return sigma
