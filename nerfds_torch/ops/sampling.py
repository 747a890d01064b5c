"""Ray sampling (L0), counterpart of ``nerfds_tpu/ops/sampling.py``:
stratified coarse samples and inverse-CDF importance samples.

Random draws come from an explicit ``torch.Generator``. Each function also
takes a tensor of uniforms, so a test can feed both frameworks the same
draws (JAX's threefry and torch's Philox give different numbers).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _uniforms(shape, like: torch.Tensor, generator, uniforms):
  if uniforms is not None:
    if tuple(uniforms.shape) != tuple(shape):
      raise ValueError(f'uniforms shape {tuple(uniforms.shape)} != {shape}')
    return uniforms.to(device=like.device, dtype=like.dtype)
  return torch.rand(shape, generator=generator, device=like.device,
                    dtype=like.dtype)


def sample_along_rays(origins: torch.Tensor, directions: torch.Tensor,
                      num_samples: int, near: float, far: float,
                      use_stratified_sampling: bool,
                      use_linear_disparity: bool,
                      generator: Optional[torch.Generator] = None,
                      uniforms: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Stratified sampling along rays. Returns (z_vals [R, S], points [R, S, 3])."""
  batch_size = origins.shape[0]
  t_vals = torch.linspace(0.0, 1.0, num_samples, device=origins.device,
                          dtype=origins.dtype)
  if not use_linear_disparity:
    z_vals = near * (1.0 - t_vals) + far * t_vals
  else:
    z_vals = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
  if use_stratified_sampling:
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], -1)
    lower = torch.cat([z_vals[..., :1], mids], -1)
    t_rand = _uniforms((batch_size, num_samples), origins, generator,
                       uniforms)
    z_vals = lower + (upper - lower) * t_rand
  else:
    z_vals = z_vals[None, :].expand(batch_size, num_samples)
  points = origins[..., None, :] + z_vals[..., :, None] * directions[..., None, :]
  return z_vals, points


def piecewise_constant_pdf(bins: torch.Tensor, weights: torch.Tensor,
                           num_samples: int, use_stratified_sampling: bool,
                           generator: Optional[torch.Generator] = None,
                           uniforms: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
  """Inverse-CDF sampling from a piecewise-constant PDF over sorted bins.

  bins: [R, B+1]; weights: [R, B]. Returns detached z samples [R, S].
  """
  eps = 1e-5
  weights = weights + eps
  pdf = weights / weights.sum(-1, keepdim=True)
  cdf = torch.cumsum(pdf, -1)
  cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)

  shape = (*cdf.shape[:-1], num_samples)
  if use_stratified_sampling:
    u = _uniforms(shape, cdf, generator, uniforms)
  else:
    u = torch.linspace(0.0, 1.0, num_samples, device=cdf.device,
                       dtype=cdf.dtype).expand(shape)

  # For each u find the surrounding (bin, cdf) bracket by a masked min/max.
  mask = u[..., None, :] >= cdf[..., :, None]

  def minmax(x):
    x0 = torch.where(mask, x[..., None], x[..., :1, None]).amax(-2)
    x1 = torch.where(~mask, x[..., None], x[..., -1:, None]).amin(-2)
    x0 = torch.minimum(x0, x[..., -2:-1])
    x1 = torch.maximum(x1, x[..., 1:2])
    return x0, x1

  bins_g0, bins_g1 = minmax(bins)
  cdf_g0, cdf_g1 = minmax(cdf)

  denom = cdf_g1 - cdf_g0
  denom = torch.where(denom < eps, torch.ones_like(denom), denom)
  t = (u - cdf_g0) / denom
  z_samples = bins_g0 + t * (bins_g1 - bins_g0)
  return z_samples.detach()


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor,
               origins: torch.Tensor, directions: torch.Tensor,
               z_vals: torch.Tensor, num_samples: int,
               use_stratified_sampling: bool,
               generator: Optional[torch.Generator] = None,
               uniforms: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Hierarchical sampling: merge importance samples with coarse z, sorted.

  Returns (z_vals [R, Sc+Sf], points [R, Sc+Sf, 3]).
  """
  z_samples = piecewise_constant_pdf(bins, weights, num_samples,
                                     use_stratified_sampling, generator,
                                     uniforms)
  z_vals, _ = torch.sort(torch.cat([z_vals, z_samples], -1), -1)
  points = origins[..., None, :] + z_vals[..., None] * directions[..., None, :]
  return z_vals, points
