"""Chunked full-image renderer (L5), counterpart of
``nerfds_tpu/evaluation/render.py``.

Every chunk has the same fixed size (the tail chunk is padded by repeating
its last ray) and the metadata embeddings are encoded once per image.
Rendering runs under ``torch.no_grad()``; only the per-point ∇σ pullback
inside the model turns autograd on.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from nerfds_torch.models.nerfds import NerfDSModel


def make_render_fn(model: NerfDSModel, use_sample_at_infinity=None,
                   return_full: bool = True,
                   compute_sigma_gradient: bool = False):
  """Returns ``render_chunk(rays, extra_params, generator=None) -> out``.

  ``compute_sigma_gradient=False`` (default) skips the per-point ∇σ, which
  only feeds the normal-supervision target; pass True to also render
  ``target_norm``."""

  def render_chunk(rays, extra_params, generator=None):
    with torch.no_grad():
      return model.render(
          rays, extra_params, generator=generator, metadata_encoded=True,
          return_points=False, return_weights=False,
          use_sample_at_infinity=use_sample_at_infinity,
          return_full=return_full,
          compute_sigma_gradient=compute_sigma_gradient)

  return render_chunk


# Per-ray outputs worth assembling into images.
DEFAULT_KEYS = ('rgb', 'depth', 'med_depth', 'acc', 'ray_norm',
                'ray_delta_x', 'ray_hyper_points', 'ray_predicted_mask',
                'med_points', 'ray_rotation_field', 'ray_translation_field')


def _tensor(x, device) -> torch.Tensor:
  t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
  if t.is_floating_point():
    t = t.float()
  return t.to(device)


def render_image(model: NerfDSModel, rays_dict: Dict[str, Any], extra_params,
                 *, generator: Optional[torch.Generator] = None,
                 chunk: int = 8192, render_fn=None,
                 level: Optional[str] = None,
                 keys=DEFAULT_KEYS) -> Dict[str, np.ndarray]:
  """Renders every pixel of an image in fixed-size chunks, on the model's
  device.

  ``rays_dict`` arrays (numpy or torch) are image-shaped ``[H, W, C]`` or
  ``[N, C]``; the metadata may be raw ids (encoded here) and is taken as
  constant across the image. Matmuls and convolutions run in full float32:
  this sets ``torch.backends.cuda.matmul.allow_tf32`` and
  ``torch.backends.cudnn.allow_tf32`` to False.
  """
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  if render_fn is None:
    render_fn = make_render_fn(model)
  device = model.device

  rays_dict = dict(rays_dict)
  metadata = rays_dict.pop('metadata', {})
  batch_shape = tuple(rays_dict['origins'].shape[:-1])
  num_rays = int(np.prod(batch_shape))
  flat = {k: _tensor(v, device).reshape(num_rays, -1)
          for k, v in rays_dict.items()}
  with torch.no_grad():
    encoded = model.encode_metadata({
        k: _tensor(v, device).reshape(-1, v.shape[-1])[:1]
        for k, v in metadata.items()})
  level = level or ('fine' if model.config.num_fine_samples > 0 else 'coarse')

  outs = []
  for start in range(0, num_rays, chunk):
    sl = {k: v[start:start + chunk] for k, v in flat.items()}
    n = sl['origins'].shape[0]
    pad = chunk - n
    if pad:
      sl = {k: torch.cat([v, v[-1:].expand(pad, -1)]) for k, v in sl.items()}
    chunk_rays = {
        'origins': sl['origins'],
        'directions': sl['directions'],
        'metadata': {k: v.expand(chunk, v.shape[-1])
                     for k, v in encoded.items()},
        'mask': sl['mask'] if 'mask' in sl else torch.zeros(
            chunk, 1, device=device),
    }
    out = render_fn(chunk_rays, extra_params, generator)[level]
    outs.append({k: v[:n].cpu().numpy() for k, v in out.items() if k in keys})

  result = {}
  for k in outs[0]:
    stacked = np.concatenate([o[k] for o in outs], axis=0)
    result[k] = stacked.reshape((*batch_shape, *stacked.shape[1:]))
  return result
