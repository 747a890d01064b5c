"""Chunked full-image renderer (L5), counterpart of
``nerfds_tpu/evaluation/render.py``.

Every chunk has the same fixed size (the tail chunk is padded by repeating
its last ray) and the metadata embeddings are encoded once per image.
Rendering runs under ``torch.no_grad()``; only the per-point ∇σ pullback
inside the model turns autograd on. Under a data mesh each rank renders
its rows of every chunk and the rows are gathered, so every rank returns
the whole image.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from nerfds_torch import tracing
from nerfds_torch.models.nerfds import NerfDSModel
from nerfds_torch.ops.sampling import RowShard
from nerfds_torch.parallel import mesh as mesh_lib


def make_render_fn(model: NerfDSModel, use_sample_at_infinity=None,
                   return_full: bool = True,
                   compute_sigma_gradient: bool = False):
  """Returns ``render_chunk(rays, extra_params, generator=None) -> out``.

  ``compute_sigma_gradient=False`` (default) skips the per-point ∇σ, which
  only feeds the normal-supervision target; pass True to also render
  ``target_norm``, which then comes back at every sample even where
  ``norm_grad_topk`` is configured (the top-k form is a training-step
  detail)."""

  def render_chunk(rays, extra_params, generator=None):
    with torch.no_grad():
      return model.render(
          rays, extra_params, generator=generator, metadata_encoded=True,
          return_points=False, return_weights=False,
          use_sample_at_infinity=use_sample_at_infinity,
          return_full=return_full,
          compute_sigma_gradient=compute_sigma_gradient,
          use_norm_grad_topk=False)

  return render_chunk


# Per-ray outputs worth assembling into images.
DEFAULT_KEYS = ('rgb', 'depth', 'med_depth', 'acc', 'ray_norm',
                'ray_delta_x', 'ray_hyper_points', 'ray_predicted_mask',
                'med_points', 'ray_rotation_field', 'ray_translation_field')
# ... and those of the configuration's own branches.
HYPER_C_KEYS = ('ray_hyper_c',)


def _tensor(x, device) -> torch.Tensor:
  t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
  if t.is_floating_point():
    t = t.float()
  return t.to(device)


def _gather_rows(out: Dict[str, torch.Tensor], mesh: mesh_lib.DataMesh
                 ) -> Dict[str, torch.Tensor]:
  """Every rank's rows of each output, in one collective."""
  rows = next(iter(out.values())).shape[0]
  flat = {k: v.reshape(rows, -1) for k, v in out.items()}
  whole = mesh_lib.all_gather_rows(
      torch.cat([v.float() for v in flat.values()], -1), mesh)
  parts = torch.split(whole, [v.shape[1] for v in flat.values()], -1)
  return {k: p.to(out[k].dtype).reshape(-1, *out[k].shape[1:])
          for (k, p) in zip(out, parts)}


def render_image(model: NerfDSModel, rays_dict: Dict[str, Any], extra_params,
                 *, generator: Optional[torch.Generator] = None,
                 chunk: int = 8192, render_fn=None,
                 level: Optional[str] = None, keys=None,
                 mesh: Optional[mesh_lib.DataMesh] = None
                 ) -> Dict[str, np.ndarray]:
  """Renders every pixel of an image in fixed-size chunks, on the model's
  device.

  ``rays_dict`` arrays (numpy or torch) are image-shaped ``[H, W, C]`` or
  ``[N, C]``; the metadata may be raw ids (encoded here) and is taken as
  constant across the image. ``keys``: the per-ray outputs to assemble
  (default: ``DEFAULT_KEYS``, and ``HYPER_C_KEYS`` under ``use_hyper_c``).
  Matmuls and convolutions run in full float32:
  this sets ``torch.backends.cuda.matmul.allow_tf32`` and
  ``torch.backends.cudnn.allow_tf32`` to False.

  ``mesh``: every rank of it calls this with the same rays and a
  generator in the same state. The chunk is padded to a multiple of the
  world size; each rank renders its rows of a chunk, drawing what one
  process rendering the whole chunk draws for those rows
  (``sampling.RowShard``), and the rows are gathered.

  Under a profiler the image is a ``tracing`` span, ``nerfds.render.image``,
  holding ``nerfds.render.encode`` (the rays put on the device and the
  metadata encoded), one ``nerfds.render.chunk`` a chunk (unit: the chunk's
  index), each with the model's spans and ``nerfds.render.to_host`` (the
  outputs copied to the host, one wait for the card each), and
  ``nerfds.render.assemble`` (the chunks' outputs joined on the host).
  """
  with tracing.span('nerfds.render.image'):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if render_fn is None:
      render_fn = make_render_fn(model)
    if keys is None:
      keys = DEFAULT_KEYS + (HYPER_C_KEYS if model.config.use_hyper_c else ())
    device = model.device

    rays_dict = dict(rays_dict)
    metadata = rays_dict.pop('metadata', {})
    batch_shape = tuple(rays_dict['origins'].shape[:-1])
    num_rays = int(np.prod(batch_shape))
    with tracing.span('nerfds.render.encode'):
      flat = {k: _tensor(v, device).reshape(num_rays, -1)
              for k, v in rays_dict.items()}
      with torch.no_grad():
        encoded = model.encode_metadata({
            k: _tensor(v, device).reshape(-1, v.shape[-1])[:1]
            for k, v in metadata.items()})
    level = level or ('fine' if model.config.num_fine_samples > 0 else 'coarse')
    sharded = mesh is not None and mesh.world_size > 1
    if sharded:
      mesh_lib.check_batch_norm(model.config.norm_type, mesh)
      chunk = mesh_lib.pad_to_multiple(chunk, mesh.world_size)
      per = chunk // mesh.world_size
      generator = RowShard(generator, chunk, mesh.rank * per,
                           (mesh.rank + 1) * per)

    outs = []
    for index, start in enumerate(range(0, num_rays, chunk)):
      with tracing.span('nerfds.render.chunk', unit=index):
        sl = {k: v[start:start + chunk] for k, v in flat.items()}
        n = sl['origins'].shape[0]
        pad = chunk - n
        if pad:
          sl = {k: torch.cat([v, v[-1:].expand(pad, -1)])
                for k, v in sl.items()}
        chunk_rays = {
            'origins': sl['origins'],
            'directions': sl['directions'],
            'metadata': {k: v.expand(chunk, v.shape[-1])
                         for k, v in encoded.items()},
            'mask': sl['mask'] if 'mask' in sl else torch.zeros(
                chunk, 1, device=device),
        }
        if sharded:
          chunk_rays = mesh_lib.shard_batch(chunk_rays, mesh)
        out = render_fn(chunk_rays, extra_params, generator)[level]
        out = {k: v for k, v in out.items() if k in keys}
        if sharded:
          out = _gather_rows(out, mesh)
        with tracing.span('nerfds.render.to_host'):
          outs.append({k: v[:n].cpu().numpy() for k, v in out.items()})

    with tracing.span('nerfds.render.assemble'):
      result = {}
      for k in outs[0]:
        stacked = np.concatenate([o[k] for o in outs], axis=0)
        result[k] = stacked.reshape((*batch_shape, *stacked.shape[1:]))
      return result
