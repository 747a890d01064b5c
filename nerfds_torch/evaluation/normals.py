"""Normal-fidelity metric: rendered normals against an analytic ground truth,
counterpart of ``nerfds_tpu/evaluation/normals.py``.

Association is by the median-weight sample: for every ray the sample where
the cumulative compositing weight crosses 0.5 (``compute_depth_index``) is
taken as the surface the model sees, and the observation-frame normal
there (``norm_input``, the canonical predicted normal rotated back through
the screw's R⁻¹) is compared with the analytic normal at that sample's
position. The median-weight sample is robust to diffuse weight tails and
still indexes a real sample, so per-sample normals can be gathered.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from nerfds_torch.ops import rendering


def normal_fidelity(model, params, source, extra_params,
                    analytic_normal: Callable[[np.ndarray, float], np.ndarray],
                    item_ids: Optional[Iterable[str]] = None,
                    chunk: int = 2048,
                    min_weight: float = 0.1,
                    surface_filter: Optional[
                        Callable[[np.ndarray, float], np.ndarray]] = None
                    ) -> Dict[str, float]:
  """Mean cosine between rendered and analytic normals on foreground rays.

  ``params``: a state dict to render with (through
  ``torch.func.functional_call``; the model keeps its own), or None for
  the model's own parameters. analytic_normal(points [N,3], t) -> unit
  normals [N,3] of the scene surface nearest each point at time t.

  Returns {'cosine', 'num_pixels', 'frac_selected'} (+ 'surface_cosine',
  'surface_pixels' when ``surface_filter`` is given). Selected are the
  foreground-mask pixels whose median-weight sample carries more than
  ``min_weight`` compositing weight. surface_filter(points [N,3], t) ->
  bool [N] restricts 'surface_cosine' to associated points on the true
  surface.
  """
  device = model.device
  kwargs = dict(return_full=True, return_weights=True, return_points=True)

  def render_chunk(rays):
    generator = torch.Generator(device=device).manual_seed(0)
    with torch.no_grad():
      if params is None:
        return model.render(rays, extra_params, generator=generator,
                            **kwargs)
      return torch.func.functional_call(
          model, params, (rays, extra_params),
          dict(generator=generator, **kwargs))

  if item_ids is None:
    item_ids = source.train_ids[:4]
  coss, n_sel, n_fg = [], 0, 0
  surf_coss, n_surf = [], 0
  for iid in item_ids:
    item = source.load_item(iid)
    o = item['origins'].reshape(-1, 3)
    d = item['directions'].reshape(-1, 3)
    mask = item['mask'].reshape(-1, 1)
    mask2d = mask[:, 0] > 0.5
    t = source.frame_time(iid)
    sel_pts, sel_norms, sel_mask = [], [], []
    for s0 in range(0, o.shape[0], chunk):
      n = min(chunk, o.shape[0] - s0)
      as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
      sub = {
          'origins': as_t(o[s0:s0 + n]),
          'directions': as_t(d[s0:s0 + n]),
          'mask': as_t(mask[s0:s0 + n]),
          'metadata': {
              k: as_t(np.broadcast_to(v.reshape(-1, v.shape[-1])[:1],
                                      (n, v.shape[-1])))
              for k, v in item['metadata'].items()},
      }
      out = render_chunk(sub)
      f = out['fine'] if 'fine' in out else out['coarse']
      idx = rendering.compute_depth_index(f['weights'])
      rows = torch.arange(idx.shape[0], device=idx.device)
      sel_pts.append(f['points'][rows, idx].cpu().numpy())
      sel_norms.append(f['norm_input'][rows, idx].cpu().numpy())
      sel_mask.append((f['weights'][rows, idx] > min_weight).cpu().numpy())
    pts = np.concatenate(sel_pts)
    norms = np.concatenate(sel_norms)
    resolved = np.concatenate(sel_mask)
    select = mask2d & resolved
    n_fg += int(mask2d.sum())
    n_sel += int(select.sum())
    if not select.sum():
      continue
    gt = analytic_normal(pts[select], t)
    pn = norms[select]
    pn = pn / np.maximum(np.linalg.norm(pn, axis=-1, keepdims=True), 1e-8)
    cos_item = (gt * pn).sum(-1)
    coss.append(float(cos_item.mean()))
    if surface_filter is not None:
      on_surf = surface_filter(pts[select], t)
      n_surf += int(on_surf.sum())
      if on_surf.sum():
        surf_coss.append(float(cos_item[on_surf].mean()))
  out = {
      'cosine': float(np.mean(coss)) if coss else float('nan'),
      'num_pixels': n_sel,
      'frac_selected': n_sel / max(n_fg, 1),
  }
  if surface_filter is not None:
    out['surface_cosine'] = (float(np.mean(surf_coss)) if surf_coss
                             else float('nan'))
    out['surface_pixels'] = n_surf
  return out


def sphere_analytic_normal(center_fn):
  """analytic_normal for the synthetic moving sphere: the outward radial
  direction from the time-t center."""
  def fn(points: np.ndarray, t: float) -> np.ndarray:
    n = points - center_fn(t)
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-8)
  return fn


def sphere_surface_filter(center_fn, max_radius: float = 0.32):
  """surface_filter for the synthetic sphere (σ scale 0.12; the visible
  surface shell sits at radius ≲ 0.3)."""
  def fn(points: np.ndarray, t: float) -> np.ndarray:
    return np.linalg.norm(points - center_fn(t), axis=-1) < max_radius
  return fn
