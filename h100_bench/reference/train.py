"""The plain reference of one training step: the annealing schedules, the
losses of both levels, the gradient by autograd and Adam.

It follows ``configs/<name>.json``'s ``train`` section for the losses the
two configurations use (rgb; with NeRF-DS's flags also the warp
regulariser, the normal difference, back-facing and the 3D mask) and
refuses any other loss switched on. A batch is gathered from the ray store
with the step's generator, as the fused step of the program gathers it:
``torch.randint`` over the rays, then the model's draws.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from h100_bench.reference import model as ref

Params = Dict[str, torch.Tensor]
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8

_OFF = ('use_elastic_loss', 'use_background_loss', 'use_hyper_reg_loss',
        'use_shrinkage_loss', 'use_mask_occlusion_reg_loss',
        'disable_hyper_grads')


# -- schedules ------------------------------------------------------------------


def schedule(spec):
  """step -> float32 value of a ``(type, *args)`` schedule."""
  f32 = lambda s: torch.as_tensor(s, dtype=torch.float32)
  if isinstance(spec, (int, float)):
    spec = ('constant', spec)
  kind, *args = spec
  if kind == 'constant':
    return lambda s: torch.full_like(f32(s), args[0])
  if kind == 'linear':
    a, b, n = args
    return lambda s: ((1.0 - torch.clamp(f32(s) / n, max=1.0)) * a
                      + torch.clamp(f32(s) / n, max=1.0) * b)
  if kind == 'exponential':
    a, b, n = args
    base = torch.tensor(max(b, 1e-10) / a, dtype=torch.float32)
    return lambda s: torch.where(f32(s) >= n, torch.full_like(f32(s), b),
                                 a * base ** (f32(s) / (n - 1)))
  if kind == 'piecewise':
    parts = [(d, schedule(c)) for d, c in args[0]]
    starts = [0]
    for d, _ in parts[:-1]:
      starts.append(starts[-1] + d)

    def get(s):
      i = max(k for k, start in enumerate(starts) if f32(s) >= start)
      return parts[i][1](f32(s) - starts[i])
    return get
  raise NotImplementedError(kind)


SCALARS = {'learning_rate': 'lr_schedule',
           'nerf_alpha': 'nerf_alpha_schedule',
           'warp_alpha': 'warp_alpha_schedule',
           'hyper_alpha': 'hyper_alpha_schedule',
           'hyper_sheet_alpha': 'hyper_sheet_alpha_schedule',
           'norm_loss_weight': 'norm_loss_weight_schedule',
           'norm_input_alpha': 'norm_input_alpha_schedule',
           'mask_ratio': 'mask_ratio_schedule',
           'sharp_weights_std': 'sharp_mask_std_schedule'}


def scalars_at(train_cfg: Dict, step: int) -> Dict[str, float]:
  return {k: float(schedule(train_cfg[v])(step)) for k, v in SCALARS.items()}


# -- losses ---------------------------------------------------------------------


def robust(x_sq, alpha: float, scale: float):
  """Barron's general loss on a squared residual, for alpha not in
  {0, 2, ±inf}."""
  loss_two = 0.5 * x_sq / (scale ** 2)
  a = math.copysign(max(abs(alpha), ref.F32_EPS), alpha)
  b = max(abs(alpha - 2), ref.F32_EPS)
  return scale * (b / a) * ((loss_two / (0.5 * b) + 1) ** (0.5 * alpha) - 1)


def level_loss(model_cfg: Dict, train_cfg: Dict, out, rgb_target, gt_mask,
               scalars) -> torch.Tensor:
  loss = ((out['rgb'] - rgb_target) ** 2).mean()
  weights = out['weights'].detach()
  if train_cfg['use_warp_reg_loss']:
    mag = ((out['points'] - out['warped'][..., :3]) ** 2).sum(-1)
    residual = torch.gather(mag, -1, ref.depth_index(weights)[..., None])
    loss = loss + train_cfg['warp_reg_loss_weight'] * robust(
        residual, train_cfg['warp_reg_loss_alpha'],
        train_cfg['warp_reg_loss_scale']).mean()
  if ref.is_nerf_ds(model_cfg):
    diff = torch.linalg.vector_norm(out['predicted_norm']
                                    - out['target_norm'], dim=-1)
    loss = loss + scalars['norm_loss_weight'] * (weights * diff).mean()
    if train_cfg['use_back_facing_reg']:
      loss = loss + train_cfg['back_facing_reg_weight'] * (
          weights * out['back_facing']).mean()
    ray_mask = (out['sharp_weights'].detach()
                * out['predicted_mask']).sum(1)
    loss = loss + train_cfg['predicted_mask_loss_weight'] * (
        (gt_mask[..., 0] - ray_mask) ** 2).mean()
  return loss


# -- the step -------------------------------------------------------------------


def gather(store: Dict, generator, batch_size: int) -> Dict:
  """The rows of a uniform draw from the store, as the fused step draws
  them."""
  idx = torch.randint(0, store['origins'].shape[0], (batch_size,),
                      generator=generator, device=store['origins'].device)
  return {k: v.index_select(0, idx) for k, v in store.items()}


def loss_and_grads(P: Params, model_cfg: Dict, train_cfg: Dict, batch,
                   generator, scalars, near: float, far: float
                   ) -> Tuple[torch.Tensor, Params]:
  leaves = {k: v.detach().requires_grad_() for k, v in P.items()}
  out = ref.render(leaves, model_cfg, batch['origins'], batch['directions'],
                   batch['warp'][:, 0].long(), batch['mask'], scalars,
                   lambda shape: torch.rand(shape, generator=generator,
                                            device=batch['rgb'].device),
                   near, far, with_grad=True)
  total = sum(level_loss(model_cfg, train_cfg, out[lv], batch['rgb'],
                         batch['mask'], scalars)
              for lv in reversed(ref.levels(model_cfg)))
  grads = torch.autograd.grad(total, list(leaves.values()),
                              allow_unused=True)
  return total.detach(), {k: torch.zeros_like(v) if g is None else g
                          for (k, v), g in zip(leaves.items(), grads)}


def adam(P: Params, grads: Params, mu: Params, nu: Params, count: int,
         lr: float) -> Tuple[Params, Params, Params]:
  """``optax.scale_by_adam`` with bias correction by the incremented
  count, then ``p - lr * u``."""
  mu = {k: (1 - ADAM_B1) * g + ADAM_B1 * mu[k] for k, g in grads.items()}
  nu = {k: (1 - ADAM_B2) * g ** 2 + ADAM_B2 * nu[k] for k, g in grads.items()}
  device = next(iter(P.values())).device
  bc1, bc2 = (torch.full((), float(1 - torch.tensor(b, dtype=torch.float32)
                                   ** count), device=device)
              for b in (ADAM_B1, ADAM_B2))
  P = {k: p + (-lr * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + ADAM_EPS)))
       for k, p in P.items()}
  return P, mu, nu


def check_train_config(train_cfg: Dict) -> None:
  for key in _OFF:
    if train_cfg[key]:
      raise NotImplementedError(f'the reference runs without {key}')
  if train_cfg['grad_max_val'] or train_cfg['grad_max_norm']:
    raise NotImplementedError('the reference runs without clipping')
  if train_cfg['accum_steps'] > 1:
    raise NotImplementedError('the reference runs one microbatch')


def follow(P: Params, model_cfg: Dict, train_cfg: Dict, store: Dict,
           seeds, start_step: int, near: float, far: float,
           tf32: bool = False) -> Dict:
  """``len(seeds)`` steps from ``P`` at steps ``start_step``, ... with a
  fresh Adam state, step i drawing from a generator seeded ``seeds[i]``.
  Returns each step's loss, the first step's gradients and parameters,
  and the final parameters. ``tf32`` runs the float32 products in TF32 (the control)."""
  check_train_config(train_cfg)
  with ref.precision(tf32):
    device = store['origins'].device
    mu = {k: torch.zeros_like(v) for k, v in P.items()}
    nu = {k: torch.zeros_like(v) for k, v in P.items()}
    losses, first, first_params = [], None, None
    for i, seed in enumerate(seeds):
      g = torch.Generator(device=device).manual_seed(seed)
      batch = gather(store, g, train_cfg['batch_size'])
      scalars = scalars_at(train_cfg, start_step + i)
      loss, grads = loss_and_grads(P, model_cfg, train_cfg, batch, g,
                                   scalars, near, far)
      losses.append(float(loss))
      first = grads if first is None else first
      P, mu, nu = adam(P, grads, mu, nu, i + 1, scalars['learning_rate'])
      first_params = P if first_params is None else first_params
    return {'losses': losses, 'grads': first, 'first_params': first_params,
            'params': P}
