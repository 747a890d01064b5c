"""Train state and the training step (L4), counterpart of
``nerfds_tpu/training/step.py``.

* ``TrainState``: the step, the parameters as a dict of tensors named as
  the model's state dict, and Adam's moments (``AdamState``, the fields of
  optax's ``ScaleByAdamState``).
* The step evaluates every annealing schedule at the state's step, runs
  the model on the state's parameters through
  ``torch.func.functional_call``, takes the gradients of the coarse plus
  fine loss (optionally as ``accum_steps`` microbatches), freezes or clips
  them as configured, and applies Adam as ``optax.scale_by_adam()`` does
  (b1 0.9, b2 0.999, eps 1e-8, bias correction by the incremented count)
  with the update −lr·u, lr from the schedule at the step before the
  increment.
* The step is functional, as in the JAX package: it returns a new state
  and leaves the one it was given as it was.
* ``make_fused_train_step`` gathers the minibatch on the device from a
  device-resident ``RayStore`` inside the step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from nerfds_torch.config import TrainConfig
from nerfds_torch.datasets.core import RayStore, sample_batch
from nerfds_torch.models.nerfds import NerfDSModel
from nerfds_torch.ops import math as math_ops
from nerfds_torch.training import losses as losses_lib
from nerfds_torch.training import schedules as schedules_lib

Params = Dict[str, torch.Tensor]
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
_EXTRA_PARAM_KEYS = ('nerf_alpha', 'warp_alpha', 'hyper_alpha',
                     'hyper_sheet_alpha', 'norm_input_alpha')


@dataclasses.dataclass
class AdamState:
  """Adam's step count and first and second moments, one per parameter."""
  count: int
  mu: Params
  nu: Params


@dataclasses.dataclass
class TrainState:
  """Training state: step counter, parameters, Adam moments."""
  step: int
  params: Params
  opt_state: AdamState

  @classmethod
  def create(cls, params: Params) -> 'TrainState':
    params = {k: v.detach().clone() for k, v in params.items()}
    zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}
    return cls(step=0, params=params,
               opt_state=AdamState(count=0, mu=zeros(), nu=zeros()))


def build_schedules(train_cfg: TrainConfig) -> Dict[str, Any]:
  """Every annealing schedule as a step -> value function."""
  sc = schedules_lib.from_config
  return {
      'learning_rate': sc(train_cfg.lr_schedule),
      'nerf_alpha': sc(train_cfg.nerf_alpha_schedule),
      'warp_alpha': sc(train_cfg.warp_alpha_schedule),
      'hyper_alpha': sc(train_cfg.hyper_alpha_schedule),
      'hyper_sheet_alpha': sc(train_cfg.hyper_sheet_alpha_schedule),
      'elastic_loss_weight': sc(train_cfg.elastic_loss_weight_schedule),
      'norm_loss_weight': sc(train_cfg.norm_loss_weight_schedule),
      'norm_input_alpha': sc(train_cfg.norm_input_alpha_schedule),
      'mask_ratio': sc(train_cfg.mask_ratio_schedule),
      'sharp_weights_std': sc(train_cfg.sharp_mask_std_schedule),
      'x_for_rgb_alpha': sc(train_cfg.x_for_rgb_alpha_schedule),
  }


def eval_schedules(schedules: Dict[str, Any], step) -> Dict[str, float]:
  """The schedules' float32 values at ``step``, as Python floats."""
  return {k: float(fn(step)) for k, fn in schedules.items()}


def _freeze_subtree_grads(grads: Params, prefix: str) -> Params:
  """Zeroes the gradients under a top-level module: a true freeze."""
  return {k: torch.zeros_like(g) if k.startswith(prefix + '.') else g
          for k, g in grads.items()}


def make_loss_fn(model: NerfDSModel, train_cfg: TrainConfig
                 ) -> Callable[..., Tuple[torch.Tensor, Dict[str, Any]]]:
  """loss_fn(params, batch, generator, scalars) -> (total, stats): the
  coarse plus fine loss of the model run on ``params``."""
  model_cfg = model.config
  if train_cfg.use_elastic_loss:
    losses_lib.compute_elastic_loss()
  if train_cfg.use_background_loss:
    losses_lib.compute_background_loss()

  def loss_fn(params, batch, generator, scalars):
    extra_params = {k: scalars[k] for k in _EXTRA_PARAM_KEYS}
    out = torch.func.functional_call(
        model, params, (batch, extra_params),
        dict(generator=generator, return_points=True, return_weights=True,
             mask_ratio=scalars['mask_ratio'],
             sharp_weights_std=scalars['sharp_weights_std']))
    total = 0.0
    stats: Dict[str, Any] = {}
    if 'fine' in out:
      fine_loss, stats['fine'] = losses_lib.compute_loss_and_stats(
          model_cfg, train_cfg, out['fine'], batch, scalars)
      total = total + fine_loss
    coarse_loss, stats['coarse'] = losses_lib.compute_loss_and_stats(
        model_cfg, train_cfg, out['coarse'], batch, scalars,
        use_hyper_reg_loss=train_cfg.use_hyper_reg_loss)
    total = total + coarse_loss

    if train_cfg.log_histograms:
      # Strided samples of the warped points, at most 2048, for histograms.
      o = out['fine' if 'fine' in out else 'coarse']
      warped = o['warped_points'].detach()
      points = o['points'].detach()
      spatial = warped[..., :3].reshape(-1, 3)
      delta = (warped[..., :3] - points).reshape(-1, 3)
      stride = max(1, spatial.shape[0] // 2048)
      stats['hist/spatial_points'] = spatial[::stride]
      stats['hist/spatial_points_delta'] = delta[::stride]
      if warped.shape[-1] > 3:
        hyper = warped[..., 3:].reshape(-1, warped.shape[-1] - 3)
        stats['hist/hyper_points'] = hyper[::stride]
    return total, stats

  return loss_fn


def _detach_stats(stats):
  if isinstance(stats, dict):
    return {k: _detach_stats(v) for k, v in stats.items()}
  return stats.detach()


def _grads(loss_fn, params: Params, batch, generator, scalars):
  leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
  loss, stats = loss_fn(leaves, batch, generator, scalars)
  grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
  grads = {k: torch.zeros_like(v) if g is None else g
           for (k, v), g in zip(leaves.items(), grads)}
  return grads, _detach_stats(stats)


def _split_batch(batch, accum: int):
  def split(x):
    if isinstance(x, dict):
      return {k: split(v) for k, v in x.items()}
    if x.shape[0] % accum:
      raise ValueError(f'batch leading dim {x.shape[0]} not divisible '
                       f'by accum_steps={accum}')
    return x.reshape(accum, x.shape[0] // accum, *x.shape[1:])

  def pick(x, i):
    return {k: pick(v, i) for k, v in x.items()} if isinstance(x, dict) \
        else x[i]

  stacked = split(batch)
  return [pick(stacked, i) for i in range(accum)]


def _stack_stats(all_stats):
  first = all_stats[0]
  if isinstance(first, dict):
    return {k: _stack_stats([s[k] for s in all_stats]) for k in first}
  # Scalar stats average over microbatches; per-sample arrays (histograms)
  # keep the last microbatch's.
  if first.dim() == 0:
    return torch.stack(all_stats).mean(0)
  return all_stats[-1]


def _accum_grads(loss_fn, params: Params, batch, generator, scalars,
                 accum: int):
  """Gradients over the batch, or the mean of ``accum`` microbatches'
  gradients: every loss term is a mean over rays or points, so the mean
  of the microbatch gradients is the full-batch gradient, while the peak
  activation memory follows the microbatch."""
  if accum <= 1:
    return _grads(loss_fn, params, batch, generator, scalars)
  grads_sum = {k: torch.zeros_like(v) for k, v in params.items()}
  all_stats = []
  for mb in _split_batch(batch, accum):
    grads, stats = _grads(loss_fn, params, mb, generator, scalars)
    grads_sum = {k: grads_sum[k] + grads[k] for k in grads_sum}
    all_stats.append(stats)
  return ({k: g / accum for k, g in grads_sum.items()},
          _stack_stats(all_stats))


def adam_update(grads: Params, state: AdamState,
                b1: float = ADAM_B1, b2: float = ADAM_B2,
                eps: float = ADAM_EPS) -> Tuple[Params, AdamState]:
  """``optax.scale_by_adam().update``: (updates u, new state)."""
  mu = {k: (1 - b1) * g + b1 * state.mu[k] for k, g in grads.items()}
  nu = {k: (1 - b2) * (g ** 2) + b2 * state.nu[k] for k, g in grads.items()}
  count = state.count + 1
  # The bias corrections in float32, as optax rounds them, filled in as
  # tensors on the moments' device: a copy from the host would make the
  # host wait for the card, and CUDA divides by a Python number as a
  # multiply by its reciprocal, which rounds otherwise than optax.
  device = next(iter(grads.values())).device
  bc1, bc2 = (torch.full((), float(1 - torch.tensor(b, dtype=torch.float32)
                                   ** count), dtype=torch.float32,
                         device=device)
              for b in (b1, b2))
  updates = {k: (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
             for k in grads}
  return updates, AdamState(count=count, mu=mu, nu=nu)


def _apply(state: TrainState, grads: Params, stats, scalars,
           train_cfg: TrainConfig) -> Tuple[TrainState, Dict[str, Any]]:
  if train_cfg.disable_hyper_grads:
    grads = _freeze_subtree_grads(grads, 'hyper_sheet')
  if train_cfg.grad_max_val > 0 or train_cfg.grad_max_norm > 0:
    grads = math_ops.clip_gradients(grads, train_cfg.grad_max_val,
                                    train_cfg.grad_max_norm)
  updates, opt_state = adam_update(grads, state.opt_state)
  lr = scalars['learning_rate']
  params = {k: p + (-lr * updates[k]) for k, p in state.params.items()}
  stats['learning_rate'] = lr
  return TrainState(step=state.step + 1, params=params,
                    opt_state=opt_state), stats


def make_train_step(model: NerfDSModel, train_cfg: TrainConfig):
  """step(state, batch, generator=None) -> (new state, stats)."""
  schedules = build_schedules(train_cfg)
  loss_fn = make_loss_fn(model, train_cfg)
  accum = max(int(train_cfg.accum_steps), 1)

  def step_fn(state: TrainState, batch, generator=None):
    scalars = eval_schedules(schedules, state.step)
    grads, stats = _accum_grads(loss_fn, state.params, batch, generator,
                                scalars, accum)
    return _apply(state, grads, stats, scalars, train_cfg)

  return step_fn


def make_fused_train_step(model: NerfDSModel, train_cfg: TrainConfig,
                          store: RayStore,
                          background_points: Optional[torch.Tensor] = None):
  """step(state, generator) -> (new state, stats), gathering a uniform
  minibatch of ``train_cfg.batch_size`` rays from the device-resident
  ``store`` with ``generator`` (on the store's device) inside the step."""
  if background_points is not None or train_cfg.use_background_loss:
    losses_lib.compute_background_loss()
  explicit = make_train_step(model, train_cfg)

  def step_fn(state: TrainState, generator: torch.Generator):
    batch = sample_batch(store, generator, train_cfg.batch_size)
    return explicit(state, batch, generator)

  return step_fn
