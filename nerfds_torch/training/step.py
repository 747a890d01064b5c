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
  device-resident ``RayStore`` inside the step, and the background loss's
  points from a device-resident set of static points.
* Under a data mesh (``parallel.DataMesh``) each rank takes
  ``batch_size / world`` rays, the fused step from its own store shard
  with its own generator. The gradients are averaged over the ranks after
  they are taken and before they are frozen, clipped and given to Adam,
  as the JAX partitioner reduces before the clip; the scalar stats are
  averaged too, so every rank logs the global batch's. At world size 1
  the step is the step without a mesh, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from nerfds_torch import tracing
from nerfds_torch.config import TrainConfig
from nerfds_torch.datasets.core import RayStore, sample_batch
from nerfds_torch.models.nerfds import NerfDSModel
from nerfds_torch.ops import math as math_ops
from nerfds_torch.parallel import mesh as mesh_lib
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


def _strided_rows(x: torch.Tensor, mesh: Optional[mesh_lib.DataMesh],
                  limit: int = 2048) -> torch.Tensor:
  """Every ``stride``-th row of the global batch's ``x``, ``stride =
  max(1, rows // limit)``, on every rank: under a mesh each rank picks its
  share of those rows and the shares are gathered."""
  n = x.shape[0]
  world = mesh.world_size if mesh is not None else 1
  stride = max(1, n * world // limit)
  if world == 1:
    return x[::stride]
  first = [(-r * n) % stride for r in range(world)]
  counts = [len(range(f, n, stride)) for f in first]
  return mesh_lib.all_gather_rows(x[first[mesh.rank]::stride], mesh, counts)


def make_loss_fn(model: NerfDSModel, train_cfg: TrainConfig,
                 mesh: Optional[mesh_lib.DataMesh] = None
                 ) -> Callable[..., Tuple[torch.Tensor, Dict[str, Any]]]:
  """loss_fn(params, batch, generator, scalars) -> (total, stats): the
  coarse plus fine loss of the model run on ``params``.

  With ``use_elastic_loss`` the coarse level returns the warp's Jacobian,
  which its elastic term reads (the step then differentiates twice through
  the warp field). With ``use_background_loss`` and
  ``batch['background_points']`` the background loss is added; its draws
  come from ``generator`` after the render's, or from
  ``batch['background_metadata']`` and ``batch['background_noise']`` where
  the caller gives them. A batch without points trains without it.

  Under ``mesh`` the batch is this rank's rows; the percentile stats and
  the 'hist/*' samples are taken over the global batch."""
  model_cfg = model.config

  def loss_fn(params, batch, generator, scalars):
    extra_params = {k: scalars[k] for k in _EXTRA_PARAM_KEYS}
    with tracing.span('nerfds.train.forward'):
      out = torch.func.functional_call(
          model, params, (batch, extra_params),
          dict(generator=generator, return_points=True, return_weights=True,
               mask_ratio=scalars['mask_ratio'],
               sharp_weights_std=scalars['sharp_weights_std'],
               x_for_rgb_alpha=scalars['x_for_rgb_alpha'],
               return_warp_jacobian=(('coarse',)
                                     if train_cfg.use_elastic_loss
                                     else False)))
    with tracing.span('nerfds.train.loss'):
      total = 0.0
      stats: Dict[str, Any] = {}
      if 'fine' in out:
        fine_loss, stats['fine'] = losses_lib.compute_loss_and_stats(
            model_cfg, train_cfg, out['fine'], batch, scalars, mesh=mesh)
        total = total + fine_loss
      coarse_loss, stats['coarse'] = losses_lib.compute_loss_and_stats(
          model_cfg, train_cfg, out['coarse'], batch, scalars,
          use_elastic_loss=train_cfg.use_elastic_loss,
          use_hyper_reg_loss=train_cfg.use_hyper_reg_loss, mesh=mesh)
      total = total + coarse_loss

      if train_cfg.use_background_loss and 'background_points' in batch:
        draws = None
        if 'background_metadata' in batch:
          draws = (batch['background_metadata'], batch['background_noise'])
        background_loss = losses_lib.compute_background_loss(
            model, params, batch['background_points'], extra_params,
            noise_std=train_cfg.background_noise_std, generator=generator,
            draws=draws).mean()
        total = total + train_cfg.background_loss_weight * background_loss
        stats['loss/background'] = background_loss

      if train_cfg.log_histograms:
        # Strided samples of the warped points, about 2048, for histograms.
        o = out['fine' if 'fine' in out else 'coarse']
        warped = o['warped_points'].detach()
        points = o['points'].detach()
        rows = torch.cat([warped, warped[..., :3] - points], -1)
        rows = _strided_rows(rows.reshape(-1, rows.shape[-1]), mesh)
        stats['hist/spatial_points'] = rows[:, :3]
        stats['hist/spatial_points_delta'] = rows[:, -3:]
        if warped.shape[-1] > 3:
          stats['hist/hyper_points'] = rows[:, 3:warped.shape[-1]]
      return total, stats

  return loss_fn


def _detach_stats(stats):
  if isinstance(stats, dict):
    return {k: _detach_stats(v) for k, v in stats.items()}
  return stats.detach()


def _grads(loss_fn, params: Params, batch, generator, scalars):
  leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
  loss, stats = loss_fn(leaves, batch, generator, scalars)
  with tracing.span('nerfds.train.backward'):
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
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
  with tracing.span('nerfds.train.backward'):
    grads_sum = {k: torch.zeros_like(v) for k, v in params.items()}
  all_stats = []
  for mb in _split_batch(batch, accum):
    grads, stats = _grads(loss_fn, params, mb, generator, scalars)
    with tracing.span('nerfds.train.backward'):
      grads_sum = {k: grads_sum[k] + grads[k] for k in grads_sum}
    all_stats.append(stats)
  with tracing.span('nerfds.train.backward'):
    return ({k: g / accum for k, g in grads_sum.items()},
            _stack_stats(all_stats))


def _stat_leaves(stats, path=()):
  for k, v in stats.items():
    if isinstance(v, dict):
      yield from _stat_leaves(v, path + (k,))
    else:
      yield path + (k,), v


def _mesh_reduce(grads: Params, stats, mesh: mesh_lib.DataMesh):
  """The global batch's gradients and stats from this rank's: the mean
  over the ranks of the gradients and of the scalar stats in one
  collective, the largest of each '*_max' stat in another, and each
  level's PSNR from the mean rgb loss. 'percentile/*' and 'hist/*' are
  the global batch's already (``make_loss_fn``)."""
  mean, peak = {}, {}
  for path, v in _stat_leaves(stats):
    name = path[-1]
    if name.startswith(('hist/', 'percentile/')) or name == 'metric/psnr':
      continue
    (peak if name.endswith('_max') else mean)[path] = v
  reduced = mesh_lib.all_reduce_mean({**grads, **mean}, mesh)
  reduced.update(mesh_lib.all_reduce_max(peak, mesh))
  for path in (*mean, *peak):
    level = stats
    for k in path[:-1]:
      level = level[k]
    level[path[-1]] = reduced[path]
  for level in stats.values():
    if isinstance(level, dict) and 'metric/psnr' in level:
      level['metric/psnr'] = math_ops.compute_psnr(level['loss/rgb'])
  return {k: reduced[k] for k in grads}, stats


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
  with tracing.span('nerfds.train.adam'):
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


def _make_step_body(model: NerfDSModel, train_cfg: TrainConfig,
                    mesh: Optional[mesh_lib.DataMesh]):
  """body(state, batch, generator) -> (new state, stats): a step on a
  batch the caller has, inside the caller's ``nerfds.train.step`` span."""
  schedules = build_schedules(train_cfg)
  mesh_lib.check_batch_norm(model.config.norm_type, mesh)
  loss_fn = make_loss_fn(model, train_cfg, mesh)
  accum = max(int(train_cfg.accum_steps), 1)
  reduce = mesh is not None and mesh.world_size > 1

  def body(state: TrainState, batch, generator):
    scalars = eval_schedules(schedules, state.step)
    grads, stats = _accum_grads(loss_fn, state.params, batch, generator,
                                scalars, accum)
    if reduce:
      with tracing.span('nerfds.train.allreduce'):
        grads, stats = _mesh_reduce(grads, stats, mesh)
    return _apply(state, grads, stats, scalars, train_cfg)

  return body


def make_train_step(model: NerfDSModel, train_cfg: TrainConfig,
                    mesh: Optional[mesh_lib.DataMesh] = None):
  """step(state, batch, generator=None) -> (new state, stats). Under
  ``mesh``, ``batch`` is this rank's rows of the global batch
  (``parallel.shard_batch``)."""
  body = _make_step_body(model, train_cfg, mesh)

  def step_fn(state: TrainState, batch, generator=None):
    with tracing.span('nerfds.train.step', unit=state.step):
      return body(state, batch, generator)

  return step_fn


def make_drawing_train_step(model: NerfDSModel, train_cfg: TrainConfig,
                            draw: Callable[[torch.Generator], Dict[str, Any]],
                            mesh: Optional[mesh_lib.DataMesh] = None):
  """step(state, generator) -> (new state, stats), on the batch that
  ``draw(generator)`` gives inside the step (its ``nerfds.train.gather``
  span)."""
  body = _make_step_body(model, train_cfg, mesh)

  def step_fn(state: TrainState, generator: torch.Generator):
    with tracing.span('nerfds.train.step', unit=state.step):
      with tracing.span('nerfds.train.gather'):
        batch = draw(generator)
      return body(state, batch, generator)

  return step_fn


def local_batch_size(train_cfg: TrainConfig,
                     mesh: Optional[mesh_lib.DataMesh]) -> int:
  """This rank's rays a step: ``batch_size / world``."""
  world = mesh.world_size if mesh is not None else 1
  if train_cfg.batch_size % world:
    raise ValueError(f'batch_size={train_cfg.batch_size} does not divide '
                     f'over {world} ranks')
  return train_cfg.batch_size // world


def background_batch_size(train_cfg: TrainConfig, num_points: int,
                          mesh: Optional[mesh_lib.DataMesh]) -> int:
  """This rank's background points a step: min(P,
  ``background_points_batch_size``) rounded down to a multiple of world ×
  ``accum_steps``, so that the ranks and the microbatches split them
  evenly, divided by the world size."""
  accum = max(int(train_cfg.accum_steps), 1)
  world = mesh.world_size if mesh is not None else 1
  n_bg = min(num_points, train_cfg.background_points_batch_size)
  n_bg -= n_bg % (accum * world)
  if n_bg == 0:
    # A mean over no points is NaN, which would reach every parameter.
    raise ValueError(
        f'{num_points} background points and background_points_batch_size='
        f'{train_cfg.background_points_batch_size} leave no point for '
        f'each of accum_steps={accum} microbatches on {world} ranks')
  return n_bg // world


def make_fused_train_step(model: NerfDSModel, train_cfg: TrainConfig,
                          store: RayStore,
                          background_points: Optional[torch.Tensor] = None,
                          mesh: Optional[mesh_lib.DataMesh] = None):
  """step(state, generator) -> (new state, stats), gathering a uniform
  minibatch of ``train_cfg.batch_size`` rays (``/ world`` under ``mesh``,
  from this rank's ``store``) from the device-resident ``store`` with
  ``generator`` (on the store's device) inside the step.

  With ``use_background_loss`` and ``background_points`` [P, 3] on the
  store's device, each step also draws ``background_batch_size`` of
  them."""
  batch_size = local_batch_size(train_cfg, mesh)
  n_bg = 0
  if train_cfg.use_background_loss and background_points is not None:
    n_bg = background_batch_size(train_cfg, background_points.shape[0], mesh)

  def draw(generator: torch.Generator):
    batch = sample_batch(store, generator, batch_size)
    if n_bg:
      idx = torch.randint(0, background_points.shape[0], (n_bg,),
                          generator=generator,
                          device=background_points.device)
      batch['background_points'] = background_points.index_select(0, idx)
    return batch

  return make_drawing_train_step(model, train_cfg, draw, mesh)
