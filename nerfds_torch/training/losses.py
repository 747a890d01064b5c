"""Training losses (L4), counterpart of ``nerfds_tpu/training/losses.py``.

Stop-gradients sit where the JAX package puts them: the compositing
weights are detached in every auxiliary loss, and the normal target is
not, which makes training second order through the σ-gradient.

The port covers every branch of the JAX package's losses but the bone
field's background term: rgb, elastic (five residuals, two reductions),
background, warp-reg, hyper-reg, the normal difference, back-facing, the 2D
mask with its empty-space gate, the 3D mask and the occlusion term.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from nerfds_torch.config import ModelConfig, TrainConfig
from nerfds_torch.ops import math as math_ops
from nerfds_torch.ops import rendering
from nerfds_torch.parallel import mesh as mesh_lib

Tensors = Dict[str, torch.Tensor]

# Empty-space mask penalty gate: samples whose compositing α is below this
# threshold count as empty space; the sigmoid steepness makes it a soft step.
EMPTY_ALPHA_THRESHOLD = 0.1
EMPTY_ALPHA_STEEPNESS = 100.0


def percentile_stats(stats: Tensors, name: str, array: torch.Tensor,
                     percentile_step: int = 10,
                     mesh: Optional[mesh_lib.DataMesh] = None) -> None:
  """Deciles of ``array`` as 'percentile/<name>_<p>' stats (linear
  interpolation, as ``jnp.percentile``); under ``mesh``, of every rank's
  ``array`` together, as the JAX package's sharded step takes them over
  the global batch."""
  ps = list(range(0, 101, percentile_step))
  # Made on array's device: a copy from the host would synchronise.
  qs = torch.arange(0, 101, percentile_step,
                    device=array.device).to(array.dtype) / 100
  values = torch.quantile(
      mesh_lib.all_gather_rows(array.detach().reshape(-1), mesh), qs)
  for i, p in enumerate(ps):
    stats[f'percentile/{name}_{p}'] = values[i]


def rgb_loss_fn(pred, target, use_shrinkage_loss: bool):
  err = pred[..., :3] - target[..., :3]
  if use_shrinkage_loss:
    return math_ops.shrinkage_loss(err)
  return math_ops.l2_loss(err)


def compute_elastic_loss(jacobian: torch.Tensor, eps: float = 1e-6,
                         loss_type: str = 'log_svals'
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Elastic regularisation of the warp Jacobian ``[..., 3, 3]``: (the
  Geman-McClure loss of the squared residual, the residual), each
  ``[...]``.

  The singular values come from ``torch.linalg.svdvals``, whose gradient
  stays finite where they repeat, as they do near the identity warp at
  initialisation.
  """
  if loss_type == 'log_svals':
    svals = torch.linalg.svdvals(jacobian)
    sq_residual = (torch.log(torch.clamp(svals, min=eps)) ** 2).sum(-1)
  elif loss_type == 'svals':
    svals = torch.linalg.svdvals(jacobian)
    sq_residual = ((svals - 1.0) ** 2).sum(-1)
  elif loss_type == 'div':
    sq_residual = math_ops.jacobian_to_div(jacobian) ** 2
  elif loss_type == 'det':
    sq_residual = (torch.linalg.det(jacobian) - 1.0) ** 2
  elif loss_type == 'log_det':
    sq_residual = torch.log(torch.clamp(torch.linalg.det(jacobian),
                                        min=eps)) ** 2
  else:
    raise NotImplementedError(f'Unknown elastic loss type {loss_type!r}')
  residual = torch.sqrt(sq_residual)
  loss = math_ops.general_loss_with_squared_residual(
      sq_residual, alpha=-2.0, scale=0.03)
  return loss, residual


def draw_background(num_points: int, num_warp_embeds: int, noise_std: float,
                    generator: Optional[torch.Generator], device
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
  """The background loss's draws: warp ids ``[P, 1]`` uniform over the
  embeddings, and the points' Gaussian jitter ``[P, 3]``."""
  metadata = torch.randint(0, num_warp_embeds, (num_points, 1),
                           generator=generator, device=device)
  noise = noise_std * torch.randn(num_points, 3, generator=generator,
                                  device=device)
  return metadata, noise


def compute_background_loss(model, params: Tensors,
                            points: torch.Tensor, extra_params,
                            noise_std: float,
                            generator: Optional[torch.Generator] = None,
                            draws: Optional[Tuple[torch.Tensor,
                                                  torch.Tensor]] = None,
                            alpha: float = -2.0,
                            scale: float = 0.001) -> torch.Tensor:
  """Penalises motion of known-static points, ``[P]``: the robust loss of
  ‖warp(x) − x‖² at the jittered points, one warp evaluation
  (``model.apply_warp`` on ``params``) over all of them; under
  ``use_bone``, |moving mask| at those points, ``[P, 1]``. ``draws`` =
  (warp ids, jitter) as :func:`draw_background` gives them; without them
  they are drawn from ``generator``."""
  if draws is None:
    draws = draw_background(points.shape[0], model.num_warp_embeds,
                            noise_std, generator, points.device)
  metadata, point_noise = draws
  points = points + point_noise
  if model.config.use_bone:
    # Under the bone field, free space should not move: |moving mask|,
    # [P, 1].
    return torch.func.functional_call(
        model, params, (points, metadata),
        {'method': 'bone_moving_mask'}).abs()
  warped = torch.func.functional_call(
      model, params, (points, metadata, extra_params),
      {'method': 'apply_warp'})
  sq_residual = ((warped - points) ** 2).sum(-1)
  return math_ops.general_loss_with_squared_residual(
      sq_residual, alpha=alpha, scale=scale)


def compute_loss_and_stats(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    model_out: Tensors,
    batch: Dict[str, Any],
    scalars: Dict[str, Any],
    *,
    use_elastic_loss: bool = False,
    use_hyper_reg_loss: bool = False,
    mesh: Optional[mesh_lib.DataMesh] = None,
) -> Tuple[torch.Tensor, Tensors]:
  """One level's total loss and its stats (``mesh``: see
  ``percentile_stats``)."""
  stats: Tensors = {}

  rgb_loss = rgb_loss_fn(model_out['rgb'], batch['rgb'],
                         train_cfg.use_shrinkage_loss).mean()
  stats['loss/rgb'] = rgb_loss
  loss = rgb_loss

  if use_elastic_loss:
    weights = model_out['weights'].detach()
    jacobian = model_out['warp_jacobian']
    if train_cfg.elastic_reduce_method == 'median':
      depth_indices = rendering.compute_depth_index(weights)
      jacobian = torch.gather(
          jacobian, 1, depth_indices[:, None, None, None].expand(-1, 1, 3, 3))
    elastic_loss, elastic_residual = compute_elastic_loss(
        jacobian, loss_type=train_cfg.elastic_loss_type)
    if train_cfg.elastic_reduce_method == 'weight':
      elastic_loss = weights * elastic_loss
    elastic_loss = elastic_loss.sum(-1).mean()
    stats['loss/elastic'] = elastic_loss
    stats['residual/elastic'] = elastic_residual.mean()
    loss = loss + scalars['elastic_loss_weight'] * elastic_loss

  if train_cfg.use_warp_reg_loss:
    weights = model_out['weights'].detach()
    warp_mag = ((model_out['points']
                 - model_out['warped_points'][..., :3]) ** 2).sum(-1)
    depth_indices = rendering.compute_depth_index(weights)
    warp_reg_residual = torch.gather(warp_mag, -1, depth_indices[..., None])
    warp_reg_loss = math_ops.general_loss_with_squared_residual(
        warp_reg_residual, alpha=train_cfg.warp_reg_loss_alpha,
        scale=train_cfg.warp_reg_loss_scale).mean()
    stats['loss/warp_reg'] = warp_reg_loss
    stats['residual/warp_reg'] = torch.sqrt(warp_reg_residual).mean()
    loss = loss + train_cfg.warp_reg_loss_weight * warp_reg_loss

  if use_hyper_reg_loss:
    weights = model_out['weights'].detach()
    hyper_points = model_out['warped_points'][..., 3:]
    hyper_reg_residual = (hyper_points ** 2).sum(-1)
    hyper_reg_loss = math_ops.general_loss_with_squared_residual(
        hyper_reg_residual, alpha=0.0, scale=0.05)
    hyper_reg_loss = (weights * hyper_reg_loss).sum(1).mean()
    stats['loss/hyper_reg'] = hyper_reg_loss
    stats['residual/hyper_reg'] = torch.sqrt(hyper_reg_residual).mean()
    loss = loss + train_cfg.hyper_reg_loss_weight * hyper_reg_loss

  if (model_cfg.use_predicted_norm and 'predicted_norm' in model_out
      and 'target_norm' in model_out):
    weights = model_out['weights'].detach()
    predicted_norm = model_out['predicted_norm']
    if 'norm_topk_idx' in model_out:
      # norm_grad_topk: the target exists at the k highest-weight samples
      # only. Gather the prediction and the weights there and keep the
      # full-S mean, so the loss has the exact path's scale.
      idx = model_out['norm_topk_idx']
      predicted_norm = torch.gather(
          predicted_norm, 1, idx[..., None].expand(-1, -1, 3))
      norm_diff = torch.linalg.vector_norm(
          predicted_norm - model_out['target_norm'], dim=-1)
      norm_diff_loss = ((torch.gather(weights, 1, idx) * norm_diff).sum()
                        / weights.numel())
    else:
      norm_diff = torch.linalg.vector_norm(
          predicted_norm - model_out['target_norm'], dim=-1)
      norm_diff_loss = (weights * norm_diff).mean()
    stats['loss/norm_diff'] = norm_diff_loss
    loss = loss + scalars['norm_loss_weight'] * norm_diff_loss

  if train_cfg.use_back_facing_reg and 'back_facing' in model_out:
    weights = model_out['weights'].detach()
    back_facing_loss = (weights * model_out['back_facing']).mean()
    stats['loss/back_facing'] = back_facing_loss
    loss = loss + train_cfg.back_facing_reg_weight * back_facing_loss

  if 'predicted_mask' in model_out and not model_cfg.use_3d_mask:
    # 2D mask supervision.
    alpha = model_out['alpha'].detach()
    weights = model_out['weights'].detach()
    predicted_mask = model_out['predicted_mask'][..., 0]
    gt_mask = batch['mask'].expand(predicted_mask.shape)
    mask_diff = (predicted_mask - gt_mask).abs()
    predicted_mask_loss = (weights * mask_diff).sum(1).mean()
    stats['loss/predicted_mask'] = predicted_mask_loss
    mask_size = torch.clamp(predicted_mask, 0.0, 1.0)
    low_alpha = 1.0 - torch.sigmoid(
        EMPTY_ALPHA_STEEPNESS * (alpha - EMPTY_ALPHA_THRESHOLD))
    empty_space_loss = (low_alpha * mask_size).sum(1).mean()
    stats['loss/empty_space_mask'] = empty_space_loss
    if train_cfg.log_percentiles:
      percentile_stats(stats, 'alpha', alpha, mesh=mesh)
    stats['stats/low_alpha_mean'] = low_alpha.mean()
    stats['stats/predicted_mask_max'] = predicted_mask.max()
    predicted_mask_loss = (
        predicted_mask_loss
        + train_cfg.empty_space_mask_loss_weight * empty_space_loss)
    loss = loss + train_cfg.predicted_mask_loss_weight * predicted_mask_loss

  if 'predicted_mask' in model_out and model_cfg.use_3d_mask:
    # 3D mask supervision against the per-ray gt mask.
    weights = model_out['weights'].detach()
    predicted_mask = model_out['predicted_mask'][..., 0]
    gt_mask = batch['mask'][..., 0]
    if model_cfg.use_mask_sharp_weights:
      w = model_out['sharp_weights'].detach()
    elif model_cfg.use_mask_scaled_weights:
      w = model_out['scaled_weights'].detach()
    else:
      w = weights
    ray_predicted_mask = (w * predicted_mask).sum(1)
    predicted_mask_loss = ((gt_mask - ray_predicted_mask) ** 2).mean()
    stats['loss/predicted_mask'] = predicted_mask_loss
    if train_cfg.log_percentiles:
      percentile_stats(stats, '3d_mask', predicted_mask, mesh=mesh)
    stats['stats/weights_sum'] = weights.sum(1).mean()
    loss = loss + train_cfg.predicted_mask_loss_weight * predicted_mask_loss
    if train_cfg.use_mask_occlusion_reg_loss:
      low_weights = torch.clamp(0.01 - weights, min=0.0)
      occlusion = (low_weights * predicted_mask.abs()).sum(-1).mean()
      stats['loss/mask_occlusion_reg'] = occlusion
      loss = loss + train_cfg.mask_occlusion_reg_loss_weight * occlusion

  stats['loss/total'] = loss
  stats['metric/psnr'] = math_ops.compute_psnr(rgb_loss)
  return loss, stats
