"""Training losses (L4), counterpart of ``nerfds_tpu/training/losses.py``.

Stop-gradients sit where the JAX package puts them: the compositing
weights are detached in every auxiliary loss, and the normal target is
not, which makes training second order through the σ-gradient.

The port covers every branch the ``nerf_ds`` flag set reaches: rgb,
warp-reg, hyper-reg, the normal difference, back-facing, the 2D mask with
its empty-space gate, the 3D mask and the occlusion term. The elastic and
background losses raise ``NotImplementedError`` (ROADMAP.md, queue 1).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from nerfds_torch.config import ModelConfig, TrainConfig
from nerfds_torch.ops import math as math_ops
from nerfds_torch.ops import rendering

Tensors = Dict[str, torch.Tensor]

# Empty-space mask penalty gate: samples whose compositing α is below this
# threshold count as empty space; the sigmoid steepness makes it a soft step.
EMPTY_ALPHA_THRESHOLD = 0.1
EMPTY_ALPHA_STEEPNESS = 100.0


def percentile_stats(stats: Tensors, name: str, array: torch.Tensor,
                     percentile_step: int = 10) -> None:
  """Deciles of ``array`` as 'percentile/<name>_<p>' stats (linear
  interpolation, as ``jnp.percentile``)."""
  ps = list(range(0, 101, percentile_step))
  # Made on array's device: a copy from the host would synchronise.
  qs = torch.arange(0, 101, percentile_step,
                    device=array.device).to(array.dtype) / 100
  values = torch.quantile(array.reshape(-1), qs)
  for i, p in enumerate(ps):
    stats[f'percentile/{name}_{p}'] = values[i]


def rgb_loss_fn(pred, target, use_shrinkage_loss: bool):
  err = pred[..., :3] - target[..., :3]
  if use_shrinkage_loss:
    return math_ops.shrinkage_loss(err)
  return math_ops.l2_loss(err)


def compute_elastic_loss(*args, **kwargs):
  raise NotImplementedError(
      'the elastic loss needs SE3Field.warp_jacobian, not ported yet; see '
      'ROADMAP.md, queue 1')


def compute_background_loss(*args, **kwargs):
  raise NotImplementedError(
      'the background loss is not ported yet; see ROADMAP.md, queue 1')


def compute_loss_and_stats(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    model_out: Tensors,
    batch: Dict[str, Any],
    scalars: Dict[str, Any],
    *,
    use_elastic_loss: bool = False,
    use_hyper_reg_loss: bool = False,
) -> Tuple[torch.Tensor, Tensors]:
  """One level's total loss and its stats."""
  stats: Tensors = {}

  rgb_loss = rgb_loss_fn(model_out['rgb'], batch['rgb'],
                         train_cfg.use_shrinkage_loss).mean()
  stats['loss/rgb'] = rgb_loss
  loss = rgb_loss

  if use_elastic_loss:
    compute_elastic_loss()

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
    norm_diff = torch.linalg.vector_norm(
        model_out['predicted_norm'] - model_out['target_norm'], dim=-1)
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
      percentile_stats(stats, 'alpha', alpha)
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
    w = (model_out['sharp_weights'].detach()
         if model_cfg.use_mask_sharp_weights else weights)
    ray_predicted_mask = (w * predicted_mask).sum(1)
    predicted_mask_loss = ((gt_mask - ray_predicted_mask) ** 2).mean()
    stats['loss/predicted_mask'] = predicted_mask_loss
    if train_cfg.log_percentiles:
      percentile_stats(stats, '3d_mask', predicted_mask)
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
