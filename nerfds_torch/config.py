"""Typed configuration tree of the PyTorch port.

A field-for-field copy of ``nerfds_tpu/config.py``: the same dataclasses,
the same defaults and the same presets, so a ``model_config.json`` written
by either package loads in the other. The port keeps its own copy so that it
installs and imports without the JAX package.

Fields the port does not run yet are kept for the JSON round trip; the model
raises ``NotImplementedError`` for them (see ``models/nerfds.py``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
  """Static model architecture and feature flags."""
  # NeRF rendering.
  num_coarse_samples: int = 64
  num_fine_samples: int = 64
  use_stratified_sampling: bool = True
  use_white_background: bool = False
  use_linear_disparity: bool = False
  use_sample_at_infinity: bool = True
  noise_std: Optional[float] = None

  # NeRF architecture.
  nerf_trunk_depth: int = 8
  nerf_trunk_width: int = 256
  nerf_rgb_branch_depth: int = 1
  nerf_rgb_branch_width: int = 128
  nerf_skips: Tuple[int, ...] = (4,)
  activation: str = 'relu'
  sigma_activation: str = 'softplus'
  # Parameter-free hidden-layer norm: None | 'layer' | 'group' | 'batch'.
  norm_type: Optional[str] = None
  use_viewdirs: bool = True

  # Positional encodings.
  spatial_point_min_deg: int = 0
  spatial_point_max_deg: int = 8
  hyper_point_min_deg: int = 0
  hyper_point_max_deg: int = 1
  viewdir_min_deg: int = 0
  viewdir_max_deg: int = 4
  use_posenc_identity: bool = False

  # Appearance/camera metadata conditions.
  use_nerf_embed: bool = False
  nerf_embed_key: str = 'appearance'
  nerf_embed_dims: int = 8
  use_alpha_condition: bool = False
  use_rgb_condition: bool = False

  # Warp field.
  use_warp: bool = False
  warp_field_type: str = 'se3'  # 'se3' | 'dual_quaternion' | 'translation'
  warp_embed_key: str = 'warp'
  warp_embed_dims: int = 8
  warp_min_deg: int = 0
  warp_max_deg: int = 8
  se3_trunk_depth: int = 6
  se3_trunk_width: int = 128
  se3_skips: Tuple[int, ...] = (4,)

  # Skeleton (bone) warp alternative.
  use_bone: bool = False
  num_bones: int = 3
  bone_trunk_depth: int = 4
  bone_trunk_width: int = 32
  bone_moving_mlp_depth: int = 6
  bone_moving_mlp_width: int = 128

  # Hyper (ambient) slicing.
  hyper_slice_method: str = 'none'    # 'none' | 'axis_aligned_plane' | 'bendy_sheet'
  hyper_num_dims: int = 2
  hyper_embed_key: str = 'warp'
  hyper_embed_dims: int = 8
  hyper_use_warp_embed: bool = True
  hyper_sheet_min_deg: int = 0
  hyper_sheet_max_deg: int = 6
  hyper_sheet_depth: int = 6
  hyper_sheet_width: int = 64
  hyper_sheet_skips: Tuple[int, ...] = (4,)
  use_hyper_for_sigma: bool = True
  use_hyper_for_rgb: bool = False

  # Screw-axis rgb conditioning: None | 'rotation' | 'full'.
  screw_input_mode: Optional[str] = None

  # Hyper-c: ambient coordinates for the colour branch.
  use_hyper_c: bool = False
  hyper_c_hyper_input: bool = False
  use_hyper_c_embed: bool = True
  hyper_c_num_dims: int = 2
  hyper_c_embed_dims: int = 8

  # Surface normals / specular branch.
  predict_norm: bool = False
  norm_supervision_type: str = 'warped'  # warped | canonical | direct | canonical_unwarped
  stop_norm_gradient: bool = True
  norm_input_posenc: bool = True
  norm_input_min_deg: int = 0
  norm_input_max_deg: int = 4
  use_sigma_gradient: bool = False
  use_predicted_norm: bool = False
  use_ref_radiance: bool = False
  use_x_in_rgb_condition: bool = False
  window_x_in_rgb_condition: bool = False
  use_delta_x_in_rgb_condition: bool = False
  x_for_rgb_min_deg: int = 0
  x_for_rgb_max_deg: int = 4

  # Mask guidance.
  use_mask_in_warp: bool = False
  use_mask_in_hyper: bool = False
  use_mask_in_rgb: bool = False
  use_predicted_mask: bool = False
  use_mask_embed: bool = True
  use_3d_mask: bool = False
  mask_embed_dims: int = 8
  mask_mlp_depth: int = 6
  mask_mlp_width: int = 64
  mask_min_deg: int = 0
  mask_max_deg: int = 6
  mask_skips: Tuple[int, ...] = (4,)
  mask_output_activation: Optional[str] = 'relu'
  clamp_predicted_mask: bool = False
  predicted_mask_clamp_threshold: float = 0.2
  use_coarse_depth_for_mask: bool = False
  use_mask_scaled_weights: bool = False
  use_mask_sharp_weights: bool = False
  use_rgb_sharp_weights: bool = False

  # Numerics.
  matmul_precision: Optional[str] = None
  # MLP compute dtype: None keeps f32 everywhere.
  compute_dtype: Optional[str] = None
  bf16_zones: Optional[Tuple[str, ...]] = None
  storage_dtype: Optional[str] = None
  storage_zones: Optional[Tuple[str, ...]] = None
  # Composite through the hand-written compositing kernel
  # (``kernels/composite.py``) instead of the plain PyTorch formula. The
  # name is shared with the JAX package, where it selects its Pallas kernel.
  use_pallas_compositing: bool = False
  # How the per-point ∇σ is computed:
  #  'vmap'  — autograd of Σσ over the whole σ path (the default);
  #  'fused' — the hand-written trunk kernel returns σ, the heads and
  #            ∂σ/∂feat in one launch; autograd pulls g back through the
  #            warp/hyper/posenc feature path. Same numbers as 'vmap'.
  #  'jvp' | 'vjp' | 'naive' — JAX-package modes, not ported yet.
  sigma_gradient_mode: str = 'vmap'
  concat_dense_inputs: bool = False
  remat_sigma: bool = False
  remat_policy: str = 'nothing'
  remat_feat: bool = False
  stop_target_norm_gradient: bool = False
  # Compute the ∇σ target only at the k highest-weight samples per ray.
  norm_grad_topk: Optional[int] = None

  def __post_init__(self):
    if self.norm_grad_topk is not None and self.norm_grad_topk < 1:
      raise ValueError(
          f'norm_grad_topk must be >= 1 or None, got {self.norm_grad_topk}')

  # -- derived --------------------------------------------------------------

  @property
  def norm_grad_topk_active(self) -> bool:
    """Whether the configured ``norm_grad_topk`` speed mode can take effect."""
    return bool(
        self.norm_grad_topk
        and self.predict_norm
        and not self.use_sigma_gradient
        and self.norm_supervision_type in ('warped', 'direct')
        and self.sigma_gradient_mode in ('vmap', 'naive'))

  @property
  def has_hyper(self) -> bool:
    return self.hyper_slice_method != 'none'

  @property
  def needs_sigma_gradient(self) -> bool:
    """∇σ is needed as the normal itself or as the prediction target."""
    return self.use_sigma_gradient or self.predict_norm

  @property
  def num_total_samples(self) -> int:
    n = self.num_coarse_samples
    if self.num_fine_samples > 0:
      n += self.num_fine_samples
    return n


@dataclasses.dataclass(frozen=True)
class TrainConfig:
  """Training loop configuration (schedule fields take schedule tuples)."""
  batch_size: int = 512
  max_steps: int = 250000
  lr_schedule: Any = ('exponential', 1e-3, 1e-5, 250000)
  nerf_alpha_schedule: Any = ('constant', 8)
  warp_alpha_schedule: Any = ('constant', 8)
  hyper_alpha_schedule: Any = ('constant', 1)
  hyper_sheet_alpha_schedule: Any = ('constant', 6)

  use_elastic_loss: bool = False
  elastic_loss_weight_schedule: Any = ('constant', 0.01)
  elastic_reduce_method: str = 'weight'
  elastic_loss_type: str = 'log_svals'
  use_background_loss: bool = False
  background_loss_weight: float = 0.0
  background_noise_std: float = 0.001
  background_points_batch_size: int = 16384
  use_warp_reg_loss: bool = False
  warp_reg_loss_weight: float = 0.0
  warp_reg_loss_alpha: float = -2.0
  warp_reg_loss_scale: float = 0.001
  use_hyper_reg_loss: bool = False
  hyper_reg_loss_weight: float = 0.0

  # Specular / norm losses.
  norm_loss_weight_schedule: Any = ('constant', 0.001)
  norm_input_alpha_schedule: Any = ('constant', 4)
  use_back_facing_reg: bool = False
  back_facing_reg_weight: float = 0.0
  use_shrinkage_loss: bool = False

  # Mask losses.
  predicted_mask_loss_weight: float = 1.0
  empty_space_mask_loss_weight: float = 0.003
  mask_ratio_schedule: Any = ('constant', 1.0)
  use_mask_occlusion_reg_loss: bool = False
  mask_occlusion_reg_loss_weight: float = 1.0
  sharp_mask_std_schedule: Any = ('constant', 1.0)
  x_for_rgb_alpha_schedule: Any = ('constant', 4.0)

  disable_hyper_grads: bool = False
  grad_max_val: float = 0.0
  grad_max_norm: float = 0.0

  save_every: int = 1000
  print_every: int = 100
  log_every: int = 100
  random_seed: int = 0

  log_percentiles: bool = True
  log_histograms: bool = True

  donate_batch: bool = True
  accum_steps: int = 1

  def __post_init__(self):
    # Schedule configs may arrive as dicts/lists from JSON; freeze to tuples
    # so the dataclass stays hashable.
    for f in dataclasses.fields(self):
      v = getattr(self, f.name)
      if isinstance(v, (dict, list)):
        object.__setattr__(self, f.name, _freeze(v))


def _freeze(v):
  if isinstance(v, dict):
    return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
  if isinstance(v, (list, tuple)):
    return tuple(_freeze(x) for x in v)
  return v


@dataclasses.dataclass(frozen=True)
class EvalConfig:
  """Evaluation/render configuration."""
  eval_once: bool = False
  save_output: bool = True
  chunk: int = 8192
  num_val_eval: Optional[int] = 10
  num_train_eval: Optional[int] = 10
  num_test_eval: Optional[int] = 10
  subname: str = ''
  max_render_checkpoints: int = 3


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
  """Run identity: dataset + model + train + eval."""
  data_dir: str = ''
  image_scale: int = 1
  random_seed: int = 0
  datasource_type: str = 'nerfies'  # 'nerfies' | 'interp' | 'synthetic'
  interp_interval: int = 4
  synthetic_frames: int = 8
  synthetic_image_size: int = 64


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------


def vanilla_nerf(num_coarse_samples: int = 64,
                 num_fine_samples: int = 0) -> ModelConfig:
  """Static NeRF: no warp, no hyper, no masks."""
  return ModelConfig(
      num_coarse_samples=num_coarse_samples,
      num_fine_samples=num_fine_samples,
      use_warp=False,
      hyper_slice_method='none',
  )


def hypernerf(use_hyper: bool = True) -> ModelConfig:
  """HyperNeRF-style deformation (+optional ambient slicing)."""
  return ModelConfig(
      use_warp=True,
      warp_max_deg=8,
      hyper_slice_method='bendy_sheet' if use_hyper else 'none',
      hyper_num_dims=2,
  )


def nerf_ds() -> ModelConfig:
  """The full shipped NeRF-DS configuration (configs/nerf_ds.gin)."""
  return ModelConfig(
      num_coarse_samples=64,
      num_fine_samples=64,
      spatial_point_min_deg=0,
      spatial_point_max_deg=8,
      hyper_point_min_deg=0,
      hyper_point_max_deg=1,
      use_posenc_identity=False,
      use_warp=True,
      warp_min_deg=0,
      warp_max_deg=4,
      hyper_slice_method='bendy_sheet',
      hyper_num_dims=2,
      hyper_use_warp_embed=True,
      hyper_sheet_min_deg=0,
      hyper_sheet_max_deg=6,
      predict_norm=True,
      norm_supervision_type='warped',
      use_predicted_norm=True,
      use_x_in_rgb_condition=True,
      use_mask_in_warp=True,
      use_mask_in_hyper=True,
      use_predicted_mask=True,
      use_3d_mask=True,
      use_mask_sharp_weights=True,
      mask_mlp_depth=8,
      mask_mlp_width=128,
      mask_output_activation='relu',
  )


def nerf_ds_fast() -> ModelConfig:
  """NeRF-DS with the ``norm_grad_topk=16`` speed mode."""
  return dataclasses.replace(nerf_ds(), norm_grad_topk=16)


def nerf_ds_train_config(max_steps: int = 250000,
                         batch_size: int = 512,
                         scale_schedules: bool = False) -> TrainConfig:
  """Training losses/schedules of configs/nerf_ds.gin.

  ``scale_schedules=True`` compresses every schedule horizon by
  ``max_steps / 250000``.
  """
  r = max_steps / 250000 if scale_schedules else 1.0

  def s(steps: int) -> int:
    return max(int(round(steps * r)), 1)

  return TrainConfig(
      batch_size=batch_size,
      max_steps=max_steps,
      lr_schedule=('exponential', 1e-3, 1e-5, max_steps),
      nerf_alpha_schedule=('constant', 8),
      warp_alpha_schedule=('linear', 0, 4, s(50000)),
      hyper_alpha_schedule=('constant', 1),
      hyper_sheet_alpha_schedule=('constant', 6),
      use_warp_reg_loss=True,
      warp_reg_loss_weight=0.001,
      norm_loss_weight_schedule=('constant', 0.001),
      norm_input_alpha_schedule=(
          'piecewise', (
              (s(10000), ('constant', 0.0)),
              (0, ('linear', 0.0, 4.0, s(2000))),
          )),
      use_back_facing_reg=True,
      back_facing_reg_weight=0.1,
      predicted_mask_loss_weight=0.1,
      mask_ratio_schedule=('constant', 1.0),
      sharp_mask_std_schedule=(
          'piecewise', (
              (s(30000), ('exponential', 1.0, 0.1, s(30000))),
              (s(220000), ('constant', 0.1)),
          )),
      x_for_rgb_alpha_schedule=(
          'piecewise', (
              (s(50000), ('constant', 0.0)),
              (s(50000), ('linear', 0.0, 4.0, s(50000))),
              (s(150000), ('constant', 4.0)),
          )),
  )


def nerf_ds_pod(num_chips: int = 16,
                per_chip_batch: int = 512,
                max_steps: Optional[int] = None) -> Tuple[ModelConfig,
                                                          TrainConfig]:
  """Large-batch preset: global batch = num_chips x per_chip_batch, lr
  scaled by ``min(batch/512, 4)`` with a 5%-of-steps linear warmup, and
  steps shrunk by batch/512 so the total ray budget matches 250k x 512."""
  batch = num_chips * per_chip_batch
  k = batch / 512
  f = min(k, 4.0)
  if max_steps is None:
    max_steps = max(int(round(250000 / k)), 1)
  lr0, lr1 = 1e-3 * f, 1e-5 * f
  warmup = max(max_steps // 20, 1)
  base = nerf_ds_train_config(max_steps=max_steps, batch_size=batch,
                              scale_schedules=True)
  train_cfg = dataclasses.replace(
      base,
      lr_schedule=('piecewise', (
          (warmup, ('linear', lr0 / 10.0, lr0, warmup)),
          (max_steps - warmup,
           ('exponential', lr0, lr1, max_steps - warmup)),
      )))
  return nerf_ds(), train_cfg


def to_json(cfg) -> str:
  return json.dumps(dataclasses.asdict(cfg), indent=2, default=str)


def model_config_from_dict(d: Dict[str, Any]) -> ModelConfig:
  d = dict(d)
  for key in ('nerf_skips', 'se3_skips', 'hyper_sheet_skips', 'mask_skips',
              'bf16_zones', 'storage_zones'):
    if key in d and d[key] is not None:
      d[key] = tuple(d[key])
  return ModelConfig(**d)
