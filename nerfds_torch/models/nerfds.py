"""The NeRF-DS model (L3), counterpart of ``nerfds_tpu/models/nerfds.py``.

Coarse and fine levels of a dynamic NeRF: a predicted 3D mask on the
observation points conditions a warp field and the hyper coordinates, whose
outputs feed the NeRF trunk; its head predicts σ and a surface normal, and
the per-point ∇σ (``compute_sigma_gradient``) gives the normal target.

The port covers the flag set of ``config.nerf_ds()`` and the deformation
family of ``config.hypernerf()``: the SE(3), dual-quaternion and
translation warp fields (``warp_field_type``), bendy-sheet and
axis-aligned-plane hyper slicing (``hyper_slice_method``), the warp's
Jacobian for the elastic loss (``return_warp_jacobian``) and the warp of
background points (:meth:`NerfDSModel.apply_warp`). It covers the radiance
branch's variants too: ∇σ as the colour's normal (``use_sigma_gradient``),
the reflected view direction (``use_ref_radiance``), the screw axis
(``screw_input_mode``), the hyper-c sheet (``use_hyper_c``), the window,
Δx, hyper and mask rgb conditions, the mask flags, every
``norm_supervision_type`` and a ``hyper_point`` override in the metadata.
∇σ comes five ways, which give the same numbers:

* ``sigma_gradient_mode='vmap'`` and ``'vjp'``: autograd of Σσ with respect
  to the points, the ones-cotangent pullback (σᵢ depends only on pointᵢ, so
  this is the per-point gradient); ``'naive'`` is ``'vmap'`` that also
  evaluates the warp field afresh for every later use of the motion, as the
  JAX package's op-count baseline does;
* ``'jvp'``: three basis tangents pushed forward through the σ function
  (``torch.autograd.forward_ad`` dual tensors); the training backward then
  runs reverse over forward;
* ``'fused'``: the hand-written trunk kernel (``kernels/fused_trunk.py``)
  returns σ, the heads and g = ∂σ/∂feat in one launch, and autograd pulls g
  back through the warp / hyper / posenc feature path.

All differentiate with respect to ``p = pts.detach()``, never ``pts``
itself: the mask MLP also reads ``pts`` and its output is part of the warp
and hyper embeddings, which the JAX package holds fixed when it takes the
per-point gradient. The 'canonical' normal target is ∇σ of the template
MLP alone at the warped points, by plain autograd in every mode.

The speed and precision modes of the JAX package run too:

* ``compute_dtype='bfloat16'`` with ``bf16_zones`` and ``storage_dtype``
  with ``storage_zones`` (:meth:`NerfDSModel.cdtype_for` and
  :meth:`NerfDSModel.sdtype_for` give each of the zones 'mask', 'warp',
  'hyper', 'trunk' and 'rgb' its dtype, passed to its MLPs as JAX does);
* ``norm_grad_topk`` (the ``nerf_ds_fast`` preset): in ``'vmap'`` mode the
  σ pass runs without ∇σ, and ∇σ is taken at the k samples of each ray
  with the highest (detached) weights only; ``target_norm`` is then
  ``[R, k, 3]`` beside ``norm_topk_idx`` ``[R, k]``. Where the mode cannot
  act (``'fused'``, for one) the model warns and runs the exact path.

K1's operand dtype in ``'fused'`` mode follows the trunk zone: bf16
operands (f32 accumulation) when ``cdtype_for('trunk')`` is bf16, f32
otherwise. This agrees with JAX wherever the port reads the config (JAX
with ``compute_dtype='bfloat16'`` on an accelerator runs K1 in bf16). The
port never reads ``matmul_precision``: where JAX picks bf16 for K1 through
``matmul_precision=None`` alone, the port stays f32 (ROADMAP.md, the
stated precision deviation).

Every other flag of ``ModelConfig`` runs as well: the ``vanilla_nerf``
preset, ``concat_dense_inputs`` (every MLP materialises its concatenated
inputs), the appearance embedding (``use_nerf_embed``, an alpha and an rgb
condition), ``norm_type`` (the NeRF MLP's hidden norm), ``remat_sigma`` and
``remat_feat`` (``models/remat.py``) and the bone warp field
(``use_bone``, ``models/bones.py``).

Where the JAX package itself takes 'vmap' for 'fused' (a non-relu
activation, an alpha condition), so does the port, and it also does so
under ``norm_type``: the trunk kernel has no norm (JAX's 'fused' drops the
norm; ROADMAP.md, queue 3). Under ``norm_type='batch'``, 'vmap' and 'naive'
give each point its own batch of one, as JAX's per-point
``vmap(value_and_grad)`` does (``mlp.apply_norm``).

Two deliberate differences: with ``use_sigma_gradient`` the colour itself
reads ∇σ, so ∇σ is taken even where the caller passes
``compute_sigma_gradient=False`` (the eval renderer); the JAX package then
has no normal for the colour and fails. And where ∇σ is taken,
``remat_sigma`` recomputes σ together with its ∇σ ('jvp': the whole
three-tangent push, whose tangents ``torch.utils.checkpoint`` cannot
recompute alone); the numbers are those without remat.

Under a profiler each level is a ``tracing`` span (``nerfds.model.coarse``,
``.fine``) holding the spans of its parts: ``nerfds.model.sample``,
``.mask``, ``.warp``, ``.hyper``, ``.trunk`` (the posencs of the canonical
point, the trunk and its heads), ``.rgb`` (the radiance branch and its
conditions) and ``.composite`` (compositing, depth and normal maps). A
part that one call does with another is named after the larger: ∇σ's pull
back through the fields in 'fused' mode is ``.warp``, and ∇σ through the
trunk and the fields in the autograd modes is ``.trunk``.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import torch
import torch.autograd.forward_ad as fwAD
from torch import nn

from nerfds_torch import tracing
from nerfds_torch.config import ModelConfig
from nerfds_torch.device import resolve_device
from nerfds_torch.kernels import fused_trunk
from nerfds_torch.models.bones import BoneSE3Field
from nerfds_torch.models.embeddings import GLOEmbed
from nerfds_torch.models.hyper import HyperSheetMLP, MaskMLP
from nerfds_torch.models.mlp import NerfMLP, get_activation
from nerfds_torch.models.remat import REMAT_POLICIES, remat
from nerfds_torch.models.warp import (DualQuaternionField, SE3Field,
                                      TranslationField)
from nerfds_torch.ops import dual_quaternion as dq_lib
from nerfds_torch.ops import math as math_ops
from nerfds_torch.ops import rendering, rigid, sampling

Tensors = Dict[str, torch.Tensor]


SIGMA_GRADIENT_MODES = ('vmap', 'fused', 'jvp', 'vjp', 'naive')
NORM_SUPERVISION_TYPES = ('warped', 'canonical', 'direct',
                          'canonical_unwarped')
NORM_TYPES = (None, 'none', 'layer', 'group', 'batch')


def default_extra_params(cfg: ModelConfig) -> Dict[str, float]:
  """Annealing scalars at their fully annealed values (for eval and tests)."""
  return {
      'nerf_alpha': float(cfg.spatial_point_max_deg),
      'warp_alpha': float(cfg.warp_max_deg),
      'hyper_alpha': float(cfg.hyper_point_max_deg),
      'hyper_sheet_alpha': float(cfg.hyper_sheet_max_deg),
      'norm_input_alpha': float(cfg.norm_input_max_deg),
      'norm_loss_weight': 0.001,
  }


def topk_indices(weights: torch.Tensor, k: int) -> torch.Tensor:
  """[R, k] indices of the k largest of each row of ``weights`` [R, S],
  largest first, the lower index first among equal values (the order of
  ``jax.lax.top_k``; ``torch.topk`` promises none). Zero weights are common
  (empty space), so ties decide which samples get ∇σ."""
  return torch.sort(weights, dim=-1, descending=True,
                    stable=True).indices[:, :k]


def _detach(x):
  if isinstance(x, (rigid.Screw, dq_lib.DualQuatMotion)):
    return type(x)(*(t.detach() for t in x))
  return x.detach() if isinstance(x, torch.Tensor) else x


def _warp_field(cfg: ModelConfig, metadata_dim: int, generator):
  """The field ``warp_field_type`` names, at the config's widths."""
  common = dict(min_deg=cfg.warp_min_deg, max_deg=cfg.warp_max_deg,
                generator=generator, concat_input=cfg.concat_dense_inputs)
  rigid_kw = dict(trunk_depth=cfg.se3_trunk_depth,
                  trunk_width=cfg.se3_trunk_width, skips=cfg.se3_skips,
                  activation=cfg.activation, **common)
  if cfg.warp_field_type == 'se3':
    return SE3Field(metadata_dim, **rigid_kw)
  if cfg.warp_field_type == 'dual_quaternion':
    return DualQuaternionField(metadata_dim, **rigid_kw)
  if cfg.warp_field_type == 'translation':
    # The JAX package builds it at the field's own default widths.
    return TranslationField(metadata_dim, **common)
  raise ValueError(f'Unknown warp field type {cfg.warp_field_type!r}')


class NerfDSModel(nn.Module):
  """The model and its parameters, on ``device`` (``cuda`` unless the
  caller passes another device). Parameter names follow the JAX param tree:
  ``nerf.fine.trunk.hidden_0.kernel`` is ``nerf/fine/trunk/hidden_0/kernel``.
  ``generator`` seeds the initialisation (default: seed 0)."""

  def __init__(self, config: ModelConfig, num_warp_embeds: int = 1,
               num_hyper_embeds: int = 1, num_nerf_embeds: int = 1,
               near: float = 0.2, far: float = 2.0, *,
               generator: Optional[torch.Generator] = None, device=None):
    super().__init__()
    if config.sigma_gradient_mode not in SIGMA_GRADIENT_MODES:
      raise ValueError(f'sigma_gradient_mode={config.sigma_gradient_mode!r}'
                       f'; expected one of {SIGMA_GRADIENT_MODES}')
    if config.norm_supervision_type not in NORM_SUPERVISION_TYPES:
      raise NotImplementedError(config.norm_supervision_type)
    if config.norm_type not in NORM_TYPES:
      raise ValueError(f'Unknown norm type {config.norm_type!r}')
    if config.remat_sigma and config.remat_policy not in REMAT_POLICIES:
      raise ValueError(f'remat_policy={config.remat_policy!r} is not '
                       f'supported; expected one of {sorted(REMAT_POLICIES)}')
    if config.use_ref_radiance and not (config.use_sigma_gradient
                                        or config.use_predicted_norm):
      raise ValueError('use_ref_radiance reflects the view direction about '
                       'the normal input: it needs use_sigma_gradient or '
                       'use_predicted_norm')
    device = resolve_device(device)
    if config.norm_grad_topk and not config.norm_grad_topk_active:
      logging.getLogger(__name__).warning(
          'norm_grad_topk=%d is configured but INACTIVE for this config '
          '(requires predict_norm without use_sigma_gradient, '
          "norm_supervision_type in ('warped','direct') and "
          "sigma_gradient_mode in ('vmap','naive'); got "
          'predict_norm=%s use_sigma_gradient=%s norm_supervision_type=%r '
          'sigma_gradient_mode=%r) — the exact full-sample path will run.',
          config.norm_grad_topk, config.predict_norm,
          config.use_sigma_gradient, config.norm_supervision_type,
          config.sigma_gradient_mode)
    self.config = config
    self.num_warp_embeds = num_warp_embeds
    self.num_hyper_embeds = num_hyper_embeds
    self.num_nerf_embeds = num_nerf_embeds
    self.near, self.far = near, far
    gen = generator
    if gen is None:
      gen = torch.Generator().manual_seed(0)
    cfg = config
    concat = cfg.concat_dense_inputs
    if cfg.use_warp:
      self.warp_embed = GLOEmbed(num_warp_embeds, cfg.warp_embed_dims,
                                 generator=gen)
      if cfg.use_bone:
        self.bone_warp_field = BoneSE3Field(
            self.warp_metadata_dim, num_bones=cfg.num_bones,
            trunk_depth=cfg.bone_trunk_depth,
            trunk_width=cfg.bone_trunk_width,
            moving_mlp_depth=cfg.bone_moving_mlp_depth,
            moving_mlp_width=cfg.bone_moving_mlp_width, generator=gen)
      else:
        self.warp_field = _warp_field(cfg, self.warp_metadata_dim, gen)
    if self.use_hyper_embed:
      self.hyper_embed = GLOEmbed(num_hyper_embeds, cfg.hyper_embed_dims,
                                  generator=gen)
    if cfg.hyper_slice_method == 'bendy_sheet':
      self.hyper_sheet = HyperSheetMLP(
          self.hyper_metadata_dim, output_channels=cfg.hyper_num_dims,
          min_deg=cfg.hyper_sheet_min_deg, max_deg=cfg.hyper_sheet_max_deg,
          depth=cfg.hyper_sheet_depth, width=cfg.hyper_sheet_width,
          skips=cfg.hyper_sheet_skips, generator=gen, concat_input=concat)
    if cfg.use_nerf_embed:
      self.nerf_embed = GLOEmbed(num_nerf_embeds, cfg.nerf_embed_dims,
                                 generator=gen)
    if cfg.use_predicted_mask:
      self.mask_embed = GLOEmbed(num_warp_embeds, cfg.mask_embed_dims,
                                 generator=gen)
      self.mask_mlp = MaskMLP(
          self.mask_metadata_dim, min_deg=cfg.mask_min_deg,
          max_deg=cfg.mask_max_deg, depth=cfg.mask_mlp_depth,
          width=cfg.mask_mlp_width, skips=cfg.mask_skips,
          output_activation=cfg.mask_output_activation, generator=gen,
          concat_input=concat)
    if cfg.use_hyper_c:
      self.hyper_c_embed = GLOEmbed(num_hyper_embeds, cfg.hyper_c_embed_dims,
                                    generator=gen)
      # The sheet posencs the whole points ⊕ viewdirs [⊕ normal]
      # [⊕ reflection] vector.
      self.hyper_c_mlp = HyperSheetMLP(
          cfg.hyper_c_embed_dims if cfg.use_hyper_c_embed else 0,
          output_channels=cfg.hyper_c_num_dims,
          min_deg=cfg.hyper_sheet_min_deg, max_deg=cfg.hyper_sheet_max_deg,
          depth=cfg.hyper_sheet_depth, width=cfg.hyper_sheet_width,
          skips=cfg.hyper_sheet_skips, point_dim=self.hyper_c_input_dim,
          generator=gen, concat_input=concat)
    rgb_total = (self.rgb_condition_dim + self.extra_rgb_condition_dim
                 + self.screw_condition_dim + self.norm_input_dim)
    self.nerf = nn.ModuleDict({
        level: NerfMLP(
            self.nerf_in_dim, self.alpha_condition_dim, rgb_total,
            self.has_condition,
            trunk_depth=cfg.nerf_trunk_depth,
            trunk_width=cfg.nerf_trunk_width,
            rgb_branch_depth=cfg.nerf_rgb_branch_depth,
            rgb_branch_width=cfg.nerf_rgb_branch_width,
            activation=cfg.activation, skips=cfg.nerf_skips,
            predict_norm=cfg.predict_norm, generator=gen,
            hidden_norm=cfg.norm_type, concat_input=concat)
        for level in self.levels})
    self.to(device)

  @property
  def device(self) -> torch.device:
    return self.nerf['coarse'].trunk.hidden_0.kernel.device

  # -- precision zones ------------------------------------------------------

  def cdtype_for(self, zone: str) -> Optional[torch.dtype]:
    """The compute dtype of a zone ('warp', 'hyper', 'mask', 'trunk',
    'rgb'): bf16 under ``compute_dtype='bfloat16'`` where ``bf16_zones``
    is None or names the zone, else None (float32)."""
    if self.config.compute_dtype != 'bfloat16':
      return None
    zones = self.config.bf16_zones
    return torch.bfloat16 if zones is None or zone in zones else None

  def sdtype_for(self, zone: str) -> Optional[torch.dtype]:
    """The activation storage dtype of a zone (``mlp.quantize_storage``):
    bf16 under ``storage_dtype='bfloat16'`` where ``storage_zones`` is None
    or names the zone and the zone computes in float32, else None."""
    cfg = self.config
    if cfg.storage_dtype is None:
      return None
    if cfg.storage_dtype != 'bfloat16':
      raise ValueError(f'Unsupported storage_dtype {cfg.storage_dtype!r}; '
                       "expected None or 'bfloat16'")
    if self.cdtype_for(zone) is not None:
      return None
    zones = cfg.storage_zones
    return torch.bfloat16 if zones is None or zone in zones else None

  # -- static dimension bookkeeping ----------------------------------------

  @property
  def use_hyper_embed(self) -> bool:
    return self.config.has_hyper and not (
        self.config.hyper_use_warp_embed and self.config.use_warp)

  @property
  def warp_metadata_dim(self) -> int:
    return self.config.warp_embed_dims + int(self.config.use_mask_in_warp)

  @property
  def hyper_metadata_dim(self) -> int:
    return self.config.hyper_embed_dims + int(self.config.use_mask_in_hyper)

  @property
  def mask_metadata_dim(self) -> int:
    cfg = self.config
    return ((cfg.mask_embed_dims if cfg.use_mask_embed else 0)
            + int(cfg.use_coarse_depth_for_mask))

  @property
  def nerf_in_dim(self) -> int:
    cfg = self.config
    d = math_ops.posenc_dim(3, cfg.spatial_point_min_deg,
                            cfg.spatial_point_max_deg, cfg.use_posenc_identity)
    if cfg.has_hyper and cfg.use_hyper_for_sigma:
      d += math_ops.posenc_dim(cfg.hyper_num_dims, cfg.hyper_point_min_deg,
                               cfg.hyper_point_max_deg, False)
    return d

  @property
  def has_norm_input(self) -> bool:
    return self.config.use_sigma_gradient or self.config.use_predicted_norm

  @property
  def norm_input_dim(self) -> int:
    cfg = self.config
    if not self.has_norm_input or cfg.use_hyper_c:
      return 0  # hyper-c replaces the normal features in the rgb branch
    if cfg.norm_input_posenc:
      return math_ops.posenc_dim(3, cfg.norm_input_min_deg,
                                 cfg.norm_input_max_deg,
                                 cfg.use_posenc_identity)
    return 3

  @property
  def has_norm_type(self) -> bool:
    return self.config.norm_type not in (None, 'none')

  @property
  def alpha_condition_dim(self) -> int:
    cfg = self.config
    return (cfg.nerf_embed_dims
            if cfg.use_nerf_embed and cfg.use_alpha_condition else 0)

  @property
  def rgb_condition_dim(self) -> int:
    """Channels of the rgb condition: the view directions (with hyper-c
    they feed the hyper-c sheet instead) ⊕ the appearance embedding."""
    cfg = self.config
    d = 0
    if cfg.use_viewdirs and not cfg.use_hyper_c:
      d += math_ops.posenc_dim(3, cfg.viewdir_min_deg, cfg.viewdir_max_deg,
                               cfg.use_posenc_identity)
    if cfg.use_nerf_embed and cfg.use_rgb_condition:
      d += cfg.nerf_embed_dims
    return d

  @property
  def screw_condition_dim(self) -> int:
    mode = self.config.screw_input_mode
    if mode in (None, 'none', 'None') or self.config.use_hyper_c:
      return 0
    return {'rotation': 3, 'full': 6}[mode]

  @property
  def hyper_c_input_dim(self) -> int:
    """points ⊕ viewdirs [⊕ normal] [⊕ reflection]."""
    return (6 + 3 * int(self.has_norm_input)
            + 3 * int(self.config.use_ref_radiance))

  @property
  def extra_rgb_condition_dim(self) -> int:
    cfg = self.config
    d = 0
    if cfg.use_hyper_c:
      d += math_ops.posenc_dim(cfg.hyper_c_num_dims, cfg.hyper_point_min_deg,
                               cfg.hyper_point_max_deg, False)
    if cfg.use_x_in_rgb_condition:
      if cfg.window_x_in_rgb_condition:
        d += math_ops.posenc_dim(3, cfg.x_for_rgb_min_deg,
                                 cfg.x_for_rgb_max_deg, False)
      else:
        # "x" in the rgb condition is the trunk output re-fed to the rgb
        # branch.
        d += cfg.nerf_trunk_width
    if cfg.use_delta_x_in_rgb_condition:
      d += 3
    if cfg.use_hyper_for_rgb:
      d += cfg.hyper_num_dims
    if cfg.use_ref_radiance:
      d += math_ops.posenc_dim(3, cfg.norm_input_min_deg,
                               cfg.norm_input_max_deg, cfg.use_posenc_identity)
    if cfg.use_mask_in_rgb:
      d += 1
    return d

  @property
  def has_condition(self) -> bool:
    """Whether the NerfMLP has a bottleneck: viewdirs count only where they
    are fed to the rgb branch, which ``use_hyper_c`` supplants; the
    appearance embedding counts where it conditions α or rgb."""
    cfg = self.config
    return ((cfg.use_viewdirs and not cfg.use_hyper_c)
            or (cfg.use_nerf_embed
                and (cfg.use_alpha_condition or cfg.use_rgb_condition)))

  @property
  def levels(self):
    return ['coarse', 'fine'] if self.config.num_fine_samples > 0 else [
        'coarse']

  # -- embeddings -----------------------------------------------------------

  def encode_warp_embed(self, metadata):
    return self.warp_embed.encode(metadata[self.config.warp_embed_key])

  def encode_hyper_embed(self, metadata):
    if self.config.hyper_use_warp_embed and self.config.use_warp:
      return self.encode_warp_embed(metadata)
    return self.hyper_embed.encode(metadata[self.config.hyper_embed_key])

  def encode_mask_embed(self, metadata):
    return self.mask_embed.encode(metadata[self.config.warp_embed_key])

  def encode_hyper_c_embed(self, metadata):
    return self.hyper_c_embed.encode(metadata[self.config.hyper_embed_key])

  def encode_nerf_embed(self, metadata):
    return self.nerf_embed.encode(metadata[self.config.nerf_embed_key])

  def encode_metadata(self, metadata) -> Tensors:
    """Pre-encodes the GLO embeddings, so chunked rendering skips lookups."""
    encoded = {}
    if self.config.use_nerf_embed:
      encoded['encoded_nerf'] = self.encode_nerf_embed(metadata)
    if self.config.use_warp:
      encoded['encoded_warp'] = self.encode_warp_embed(metadata)
    if self.config.has_hyper:
      encoded['encoded_hyper'] = self.encode_hyper_embed(metadata)
    if self.config.use_predicted_mask:
      encoded['encoded_mask'] = self.encode_mask_embed(metadata)
    if self.config.use_hyper_c:
      encoded['encoded_hyper_c'] = self.encode_hyper_c_embed(metadata)
    return encoded

  # -- the σ path -----------------------------------------------------------

  def make_feat_fn(self, warp_in_embed, hyper_in_embed, hyper_embed,
                   extra_params, *, use_warp=True, hyper_override=None,
                   remat_feat=None):
    """p -> (trunk feature blocks, aux): the warp field, the hyper
    coordinates and the posencs, the part of the σ path before the NeRF
    trunk. The rigid fields give a motion (``aux['screw']``) that the
    normal transport reuses; the translation and bone fields give none
    (the bone field gives ``aux['moving_mask']`` and
    ``aux['bone_weights']``). The hyper coordinates are ``hyper_override``
    where given (the metadata's ``hyper_point``), else come from the bendy
    sheet, or in 'axis_aligned_plane' slicing are the hyper embedding
    itself (``hyper_embed``, without the mask channel). ``remat_feat``
    (default: the config's) recomputes the function in the backward."""
    cfg = self.config

    def feat_fn(p):
      screw = moving_mask = bone_weights = None
      warped_spatial = p
      if use_warp:
        with tracing.span('nerfds.model.warp'):
          if cfg.use_bone:
            bone_out = self.bone_warp_field.warp(p, warp_in_embed)
            warped_spatial = bone_out['warped_points']
            moving_mask = bone_out['moving_mask']
            bone_weights = bone_out['bone_weights']
          elif cfg.warp_field_type == 'translation':
            warped_spatial = self.warp_field.warp(
                p, warp_in_embed, extra_params['warp_alpha'],
                self.cdtype_for('warp'), self.sdtype_for('warp'))
          else:
            screw = self.warp_field.motion(
                p, warp_in_embed, extra_params['warp_alpha'],
                self.cdtype_for('warp'), self.sdtype_for('warp'))
            warped_spatial = rigid.transform_point(screw, p)
      hyper = None
      if hyper_override is not None:
        hyper = hyper_override
      elif cfg.hyper_slice_method == 'bendy_sheet':
        with tracing.span('nerfds.model.hyper'):
          hyper = self.hyper_sheet(p, hyper_in_embed,
                                   alpha=extra_params['hyper_sheet_alpha'],
                                   dtype=self.cdtype_for('hyper'),
                                   storage_dtype=self.sdtype_for('hyper'))
      elif cfg.hyper_slice_method == 'axis_aligned_plane':
        hyper = hyper_embed
      # The trunk's input: the canonical point and its posencs.
      with tracing.span('nerfds.model.trunk'):
        if hyper is not None and cfg.use_hyper_for_sigma:
          warped = torch.cat([warped_spatial, hyper], -1)
        else:
          warped = warped_spatial
        feat = [math_ops.posenc(
            warped[..., :3], cfg.spatial_point_min_deg,
            cfg.spatial_point_max_deg, cfg.use_posenc_identity,
            alpha=extra_params['nerf_alpha'])]
        if warped.shape[-1] > 3:
          feat.append(math_ops.posenc(
              warped[..., 3:], cfg.hyper_point_min_deg,
              cfg.hyper_point_max_deg, False,
              alpha=extra_params['hyper_alpha']))
      aux = {'screw': screw, 'warped_spatial': warped_spatial,
             'hyper': hyper, 'warped': warped, 'moving_mask': moving_mask,
             'bone_weights': bone_weights}
      return feat, aux

    if cfg.remat_feat if remat_feat is None else remat_feat:
      return remat(feat_fn, 'nothing', self)
    return feat_fn

  def make_sigma_fn(self, level, warp_in_embed, hyper_in_embed, hyper_embed,
                    extra_params, *, use_warp=True, hyper_override=None,
                    alpha_condition=None, pointwise_norm=False, remat_fn=True):
    """The pointwise-batched density function of ``[N, 3]`` points:
    p -> (σ_raw [N], aux with the trunk output, bottleneck and normal).
    ``pointwise_norm``: a 'batch' hidden norm takes each point's own
    statistics (:func:`mlp.apply_norm`). ``remat_fn=False`` leaves out
    ``remat_sigma`` and ``remat_feat`` (a caller that recomputes a larger
    region)."""
    cfg = self.config
    remat_sigma = cfg.remat_sigma and remat_fn
    feat_fn = self.make_feat_fn(
        warp_in_embed, hyper_in_embed, hyper_embed, extra_params,
        use_warp=use_warp, hyper_override=hyper_override,
        remat_feat=cfg.remat_feat and remat_fn and not remat_sigma)
    nerf = self.nerf[level]

    cdt = self.cdtype_for('trunk')

    def sigma_fn(p):
      feat, aux = feat_fn(p)
      with tracing.span('nerfds.model.trunk'):
        trunk_out, bottleneck = nerf.query_bottleneck(
            feat, dtype=cdt, storage_dtype=self.sdtype_for('trunk'),
            pointwise_norm=pointwise_norm)
        sigma_raw, norm = nerf.query_sigma(trunk_out, bottleneck,
                                           alpha_condition, dtype=cdt)
      aux.update(trunk_out=trunk_out, bottleneck=bottleneck, norm=norm)
      return sigma_raw[..., 0], aux

    if remat_sigma:
      return remat(sigma_fn, cfg.remat_policy, self)
    return sigma_fn

  def trunk_spec(self, in_dim: int) -> fused_trunk.TrunkSpec:
    cfg = self.config
    return fused_trunk.TrunkSpec(
        depth=cfg.nerf_trunk_depth, width=cfg.nerf_trunk_width,
        skips=tuple(cfg.nerf_skips), in_dim=in_dim, alpha_channels=1,
        norm_dim=self.nerf['coarse'].norm_dim if cfg.predict_norm else 0,
        has_bottleneck=self.has_condition)

  def _sigma_and_grad(self, level, pts, warp_in_embed, hyper_in_embed,
                      hyper_embed, extra_params, use_warp, mode=None,
                      hyper_override=None, alpha_condition=None):
    """σ_raw, aux and ∂σ/∂p for every point.

    In the caller's no-grad mode everything comes back detached. With grad
    on, ∇σ keeps its graph (second order), so a loss on it reaches every
    parameter upstream: 'vmap', 'vjp' and 'naive' take autograd of Σσ with
    create_graph; 'jvp' pushes the three basis tangents through the σ
    function as dual tensors, whose tangents keep their graph (reverse over
    forward); 'fused' runs the trunk through ``fused_trunk.TrunkSigmaGrad``
    (forward K1f, backward K1b) on the feature path's output ``feat``
    itself, and pulls g back through the feature path with create_graph, so
    the outer backward reaches Ḡ in K1b and the small MLPs' second-order
    terms. 'fused' takes 'vmap' where the kernel cannot run the trunk: a
    non-relu activation or an alpha condition (as in JAX), or a hidden
    norm.

    The gradient is taken with respect to a separate leaf
    ``p = pts.detach()``, so it reaches neither the mask path nor ``pts``.
    That leaf cuts only ∂/∂origins: no parameter lies upstream of ``pts``,
    since the fine z values are stop-gradiented (``ops/sampling.py``).
    ``mode`` overrides the config's ``sigma_gradient_mode``.
    """
    outer_grad = torch.is_grad_enabled()
    cfg = self.config
    mode = mode or cfg.sigma_gradient_mode
    if mode == 'fused' and (cfg.activation != 'relu'
                            or alpha_condition is not None
                            or self.has_norm_type):
      mode = 'vmap'  # K1 runs a relu trunk without a norm or an α condition
    p = pts.detach().requires_grad_(mode != 'jvp')
    nerf = self.nerf[level]
    fn_kw = dict(use_warp=use_warp, hyper_override=hyper_override,
                 alpha_condition=alpha_condition)
    if mode == 'fused':
      feat_fn = self.make_feat_fn(warp_in_embed, hyper_in_embed,
                                  hyper_embed, extra_params,
                                  use_warp=use_warp,
                                  hyper_override=hyper_override)
      with torch.enable_grad():
        parts, aux = feat_fn(p)
      with tracing.span('nerfds.model.trunk'):
        with torch.enable_grad():
          feat = parts[0] if len(parts) == 1 else torch.cat(parts, -1)
        sigma_2d, norm, trunk_out, bottleneck, g = (
            fused_trunk.trunk_sigma_grad(
                feat, nerf.trunk_weights(), self.trunk_spec(feat.shape[-1]),
                compute_dtype=self.cdtype_for('trunk')))
      # ∇σ's pull back through the posencs, the hyper sheet and the warp
      # field, named after its larger part.
      with tracing.span('nerfds.model.warp'):
        (grad_pts,) = torch.autograd.grad(feat, p, grad_outputs=g,
                                          create_graph=outer_grad)
      aux.update(trunk_out=trunk_out, bottleneck=bottleneck, norm=norm)
      sigma_raw = sigma_2d[..., 0]
    elif mode == 'jvp':
      sigma_fn = self.make_sigma_fn(level, warp_in_embed, hyper_in_embed,
                                    hyper_embed, extra_params,
                                    remat_fn=False, **fn_kw)
      primal = lambda x: (fwAD.unpack_dual(x).primal
                          if isinstance(x, torch.Tensor) else x)

      def push_tangents(p):
        cols = []
        for j in range(3):
          tangent = torch.zeros_like(p)
          tangent[:, j] = 1.0
          with fwAD.dual_level():
            sigma_j, aux_j = sigma_fn(fwAD.make_dual(p, tangent))
            cols.append(fwAD.unpack_dual(sigma_j).tangent)
            if j == 0:
              sigma_raw = primal(sigma_j)
              aux = {k: (type(v)(*map(primal, v))
                         if isinstance(v, (rigid.Screw,
                                           dq_lib.DualQuatMotion))
                         else primal(v)) for k, v in aux_j.items()}
        return sigma_raw, aux, torch.stack(cols, -1)

      if cfg.remat_sigma or cfg.remat_feat:
        # A region's tangents cannot be recomputed alone: recompute the
        # whole push.
        push_tangents = remat(push_tangents, cfg.remat_policy
                              if cfg.remat_sigma else 'nothing', self)
      sigma_raw, aux, grad_pts = push_tangents(p)
    elif mode in ('vmap', 'vjp', 'naive'):
      # JAX's 'vmap' and 'naive' evaluate each point alone: a 'batch' norm
      # there sees one point.
      sigma_fn = self.make_sigma_fn(level, warp_in_embed, hyper_in_embed,
                                    hyper_embed, extra_params,
                                    pointwise_norm=mode != 'vjp',
                                    remat_fn=not cfg.remat_sigma, **fn_kw)

      def sigma_and_grad(p):
        with torch.enable_grad():
          sigma_raw, aux = sigma_fn(p)
          # ∇σ back through the trunk and the fields, named after the trunk.
          with tracing.span('nerfds.model.trunk'):
            (grad_pts,) = torch.autograd.grad(sigma_raw.sum(), p,
                                              create_graph=outer_grad)
        return sigma_raw, aux, grad_pts

      if cfg.remat_sigma:
        # The region is σ with its ∇σ: recomputing σ alone, the ∇σ graph
        # would keep one recomputation while the outer backward made
        # another.
        sigma_and_grad = remat(sigma_and_grad, cfg.remat_policy, self)
      sigma_raw, aux, grad_pts = sigma_and_grad(p)
    else:
      raise ValueError(mode)
    if not outer_grad:
      sigma_raw, grad_pts = sigma_raw.detach(), grad_pts.detach()
      aux = {k: _detach(v) for k, v in aux.items()}
    return sigma_raw, aux, grad_pts

  def _canonical_sigma_grad(self, level, warped, extra_params):
    """∂σ/∂w of the template MLP alone (the posencs of the spatial and
    hyper parts, the trunk and the σ head) at the canonical points
    ``warped`` [N, 3 (+ hyper)]: the 'canonical' normal target. Plain
    autograd, with create_graph under grad mode, so a loss on it reaches
    the template's and (through ``warped``) the warp's parameters. Each
    point is its own batch for a 'batch' norm, as in JAX's per-point
    gradient."""
    cfg = self.config
    nerf = self.nerf[level]
    outer_grad = torch.is_grad_enabled()
    with tracing.span('nerfds.model.trunk'), torch.enable_grad():
      w = (warped if outer_grad and warped.requires_grad
           else warped.detach().requires_grad_())
      feat = [math_ops.posenc(
          w[..., :3], cfg.spatial_point_min_deg, cfg.spatial_point_max_deg,
          cfg.use_posenc_identity, alpha=extra_params['nerf_alpha'])]
      if w.shape[-1] > 3:
        feat.append(math_ops.posenc(
            w[..., 3:], cfg.hyper_point_min_deg, cfg.hyper_point_max_deg,
            False, alpha=extra_params['hyper_alpha']))
      trunk_out = nerf.trunk(feat, dtype=self.cdtype_for('trunk'),
                             storage_dtype=self.sdtype_for('trunk'),
                             pointwise_norm=True)
      sigma_raw, _ = nerf.query_sigma(trunk_out, trunk_out,
                                      dtype=self.cdtype_for('trunk'))
      (grad_w,) = torch.autograd.grad(sigma_raw.sum(), w,
                                      create_graph=outer_grad)
    return grad_w if outer_grad else grad_w.detach()

  # -- the per-level forward ------------------------------------------------

  def render_samples(self, level, points, z_vals, directions, viewdirs,
                     metadata, extra_params, gt_mask, *, generator=None,
                     coarse_depth=None, use_warp=True,
                     metadata_encoded=False, use_sample_at_infinity=True,
                     mask_ratio=1.0, sharp_weights_std=1.0,
                     x_for_rgb_alpha=4.0, return_full=False,
                     compute_sigma_gradient=None,
                     use_norm_grad_topk=True,
                     return_warp_jacobian=False) -> Tensors:
    """One level over ``points`` [R, S, 3]. ``use_norm_grad_topk=False``
    runs the exact ∇σ path even where ``norm_grad_topk`` is active, so that
    ``target_norm`` comes back at every sample (the eval renderer).
    ``return_warp_jacobian`` adds ``warp_jacobian`` [R, S, 3, 3], ∂warp/∂x
    at the samples (the elastic loss's input). ``coarse_depth`` [R]: the
    coarse level's depth, the mask MLP's extra input under
    ``use_coarse_depth_for_mask`` (−1 where None, at the coarse level)."""
    cfg = self.config
    num_rays, num_samples = points.shape[:2]
    n = num_rays * num_samples
    pts = points.reshape(n, 3)
    out: Tensors = {'points': points}

    def broadcast_ray(x):
      """[R, C] per-ray feature -> [R*S, C] per-sample feature."""
      return x[:, None, :].expand(num_rays, num_samples,
                                  x.shape[-1]).reshape(n, x.shape[-1])

    use_warp = cfg.use_warp and use_warp

    warp_embed = None
    if use_warp:
      with tracing.span('nerfds.model.warp'):
        warp_embed = broadcast_ray(
            metadata['encoded_warp'] if metadata_encoded
            else self.encode_warp_embed(metadata))
    hyper_embed = None
    if cfg.has_hyper:
      with tracing.span('nerfds.model.hyper'):
        if metadata_encoded:
          hyper_embed = broadcast_ray(metadata['encoded_hyper'])
        elif cfg.hyper_use_warp_embed and warp_embed is not None:
          hyper_embed = warp_embed
        else:
          hyper_embed = broadcast_ray(self.encode_hyper_embed(metadata))
    alpha_condition = None
    rgb_condition = []
    with tracing.span('nerfds.model.rgb'):
      if cfg.use_viewdirs and not cfg.use_hyper_c:
        rgb_condition.append(broadcast_ray(math_ops.posenc(
            viewdirs, cfg.viewdir_min_deg, cfg.viewdir_max_deg,
            cfg.use_posenc_identity)))
      if cfg.use_nerf_embed:
        nerf_embed = broadcast_ray(
            metadata['encoded_nerf'] if metadata_encoded
            else self.encode_nerf_embed(metadata))
        if cfg.use_alpha_condition:
          alpha_condition = nerf_embed
        if cfg.use_rgb_condition:
          rgb_condition.append(nerf_embed)
    rgb_condition = rgb_condition or None

    gt_mask_b = broadcast_ray(gt_mask) if gt_mask is not None else None

    # Predicted 3D mask field on the observation-space points.
    predicted_mask = None
    mask = gt_mask_b
    if cfg.use_predicted_mask:
      with tracing.span('nerfds.model.mask'):
        if metadata_encoded and 'encoded_mask' in metadata:
          mask_embed = broadcast_ray(metadata['encoded_mask'])
        else:
          mask_embed = broadcast_ray(self.encode_mask_embed(metadata))
        if cfg.use_coarse_depth_for_mask:
          depth_feat = (broadcast_ray(coarse_depth[:, None])
                        if coarse_depth is not None
                        else pts.new_full((n, 1), -1.0))
          mask_embed = torch.cat([depth_feat, mask_embed], -1)
        predicted_mask = self.mask_mlp(pts, mask_embed,
                                       alpha=extra_params['warp_alpha'],
                                       use_embed=cfg.use_mask_embed,
                                       dtype=self.cdtype_for('mask'),
                                       storage_dtype=self.sdtype_for('mask'))
        out['predicted_mask'] = predicted_mask.reshape(num_rays, num_samples,
                                                       1)
        if cfg.clamp_predicted_mask:
          threshold = cfg.predicted_mask_clamp_threshold
          predicted_mask = (torch.clamp(predicted_mask, max=threshold)
                            / threshold)
        mask = predicted_mask * mask_ratio + gt_mask_b * (1.0 - mask_ratio)

    # Mask-conditioned metadata for the warp and the hyper sheet.
    warp_in_embed = warp_embed
    if use_warp and cfg.use_mask_in_warp:
      warp_in_embed = torch.cat([warp_embed, mask], -1)
    hyper_in_embed = hyper_embed
    if cfg.has_hyper and cfg.use_mask_in_hyper:
      hyper_in_embed = torch.cat([hyper_embed, mask], -1)

    hyper_override = metadata.get('hyper_point') if metadata else None
    if hyper_override is not None:
      hyper_override = broadcast_ray(hyper_override)

    if compute_sigma_gradient is None:
      compute_sigma_gradient = cfg.needs_sigma_gradient
    # With use_sigma_gradient the colour reads ∇σ: take it regardless.
    compute_sigma_gradient = compute_sigma_gradient or cfg.use_sigma_gradient
    # norm_grad_topk: ∇σ is only the normal loss's target here, so the σ
    # pass below runs without it, and it is taken after compositing at the
    # k highest-weight samples of each ray.
    topk_k = None
    if (compute_sigma_gradient and use_norm_grad_topk
        and cfg.norm_grad_topk_active):
      topk_k = min(int(cfg.norm_grad_topk), num_samples)
      compute_sigma_gradient = False
    if compute_sigma_gradient:
      sigma_raw, aux, grad_pts = self._sigma_and_grad(
          level, pts, warp_in_embed, hyper_in_embed, hyper_embed,
          extra_params, use_warp, hyper_override=hyper_override,
          alpha_condition=alpha_condition)
      if cfg.stop_target_norm_gradient:
        grad_pts = grad_pts.detach()
      sigma_gradient = math_ops.normalize(-grad_pts)
    else:
      sigma_raw, aux = self.make_sigma_fn(
          level, warp_in_embed, hyper_in_embed, hyper_embed, extra_params,
          use_warp=use_warp, hyper_override=hyper_override,
          alpha_condition=alpha_condition)(pts)
      sigma_gradient = None
    screw = aux['screw']
    norm = aux['norm']

    # 'canonical' supervision: ∇σ of the template MLP alone, with respect
    # to the canonical (warped ⊕ hyper) coordinates.
    sigma_gradient_w = None
    if (cfg.predict_norm and compute_sigma_gradient
        and cfg.norm_supervision_type == 'canonical'):
      grad_w = self._canonical_sigma_grad(level, aux['warped'], extra_params)
      sigma_gradient_w = math_ops.normalize(-grad_w[..., :3])

    def fresh_screw():
      """The motion for a later use: in 'naive' mode the warp field
      evaluated afresh (the JAX package's op-count baseline), else the σ
      path's."""
      if (cfg.sigma_gradient_mode == 'naive' and use_warp
          and screw is not None):
        return self.warp_field.motion(pts, warp_in_embed,
                                      extra_params['warp_alpha'],
                                      self.cdtype_for('warp'))
      return screw

    if return_warp_jacobian and use_warp:
      if cfg.use_bone:
        raise ValueError('the bone field has no warp Jacobian (nor has it '
                         'in the JAX package): the elastic loss needs a '
                         "warp_field_type field, use_bone=False")
      with tracing.span('nerfds.model.warp'):
        warp_jac = self.warp_field.warp_jacobian(pts, warp_in_embed,
                                                 extra_params['warp_alpha'])
      out['warp_jacobian'] = warp_jac.reshape(num_rays, num_samples, 3, 3)

    with tracing.span('nerfds.model.rgb'):
      # Normal input of the radiance branch: ∇σ itself, or the predicted
      # normal, rotated back to the observation frame by the inverse of the
      # same screw where it is supervised in the canonical frame.
      norm_input = None
      if cfg.use_sigma_gradient:
        norm_input = sigma_gradient
      elif cfg.use_predicted_norm:
        if cfg.norm_supervision_type in ('warped', 'canonical'):
          norm_input = math_ops.normalize(norm)
          if screw is not None:
            norm_input = rigid.rotate_inverse(fresh_screw(), norm_input)
        else:  # 'direct', 'canonical_unwarped'
          norm_input = norm
      norm_input_feat = None
      if norm_input is not None:
        if cfg.stop_norm_gradient:
          norm_input = norm_input.detach()
        norm_input = math_ops.normalize(norm_input)
        if return_full:
          out['norm_input'] = norm_input.reshape(num_rays, num_samples, 3)
        norm_input_feat = (math_ops.posenc(
            norm_input, cfg.norm_input_min_deg, cfg.norm_input_max_deg,
            cfg.use_posenc_identity, alpha=extra_params['norm_input_alpha'])
            if cfg.norm_input_posenc else norm_input)

      ref_radiance = ref_radiance_feat = None
      if cfg.use_ref_radiance:
        ref_radiance = math_ops.reflect(broadcast_ray(viewdirs), norm_input)
        ref_radiance_feat = math_ops.posenc(
            ref_radiance, cfg.norm_input_min_deg, cfg.norm_input_max_deg,
            cfg.use_posenc_identity, alpha=extra_params['norm_input_alpha'])

      # Extra rgb conditions, in the JAX package's order.
      extra_rgb_parts = []
      screw_condition = None
      if (cfg.screw_input_mode not in (None, 'none', 'None')
          and not cfg.use_hyper_c and screw is not None):
        axis6 = screw.axis
        screw_condition = (axis6[:, :3]
                           if cfg.screw_input_mode == 'rotation' else axis6)
      if cfg.use_hyper_c:
        # Ambient colour coordinates: a sheet MLP over the (stop-gradiented)
        # points ⊕ viewdirs [⊕ normal] [⊕ reflection], in place of the view
        # direction and normal conditions.
        with tracing.span('nerfds.model.hyper'):
          points_input = (aux['warped'] if cfg.hyper_c_hyper_input
                          else pts).detach()
          hc_in = [points_input[..., :3], broadcast_ray(viewdirs)]
          if norm_input is not None:
            hc_in.append(norm_input)
          if ref_radiance is not None:
            hc_in.append(ref_radiance)
          hyper_c_embed = None
          if cfg.use_hyper_c_embed:
            hyper_c_embed = broadcast_ray(
                metadata['encoded_hyper_c']
                if metadata_encoded and 'encoded_hyper_c' in metadata
                else self.encode_hyper_c_embed(metadata))
          hyper_c = self.hyper_c_mlp(torch.cat(hc_in, -1), hyper_c_embed,
                                     dtype=self.cdtype_for('hyper'))
          extra_rgb_parts.append(math_ops.posenc(
              hyper_c, cfg.hyper_point_min_deg, cfg.hyper_point_max_deg, False,
              alpha=extra_params['hyper_alpha']))
          out['hyper_c'] = hyper_c.reshape(num_rays, num_samples, -1)
        norm_input_feat = None
      if cfg.use_x_in_rgb_condition:
        extra_rgb_parts.append(
            math_ops.posenc(pts, cfg.x_for_rgb_min_deg, cfg.x_for_rgb_max_deg,
                            alpha=x_for_rgb_alpha)
            if cfg.window_x_in_rgb_condition else aux['trunk_out'])
      if cfg.use_delta_x_in_rgb_condition:
        extra_rgb_parts.append((aux['warped_spatial'] - pts).detach())
      if cfg.use_hyper_for_rgb:
        extra_rgb_parts.append(aux['hyper'])
      if ref_radiance_feat is not None:
        extra_rgb_parts.append(ref_radiance_feat)

      # Mask-derived compositing weights (for the 3D mask loss and the mask
      # rgb condition).
      sigma_act = get_activation(cfg.sigma_activation)
      mask_weights = rendering.cal_weights(
          sigma_act(sigma_raw.reshape(num_rays, num_samples)), z_vals,
          directions, scale=5.0 if cfg.use_mask_scaled_weights else 1.0
      ).detach()
      sharp_weights = None
      if cfg.use_mask_sharp_weights:
        sharp_weights = rendering.sharpen_weights(
            mask_weights, z_vals, std=sharp_weights_std)
        out['sharp_weights'] = sharp_weights
      if cfg.use_mask_in_rgb:
        w = (sharp_weights if cfg.use_mask_sharp_weights
             else mask_weights).reshape(n, 1)
        mask_3d = w * gt_mask_b
        if cfg.use_predicted_mask:
          predicted_mask_3d = (predicted_mask if cfg.use_3d_mask
                               else w * predicted_mask)
          mask_3d = (predicted_mask_3d * mask_ratio
                     + mask_3d * (1.0 - mask_ratio))
        extra_rgb_parts.append(mask_3d)

      rgb_raw = self.nerf[level].query_rgb(
          aux['trunk_out'], aux['bottleneck'], rgb_condition,
          extra_rgb_parts or None, screw_condition, norm_input_feat,
          dtype=self.cdtype_for('rgb'), storage_dtype=self.sdtype_for('rgb'))
      rgb = torch.sigmoid(rgb_raw).reshape(num_rays, num_samples, 3)
    # Compositing, and the depth and normal maps.
    with tracing.span('nerfds.model.composite'):
      sigma = sigma_act(rendering.noise_regularize_sigma(
          sigma_raw.reshape(num_rays, num_samples), cfg.noise_std,
          cfg.use_stratified_sampling, generator))
      out['sigma'] = sigma

      out.update(rendering.volumetric_rendering(
          rgb, sigma, z_vals, directions,
          use_white_background=cfg.use_white_background,
          sample_at_infinity=use_sample_at_infinity,
          use_sharp_weights=cfg.use_rgb_sharp_weights,
          sharp_weights_std=sharp_weights_std,
          use_kernel=cfg.use_pallas_compositing))
      weights = out['weights']

      warped_points = aux['warped'].reshape(num_rays, num_samples, -1)
      out['warped_points'] = warped_points

      if cfg.predict_norm:
        norm_rs = norm.reshape(num_rays, num_samples, 3)
        out['predicted_norm'] = norm_rs
        back_facing = (norm_rs * viewdirs[:, None, :]).sum(-1)
        out['back_facing'] = torch.relu(back_facing) ** 2
      if cfg.predict_norm and sigma_gradient is not None:
        if cfg.norm_supervision_type == 'warped':
          # Canonical-frame target: ∇σ rotated forward by the same screw.
          target = math_ops.normalize(
              rigid.rotate(fresh_screw(), sigma_gradient) if screw is not None
              else sigma_gradient)
        elif cfg.norm_supervision_type == 'canonical':
          target = sigma_gradient_w
        else:  # 'direct', 'canonical_unwarped': ∇σ unrotated
          target = sigma_gradient
        out['target_norm'] = target.reshape(num_rays, num_samples, 3)

      if norm is not None:
        out['ray_norm'] = (weights[..., None]
                           * norm.reshape(num_rays, num_samples, 3)).sum(-2)
      elif sigma_gradient is not None:
        out['ray_norm'] = (weights[..., None] * sigma_gradient.reshape(
            num_rays, num_samples, 3)).sum(-2)
      delta_x = warped_points[..., :3] - points
      out['delta_x'] = delta_x
      out['ray_delta_x'] = (weights[..., None] * delta_x).sum(-2)
      out['ray_hyper_points'] = (weights[..., None]
                                 * warped_points[..., 3:]).sum(-2)
      if cfg.use_hyper_c:
        out['ray_hyper_c'] = (weights[..., None] * out['hyper_c']).sum(-2)
      if cfg.use_predicted_mask:
        pm = out['predicted_mask']
        if cfg.use_mask_scaled_weights:
          out['scaled_weights'] = mask_weights
          out['ray_predicted_mask'] = (mask_weights[..., None] * pm).sum(-2)
        else:
          out['ray_predicted_mask'] = (weights[..., None] * pm).sum(-2)
      if aux['moving_mask'] is not None:
        mm = aux['moving_mask'].reshape(num_rays, num_samples, 1)
        out['moving_mask'] = mm
        out['ray_moving_mask'] = (weights[..., None] * mm).sum(-2)

      depth_indices = rendering.compute_depth_index(weights)
      out['med_points'] = torch.gather(
          warped_points, 1, depth_indices[:, None, None].expand(
              -1, 1, warped_points.shape[-1]))

      if return_full and screw is not None:
        viz_screw = fresh_screw()
        rotation_ref = math_ops.normalize(torch.ones_like(pts))
        rf = math_ops.normalize(rigid.rotate(viz_screw, rotation_ref))
        out['ray_rotation_field'] = (
            weights[..., None] * rf.reshape(num_rays, num_samples, 3)).sum(-2)
        tf = rigid.translation(viz_screw).reshape(num_rays, num_samples, 3)
        out['ray_translation_field'] = (weights[..., None] * tf).sum(-2)

    if topk_k is not None:
      topk_idx = topk_indices(weights.detach(), topk_k)

      def gather_samples(x_flat):
        """Per-sample rows [R*S, C] -> the selected rows [R*k, C]."""
        if x_flat is None:
          return None
        c = x_flat.shape[-1]
        return torch.gather(
            x_flat.reshape(num_rays, num_samples, c), 1,
            topk_idx[..., None].expand(-1, -1, c)).reshape(-1, c)

      _, aux_k, grad_k = self._sigma_and_grad(
          level, gather_samples(pts), gather_samples(warp_in_embed),
          gather_samples(hyper_in_embed), gather_samples(hyper_embed),
          extra_params, use_warp, mode='vmap',
          hyper_override=gather_samples(hyper_override),
          alpha_condition=gather_samples(alpha_condition))
      if cfg.stop_target_norm_gradient:
        grad_k = grad_k.detach()
      target_k = math_ops.normalize(-grad_k)
      if (cfg.norm_supervision_type == 'warped'
          and aux_k['screw'] is not None):
        target_k = math_ops.normalize(rigid.rotate(aux_k['screw'], target_k))
      out['target_norm'] = target_k.reshape(num_rays, topk_k, 3)
      out['norm_topk_idx'] = topk_idx

    return out

  # -- full forward ---------------------------------------------------------

  def forward(self, *args, method: str = 'render', **kwargs):
    """:meth:`render`, or the method ``method`` names (``'apply_warp'``,
    ``'bone_moving_mask'``), so that ``torch.func.functional_call`` can run
    any of them on a parameter dict (``training/step.py``)."""
    return getattr(self, method)(*args, **kwargs)

  def _run(self, fn, *args):
    """``fn(*args)``: the recomputation of a remat region runs through
    ``forward(method='_run')`` under the parameters of its forward
    (``models/remat.py``)."""
    return fn(*args)

  def _background_embed(self, warp_metadata: torch.Tensor) -> torch.Tensor:
    """The warp embedding of background points: the mask channel of the
    warp's metadata is 0 there."""
    warp_embed = self.warp_embed.encode(warp_metadata)
    if self.config.use_mask_in_warp:
      warp_embed = torch.cat([warp_embed, torch.zeros_like(
          warp_embed[..., :1])], -1)
    return warp_embed

  def bone_moving_mask(self, points: torch.Tensor,
                       warp_metadata: torch.Tensor) -> torch.Tensor:
    """The bone field's moving mask ``[P, 1]`` at free-space points
    ``[P, 3]`` (the background loss under ``use_bone``)."""
    return self.bone_warp_field.moving_mask(
        points, self._background_embed(warp_metadata))

  def apply_warp(self, points: torch.Tensor, warp_metadata: torch.Tensor,
                 extra_params) -> torch.Tensor:
    """Warps free-space points (the background loss): ``points`` [P, 3],
    ``warp_metadata`` [P, 1] integer ids."""
    warp_embed = self._background_embed(warp_metadata)
    return self.warp_field.warp(points, warp_embed,
                                extra_params['warp_alpha'],
                                self.cdtype_for('warp'),
                                self.sdtype_for('warp'))

  def render(self, rays: Dict[str, Any], extra_params, *,
             generator: Optional[torch.Generator] = None, use_warp=True,
             metadata_encoded=False, return_points=False,
             return_weights=True, near=None, far=None,
             use_sample_at_infinity=None, mask_ratio=1.0,
             sharp_weights_std=1.0, x_for_rgb_alpha=4.0, return_full=False,
             compute_sigma_gradient=None,
             use_norm_grad_topk=True,
             return_warp_jacobian=False) -> Dict[str, Tensors]:
    """Coarse and fine rendering of a ray batch. ``rays``: origins [R,3],
    directions [R,3], optional viewdirs [R,3], metadata (ids or
    ``encoded_*``), mask [R,1]. ``generator`` draws the stratified samples
    and the σ noise, where the config asks for them. ``x_for_rgb_alpha``:
    the posenc window of the points in the rgb condition
    (``window_x_in_rgb_condition``); the step passes its schedule's value.
    ``return_warp_jacobian``: True for every level, as the JAX package, or
    the names of the levels that need it (the loss reads only the coarse
    one, and eager PyTorch would compute an unread one all the same)."""
    cfg = self.config
    origins = rays['origins']
    directions = rays['directions']
    metadata = rays.get('metadata', {})
    gt_mask = rays.get('mask')
    viewdirs = rays.get('viewdirs', directions)
    near = self.near if near is None else near
    far = self.far if far is None else far
    if use_sample_at_infinity is None:
      use_sample_at_infinity = cfg.use_sample_at_infinity
    kwargs = dict(generator=generator, use_warp=use_warp,
                  metadata_encoded=metadata_encoded, mask_ratio=mask_ratio,
                  sharp_weights_std=sharp_weights_std,
                  x_for_rgb_alpha=x_for_rgb_alpha, return_full=return_full,
                  compute_sigma_gradient=compute_sigma_gradient,
                  use_norm_grad_topk=use_norm_grad_topk)

    jacobian_levels = (self.levels if return_warp_jacobian is True
                       else return_warp_jacobian or ())

    with tracing.span('nerfds.model.coarse'):
      with tracing.span('nerfds.model.sample'):
        z_vals, points = sampling.sample_along_rays(
            origins, directions, cfg.num_coarse_samples, near, far,
            cfg.use_stratified_sampling, cfg.use_linear_disparity, generator)
      coarse = self.render_samples(
          'coarse', points, z_vals, directions, viewdirs, metadata,
          extra_params, gt_mask,
          use_sample_at_infinity=cfg.use_sample_at_infinity,
          return_warp_jacobian='coarse' in jacobian_levels, **kwargs)
    out = {'coarse': coarse}
    if cfg.num_fine_samples > 0:
      with tracing.span('nerfds.model.fine'):
        with tracing.span('nerfds.model.sample'):
          z_vals_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
          z_vals, points = sampling.sample_pdf(
              z_vals_mid, coarse['weights'][..., 1:-1], origins, directions,
              z_vals, cfg.num_fine_samples, cfg.use_stratified_sampling,
              generator)
        out['fine'] = self.render_samples(
            'fine', points, z_vals, directions, viewdirs, metadata,
            extra_params, gt_mask, coarse_depth=coarse['depth'],
            use_sample_at_infinity=use_sample_at_infinity,
            return_warp_jacobian='fine' in jacobian_levels, **kwargs)
    for level in out.values():
      if not return_weights:
        level.pop('weights', None)
      if not return_points:
        level.pop('points', None)
        level.pop('warped_points', None)
    return out
