"""The NeRF-DS model (L3), counterpart of ``nerfds_tpu/models/nerfds.py``.

Coarse and fine levels of a dynamic NeRF: a predicted 3D mask on the
observation points conditions an SE(3) warp field and a hyper sheet, whose
outputs feed the NeRF trunk; its head predicts σ and a surface normal, and
the per-point ∇σ (``compute_sigma_gradient``) gives the normal target.

The port covers the flag set of ``config.nerf_ds()``. ∇σ comes two ways,
which give the same numbers:

* ``sigma_gradient_mode='vmap'``: autograd of Σσ with respect to the points
  (σᵢ depends only on pointᵢ, so this is the per-point gradient);
* ``'fused'``: the hand-written trunk kernel (``kernels/fused_trunk.py``)
  returns σ, the heads and g = ∂σ/∂feat in one launch, and autograd pulls g
  back through the warp / hyper / posenc feature path.

Both differentiate with respect to ``p = pts.detach().requires_grad_()``,
never ``pts`` itself: the mask MLP also reads ``pts`` and its output is
part of the warp and hyper embeddings, which the JAX package holds fixed
when it takes the per-point gradient.

Flags and modes outside that set raise ``NotImplementedError``; ROADMAP.md
queues them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from nerfds_torch.config import ModelConfig
from nerfds_torch.device import resolve_device
from nerfds_torch.kernels import fused_trunk
from nerfds_torch.models.embeddings import GLOEmbed
from nerfds_torch.models.hyper import HyperSheetMLP, MaskMLP
from nerfds_torch.models.mlp import NerfMLP, get_activation
from nerfds_torch.models.warp import SE3Field
from nerfds_torch.ops import math as math_ops
from nerfds_torch.ops import rendering, rigid, sampling

Tensors = Dict[str, torch.Tensor]


def unsupported_features(cfg: ModelConfig):
  """Names of the configured features this port does not run yet."""
  checks = {
      'use_bone': cfg.use_bone,
      f'warp_field_type={cfg.warp_field_type!r}': cfg.warp_field_type != 'se3',
      "hyper_slice_method='axis_aligned_plane'":
          cfg.hyper_slice_method == 'axis_aligned_plane',
      'use_hyper_c': cfg.use_hyper_c,
      'use_ref_radiance': cfg.use_ref_radiance,
      'use_sigma_gradient': cfg.use_sigma_gradient,
      'use_nerf_embed': cfg.use_nerf_embed,
      f'screw_input_mode={cfg.screw_input_mode!r}':
          cfg.screw_input_mode not in (None, 'none', 'None'),
      f'norm_supervision_type={cfg.norm_supervision_type!r}':
          cfg.norm_supervision_type != 'warped',
      f'sigma_gradient_mode={cfg.sigma_gradient_mode!r}':
          cfg.sigma_gradient_mode not in ('vmap', 'fused'),
      'norm_grad_topk': cfg.norm_grad_topk is not None,
      'remat_sigma': cfg.remat_sigma,
      'remat_feat': cfg.remat_feat,
      f'compute_dtype={cfg.compute_dtype!r}': cfg.compute_dtype is not None,
      f'storage_dtype={cfg.storage_dtype!r}': cfg.storage_dtype is not None,
      f'norm_type={cfg.norm_type!r}': cfg.norm_type is not None,
      'concat_dense_inputs': cfg.concat_dense_inputs,
      'window_x_in_rgb_condition': cfg.window_x_in_rgb_condition,
      'use_delta_x_in_rgb_condition': cfg.use_delta_x_in_rgb_condition,
      'use_hyper_for_rgb': cfg.use_hyper_for_rgb,
      'use_mask_in_rgb': cfg.use_mask_in_rgb,
      'use_mask_scaled_weights': cfg.use_mask_scaled_weights,
      'use_coarse_depth_for_mask': cfg.use_coarse_depth_for_mask,
      'clamp_predicted_mask': cfg.clamp_predicted_mask,
  }
  return [name for name, on in checks.items() if on]


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


def _detach(x):
  if isinstance(x, rigid.Screw):
    return rigid.Screw(*(t.detach() for t in x))
  return x.detach() if isinstance(x, torch.Tensor) else x


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
    missing = unsupported_features(config)
    if missing:
      raise NotImplementedError(
          f'nerfds_torch does not port {missing} yet; see ROADMAP.md, '
          'queue 1')
    device = resolve_device(device)
    self.config = config
    self.num_warp_embeds = num_warp_embeds
    self.num_hyper_embeds = num_hyper_embeds
    self.num_nerf_embeds = num_nerf_embeds
    self.near, self.far = near, far
    gen = generator
    if gen is None:
      gen = torch.Generator().manual_seed(0)
    cfg = config
    if cfg.use_warp:
      self.warp_embed = GLOEmbed(num_warp_embeds, cfg.warp_embed_dims,
                                 generator=gen)
      self.warp_field = SE3Field(
          self.warp_metadata_dim, min_deg=cfg.warp_min_deg,
          max_deg=cfg.warp_max_deg, trunk_depth=cfg.se3_trunk_depth,
          trunk_width=cfg.se3_trunk_width, skips=cfg.se3_skips,
          activation=cfg.activation, generator=gen)
    if self.use_hyper_embed:
      self.hyper_embed = GLOEmbed(num_hyper_embeds, cfg.hyper_embed_dims,
                                  generator=gen)
    if cfg.has_hyper:
      self.hyper_sheet = HyperSheetMLP(
          self.hyper_metadata_dim, output_channels=cfg.hyper_num_dims,
          min_deg=cfg.hyper_sheet_min_deg, max_deg=cfg.hyper_sheet_max_deg,
          depth=cfg.hyper_sheet_depth, width=cfg.hyper_sheet_width,
          skips=cfg.hyper_sheet_skips, generator=gen)
    if cfg.use_predicted_mask:
      self.mask_embed = GLOEmbed(num_warp_embeds, cfg.mask_embed_dims,
                                 generator=gen)
      self.mask_mlp = MaskMLP(
          self.mask_metadata_dim, min_deg=cfg.mask_min_deg,
          max_deg=cfg.mask_max_deg, depth=cfg.mask_mlp_depth,
          width=cfg.mask_mlp_width, skips=cfg.mask_skips,
          output_activation=cfg.mask_output_activation, generator=gen)
    rgb_total = (self.rgb_condition_dim + self.extra_rgb_condition_dim
                 + self.norm_input_dim)
    self.nerf = nn.ModuleDict({
        level: NerfMLP(
            self.nerf_in_dim, 0, rgb_total, self.has_condition,
            trunk_depth=cfg.nerf_trunk_depth,
            trunk_width=cfg.nerf_trunk_width,
            rgb_branch_depth=cfg.nerf_rgb_branch_depth,
            rgb_branch_width=cfg.nerf_rgb_branch_width,
            activation=cfg.activation, skips=cfg.nerf_skips,
            predict_norm=cfg.predict_norm, generator=gen)
        for level in self.levels})
    self.to(device)

  @property
  def device(self) -> torch.device:
    return self.nerf['coarse'].trunk.hidden_0.kernel.device

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
    return self.config.mask_embed_dims if self.config.use_mask_embed else 0

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
  def norm_input_dim(self) -> int:
    cfg = self.config
    if not cfg.use_predicted_norm:
      return 0
    if cfg.norm_input_posenc:
      return math_ops.posenc_dim(3, cfg.norm_input_min_deg,
                                 cfg.norm_input_max_deg,
                                 cfg.use_posenc_identity)
    return 3

  @property
  def rgb_condition_dim(self) -> int:
    cfg = self.config
    if not cfg.use_viewdirs:
      return 0
    return math_ops.posenc_dim(3, cfg.viewdir_min_deg, cfg.viewdir_max_deg,
                               cfg.use_posenc_identity)

  @property
  def extra_rgb_condition_dim(self) -> int:
    # "x" in the rgb condition is the trunk output re-fed to the rgb branch.
    return self.config.nerf_trunk_width if (
        self.config.use_x_in_rgb_condition) else 0

  @property
  def has_condition(self) -> bool:
    """Whether the NerfMLP has a bottleneck (an rgb condition is fed)."""
    return self.config.use_viewdirs

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

  def encode_metadata(self, metadata) -> Tensors:
    """Pre-encodes the GLO embeddings, so chunked rendering skips lookups."""
    encoded = {}
    if self.config.use_warp:
      encoded['encoded_warp'] = self.encode_warp_embed(metadata)
    if self.config.has_hyper:
      encoded['encoded_hyper'] = self.encode_hyper_embed(metadata)
    if self.config.use_predicted_mask:
      encoded['encoded_mask'] = self.encode_mask_embed(metadata)
    return encoded

  # -- the σ path -----------------------------------------------------------

  def make_feat_fn(self, warp_in_embed, hyper_in_embed, extra_params, *,
                   use_warp=True):
    """p -> (trunk feature blocks, aux): the warp field, the hyper sheet and
    the posencs, the part of the σ path before the NeRF trunk."""
    cfg = self.config

    def feat_fn(p):
      screw = None
      if use_warp:
        screw = self.warp_field.screw(p, warp_in_embed,
                                      extra_params['warp_alpha'])
        warped_spatial = rigid.transform_point(screw, p)
      else:
        warped_spatial = p
      hyper = None
      if cfg.has_hyper:
        hyper = self.hyper_sheet(p, hyper_in_embed,
                                 alpha=extra_params['hyper_sheet_alpha'])
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
             'hyper': hyper, 'warped': warped}
      return feat, aux

    return feat_fn

  def make_sigma_fn(self, level, warp_in_embed, hyper_in_embed,
                    extra_params, *, use_warp=True):
    """The pointwise-batched density function of ``[N, 3]`` points:
    p -> (σ_raw [N], aux with the trunk output, bottleneck and normal)."""
    feat_fn = self.make_feat_fn(warp_in_embed, hyper_in_embed, extra_params,
                                use_warp=use_warp)
    nerf = self.nerf[level]

    def sigma_fn(p):
      feat, aux = feat_fn(p)
      trunk_out, bottleneck = nerf.query_bottleneck(feat)
      sigma_raw, norm = nerf.query_sigma(trunk_out, bottleneck)
      aux.update(trunk_out=trunk_out, bottleneck=bottleneck, norm=norm)
      return sigma_raw[..., 0], aux

    return sigma_fn

  def trunk_spec(self, in_dim: int) -> fused_trunk.TrunkSpec:
    cfg = self.config
    return fused_trunk.TrunkSpec(
        depth=cfg.nerf_trunk_depth, width=cfg.nerf_trunk_width,
        skips=tuple(cfg.nerf_skips), in_dim=in_dim, alpha_channels=1,
        norm_dim=self.nerf['coarse'].norm_dim if cfg.predict_norm else 0,
        has_bottleneck=self.has_condition)

  def _sigma_and_grad(self, level, pts, warp_in_embed, hyper_in_embed,
                      extra_params, use_warp):
    """σ_raw, aux and ∂σ/∂p for every point.

    In the caller's no-grad mode everything comes back detached. With grad
    on, ∇σ keeps its graph (second order), so a loss on it reaches every
    parameter upstream: 'vmap' takes autograd of Σσ with create_graph;
    'fused' runs the trunk through ``fused_trunk.TrunkSigmaGrad`` (forward
    K1f, backward K1b) on the feature path's output ``feat`` itself, and
    pulls g back through the feature path with create_graph, so the outer
    backward reaches Ḡ in K1b and the small MLPs' second-order terms.

    The gradient is taken with respect to a separate leaf
    ``p = pts.detach()``, so it reaches neither the mask path nor ``pts``.
    That leaf cuts only ∂/∂origins: no parameter lies upstream of ``pts``,
    since the fine z values are stop-gradiented (``ops/sampling.py``).
    """
    outer_grad = torch.is_grad_enabled()
    mode = self.config.sigma_gradient_mode
    if mode == 'fused' and self.config.activation != 'relu':
      mode = 'vmap'  # as the JAX package does: the kernel is relu-only
    p = pts.detach().requires_grad_()
    nerf = self.nerf[level]
    if mode == 'fused':
      feat_fn = self.make_feat_fn(warp_in_embed, hyper_in_embed,
                                  extra_params, use_warp=use_warp)
      with torch.enable_grad():
        parts, aux = feat_fn(p)
        feat = parts[0] if len(parts) == 1 else torch.cat(parts, -1)
      sigma_2d, norm, trunk_out, bottleneck, g = fused_trunk.trunk_sigma_grad(
          feat, nerf.trunk_weights(), self.trunk_spec(feat.shape[-1]))
      (grad_pts,) = torch.autograd.grad(feat, p, grad_outputs=g,
                                        create_graph=outer_grad)
      aux.update(trunk_out=trunk_out, bottleneck=bottleneck, norm=norm)
      sigma_raw = sigma_2d[..., 0]
    else:
      sigma_fn = self.make_sigma_fn(level, warp_in_embed, hyper_in_embed,
                                    extra_params, use_warp=use_warp)
      with torch.enable_grad():
        sigma_raw, aux = sigma_fn(p)
        (grad_pts,) = torch.autograd.grad(sigma_raw.sum(), p,
                                          create_graph=outer_grad)
    if not outer_grad:
      sigma_raw, grad_pts = sigma_raw.detach(), grad_pts.detach()
      aux = {k: _detach(v) for k, v in aux.items()}
    return sigma_raw, aux, grad_pts

  # -- the per-level forward ------------------------------------------------

  def render_samples(self, level, points, z_vals, directions, viewdirs,
                     metadata, extra_params, gt_mask, *, generator=None,
                     use_warp=True, metadata_encoded=False,
                     use_sample_at_infinity=True, mask_ratio=1.0,
                     sharp_weights_std=1.0, return_full=False,
                     compute_sigma_gradient=None) -> Tensors:
    cfg = self.config
    num_rays, num_samples = points.shape[:2]
    n = num_rays * num_samples
    pts = points.reshape(n, 3)
    out: Tensors = {'points': points}
    if metadata and 'hyper_point' in metadata:
      raise NotImplementedError('hyper_point override; see ROADMAP.md')

    def broadcast_ray(x):
      """[R, C] per-ray feature -> [R*S, C] per-sample feature."""
      return x[:, None, :].expand(num_rays, num_samples,
                                  x.shape[-1]).reshape(n, x.shape[-1])

    use_warp = cfg.use_warp and use_warp

    warp_embed = None
    if use_warp:
      warp_embed = broadcast_ray(
          metadata['encoded_warp'] if metadata_encoded
          else self.encode_warp_embed(metadata))
    hyper_embed = None
    if cfg.has_hyper:
      if metadata_encoded:
        hyper_embed = broadcast_ray(metadata['encoded_hyper'])
      elif cfg.hyper_use_warp_embed and warp_embed is not None:
        hyper_embed = warp_embed
      else:
        hyper_embed = broadcast_ray(self.encode_hyper_embed(metadata))
    rgb_condition = None
    if cfg.use_viewdirs:
      rgb_condition = [broadcast_ray(math_ops.posenc(
          viewdirs, cfg.viewdir_min_deg, cfg.viewdir_max_deg,
          cfg.use_posenc_identity))]

    gt_mask_b = broadcast_ray(gt_mask) if gt_mask is not None else None

    # Predicted 3D mask field on the observation-space points.
    predicted_mask = None
    if cfg.use_predicted_mask:
      if metadata_encoded and 'encoded_mask' in metadata:
        mask_embed = broadcast_ray(metadata['encoded_mask'])
      else:
        mask_embed = broadcast_ray(self.encode_mask_embed(metadata))
      predicted_mask = self.mask_mlp(pts, mask_embed,
                                     alpha=extra_params['warp_alpha'],
                                     use_embed=cfg.use_mask_embed)
      out['predicted_mask'] = predicted_mask.reshape(num_rays, num_samples, 1)
      mask = predicted_mask * mask_ratio + gt_mask_b * (1.0 - mask_ratio)
    else:
      mask = gt_mask_b

    # Mask-conditioned metadata for the warp and the hyper sheet.
    warp_in_embed = warp_embed
    if use_warp and cfg.use_mask_in_warp:
      warp_in_embed = torch.cat([warp_embed, mask], -1)
    hyper_in_embed = hyper_embed
    if cfg.has_hyper and cfg.use_mask_in_hyper:
      hyper_in_embed = torch.cat([hyper_embed, mask], -1)

    if compute_sigma_gradient is None:
      compute_sigma_gradient = cfg.needs_sigma_gradient
    if compute_sigma_gradient:
      sigma_raw, aux, grad_pts = self._sigma_and_grad(
          level, pts, warp_in_embed, hyper_in_embed, extra_params, use_warp)
      if cfg.stop_target_norm_gradient:
        grad_pts = grad_pts.detach()
      sigma_gradient = math_ops.normalize(-grad_pts)
    else:
      sigma_raw, aux = self.make_sigma_fn(
          level, warp_in_embed, hyper_in_embed, extra_params,
          use_warp=use_warp)(pts)
      sigma_gradient = None
    screw = aux['screw']
    norm = aux['norm']

    # Normal input of the radiance branch: the predicted normal, rotated
    # back to the observation frame by the inverse of the same screw.
    norm_input_feat = None
    if cfg.use_predicted_norm:
      norm_input = math_ops.normalize(norm)
      if screw is not None:
        norm_input = rigid.rotate_inverse(screw, norm_input)
      if cfg.stop_norm_gradient:
        norm_input = norm_input.detach()
      norm_input = math_ops.normalize(norm_input)
      if return_full:
        out['norm_input'] = norm_input.reshape(num_rays, num_samples, 3)
      norm_input_feat = (math_ops.posenc(
          norm_input, cfg.norm_input_min_deg, cfg.norm_input_max_deg,
          cfg.use_posenc_identity, alpha=extra_params['norm_input_alpha'])
          if cfg.norm_input_posenc else norm_input)

    extra_rgb_condition = ([aux['trunk_out']] if cfg.use_x_in_rgb_condition
                           else None)

    # Mask-derived compositing weights (for the 3D mask loss).
    sigma_act = get_activation(cfg.sigma_activation)
    mask_weights = rendering.cal_weights(
        sigma_act(sigma_raw.reshape(num_rays, num_samples)), z_vals,
        directions).detach()
    if cfg.use_mask_sharp_weights:
      out['sharp_weights'] = rendering.sharpen_weights(
          mask_weights, z_vals, std=sharp_weights_std)

    rgb_raw = self.nerf[level].query_rgb(
        aux['trunk_out'], aux['bottleneck'], rgb_condition,
        extra_rgb_condition, None, norm_input_feat)
    rgb = torch.sigmoid(rgb_raw).reshape(num_rays, num_samples, 3)
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
      # Canonical-frame target: ∇σ rotated forward by the same screw.
      target = (rigid.rotate(screw, sigma_gradient) if screw is not None
                else sigma_gradient)
      out['target_norm'] = math_ops.normalize(target).reshape(
          num_rays, num_samples, 3)

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
    if cfg.use_predicted_mask:
      out['ray_predicted_mask'] = (weights[..., None]
                                   * out['predicted_mask']).sum(-2)

    depth_indices = rendering.compute_depth_index(weights)
    out['med_points'] = torch.gather(
        warped_points, 1, depth_indices[:, None, None].expand(
            -1, 1, warped_points.shape[-1]))

    if return_full and screw is not None:
      rotation_ref = math_ops.normalize(torch.ones_like(pts))
      rf = math_ops.normalize(rigid.rotate(screw, rotation_ref))
      out['ray_rotation_field'] = (
          weights[..., None] * rf.reshape(num_rays, num_samples, 3)).sum(-2)
      tf = rigid.translation(screw).reshape(num_rays, num_samples, 3)
      out['ray_translation_field'] = (weights[..., None] * tf).sum(-2)
    return out

  # -- full forward ---------------------------------------------------------

  def forward(self, rays: Dict[str, Any], extra_params, **kwargs):
    """:meth:`render`, so ``torch.func.functional_call`` can run the model
    on a parameter dict (``training/step.py``)."""
    return self.render(rays, extra_params, **kwargs)

  def render(self, rays: Dict[str, Any], extra_params, *,
             generator: Optional[torch.Generator] = None, use_warp=True,
             metadata_encoded=False, return_points=False,
             return_weights=True, near=None, far=None,
             use_sample_at_infinity=None, mask_ratio=1.0,
             sharp_weights_std=1.0, return_full=False,
             compute_sigma_gradient=None) -> Dict[str, Tensors]:
    """Coarse and fine rendering of a ray batch. ``rays``: origins [R,3],
    directions [R,3], optional viewdirs [R,3], metadata (ids or
    ``encoded_*``), mask [R,1]. ``generator`` draws the stratified samples
    and the σ noise, where the config asks for them."""
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
                  return_full=return_full,
                  compute_sigma_gradient=compute_sigma_gradient)

    z_vals, points = sampling.sample_along_rays(
        origins, directions, cfg.num_coarse_samples, near, far,
        cfg.use_stratified_sampling, cfg.use_linear_disparity, generator)
    coarse = self.render_samples(
        'coarse', points, z_vals, directions, viewdirs, metadata,
        extra_params, gt_mask,
        use_sample_at_infinity=cfg.use_sample_at_infinity, **kwargs)
    out = {'coarse': coarse}
    if cfg.num_fine_samples > 0:
      z_vals_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
      z_vals, points = sampling.sample_pdf(
          z_vals_mid, coarse['weights'][..., 1:-1], origins, directions,
          z_vals, cfg.num_fine_samples, cfg.use_stratified_sampling,
          generator)
      out['fine'] = self.render_samples(
          'fine', points, z_vals, directions, viewdirs, metadata,
          extra_params, gt_mask,
          use_sample_at_infinity=use_sample_at_infinity, **kwargs)
    for level in out.values():
      if not return_weights:
        level.pop('weights', None)
      if not return_points:
        level.pop('points', None)
        level.pop('warped_points', None)
    return out
