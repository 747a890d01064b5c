"""The plain reference of the benchmark's two model configurations.

A frozen, self-contained restatement of the NeRF-DS model's plain path in
float32 PyTorch: the mask MLP, the SE(3) warp field, the bendy hyper sheet,
the NeRF trunk with its σ/normal head and bottleneck, ∇σ by autograd, the
rgb branch and volume compositing. It covers the flags of
``configs/nerf_ds.json`` and ``configs/hypernerf.json`` and refuses any
other setting. It imports nothing of the program under test: parameters
are a dict of tensors named as the benchmark makes them (the program's
state-dict names), and every derived quantity is worked out here again.

Random draws (stratified and importance samples) come from the caller's
``draw(shape)``, asked for in the order and shapes the model draws them,
so that draws from a generator in the same state sample the same points.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
F32_EPS = float(torch.finfo(torch.float32).eps)

# Every ModelConfig field the reference reads, with the only values it
# implements where it implements one (None: any value).
_FIXED = {
    'use_white_background': False, 'use_linear_disparity': False,
    'use_sample_at_infinity': True, 'noise_std': None,
    'activation': 'relu', 'sigma_activation': 'softplus', 'norm_type': None,
    'use_viewdirs': True, 'use_posenc_identity': False,
    'use_nerf_embed': False, 'use_warp': True, 'warp_field_type': 'se3',
    'use_bone': False, 'hyper_slice_method': 'bendy_sheet',
    'hyper_use_warp_embed': True, 'use_hyper_for_sigma': True,
    'use_hyper_for_rgb': False, 'screw_input_mode': None,
    'use_hyper_c': False, 'norm_supervision_type': 'warped',
    'stop_norm_gradient': True, 'norm_input_posenc': True,
    'use_sigma_gradient': False, 'use_ref_radiance': False,
    'window_x_in_rgb_condition': False,
    'use_delta_x_in_rgb_condition': False, 'use_mask_in_rgb': False,
    'use_mask_embed': True, 'clamp_predicted_mask': False,
    'use_coarse_depth_for_mask': False, 'use_mask_scaled_weights': False,
    'use_rgb_sharp_weights': False, 'compute_dtype': None,
    'storage_dtype': None, 'concat_dense_inputs': False,
    'norm_grad_topk': None, 'stop_target_norm_gradient': False,
    'use_stratified_sampling': True, 'nerf_rgb_branch_depth': 1,
}


def check_config(cfg: Dict) -> None:
  """Raises where ``cfg`` sets a flag the reference does not implement."""
  for key, want in _FIXED.items():
    if cfg.get(key, want) != want:
      raise NotImplementedError(f'the reference implements {key}={want!r}, '
                                f'not {cfg[key]!r}')
  nerf_ds_flags = ('predict_norm', 'use_predicted_norm', 'use_mask_in_warp',
                   'use_mask_in_hyper', 'use_predicted_mask', 'use_3d_mask',
                   'use_mask_sharp_weights', 'use_x_in_rgb_condition')
  values = {cfg[k] for k in nerf_ds_flags}
  if len(values) != 1:
    raise NotImplementedError(f'the reference implements {nerf_ds_flags} '
                              'all on (NeRF-DS) or all off (HyperNeRF)')


def is_nerf_ds(cfg: Dict) -> bool:
  return bool(cfg['predict_norm'])


@contextlib.contextmanager
def precision(tf32: bool = False):
  """Float32 products in full float32, or with ``tf32`` in TF32 (the
  lower precision the control runs in); restores the settings after."""
  matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
  saved = (matmul.allow_tf32, cudnn.allow_tf32)
  matmul.allow_tf32 = cudnn.allow_tf32 = tf32
  try:
    yield
  finally:
    matmul.allow_tf32, cudnn.allow_tf32 = saved


# -- parameter layout ---------------------------------------------------------


def posenc_dim(channels: int, min_deg: int, max_deg: int) -> int:
  return 2 * channels * (max_deg - min_deg)


def _mlp_shapes(prefix: str, in_dim: int, depth: int, width: int,
                skips: Sequence[int], out: int = 0) -> Dict:
  shapes = {}
  for i in range(depth):
    rows = (in_dim if i == 0 else width) + (in_dim if i in skips else 0)
    shapes[f'{prefix}.hidden_{i}.kernel'] = (rows, width)
    shapes[f'{prefix}.hidden_{i}.bias'] = (width,)
  if out:
    shapes[f'{prefix}.logit.kernel'] = (width if depth else in_dim, out)
    shapes[f'{prefix}.logit.bias'] = (out,)
  return shapes


def dims(cfg: Dict) -> Dict[str, int]:
  """The input widths of each MLP."""
  ds = is_nerf_ds(cfg)
  mask_ch = int(ds)
  trunk_in = (posenc_dim(3, cfg['spatial_point_min_deg'],
                         cfg['spatial_point_max_deg'])
              + posenc_dim(cfg['hyper_num_dims'], cfg['hyper_point_min_deg'],
                           cfg['hyper_point_max_deg']))
  viewdir = posenc_dim(3, cfg['viewdir_min_deg'], cfg['viewdir_max_deg'])
  rgb_in = cfg['nerf_trunk_width'] + viewdir
  if ds:
    rgb_in += cfg['nerf_trunk_width'] + posenc_dim(
        3, cfg['norm_input_min_deg'], cfg['norm_input_max_deg'])
  return {
      'mask': posenc_dim(3, cfg['mask_min_deg'], cfg['mask_max_deg'])
              + cfg['mask_embed_dims'],
      'warp': posenc_dim(3, cfg['warp_min_deg'], cfg['warp_max_deg'])
              + cfg['warp_embed_dims'] + mask_ch,
      'hyper': posenc_dim(3, cfg['hyper_sheet_min_deg'],
                          cfg['hyper_sheet_max_deg'])
               + cfg['hyper_embed_dims'] + mask_ch,
      'trunk': trunk_in,
      'rgb': rgb_in,
      'head': 1 + (3 if ds else 0),
  }


def param_shapes(cfg: Dict, num_embeds: int) -> Dict[str, tuple]:
  """name -> shape of every parameter, named as the program's state dict
  names it (``nerf.fine.trunk.hidden_0.kernel``, kernels ``[in, out]``)."""
  check_config(cfg)
  d = dims(cfg)
  shapes = {'warp_embed.embedding': (num_embeds, cfg['warp_embed_dims'])}
  shapes.update(_mlp_shapes('warp_field.trunk', d['warp'],
                            cfg['se3_trunk_depth'], cfg['se3_trunk_width'],
                            cfg['se3_skips']))
  for head in ('w', 'v'):
    shapes[f'warp_field.{head}.kernel'] = (cfg['se3_trunk_width'], 3)
    shapes[f'warp_field.{head}.bias'] = (3,)
  shapes.update(_mlp_shapes('hyper_sheet.mlp', d['hyper'],
                            cfg['hyper_sheet_depth'],
                            cfg['hyper_sheet_width'],
                            cfg['hyper_sheet_skips'], cfg['hyper_num_dims']))
  if is_nerf_ds(cfg):
    shapes['mask_embed.embedding'] = (num_embeds, cfg['mask_embed_dims'])
    shapes.update(_mlp_shapes('mask_mlp.mlp', d['mask'],
                              cfg['mask_mlp_depth'], cfg['mask_mlp_width'],
                              cfg['mask_skips'], 1))
  width = cfg['nerf_trunk_width']
  for level in levels(cfg):
    pre = f'nerf.{level}'
    shapes.update(_mlp_shapes(f'{pre}.trunk', d['trunk'],
                              cfg['nerf_trunk_depth'], width,
                              cfg['nerf_skips']))
    shapes[f'{pre}.bottleneck.kernel'] = (width, width)
    shapes[f'{pre}.bottleneck.bias'] = (width,)
    shapes[f'{pre}.alpha.logit.kernel'] = (width, d['head'])
    shapes[f'{pre}.alpha.logit.bias'] = (d['head'],)
    shapes.update(_mlp_shapes(f'{pre}.rgb', d['rgb'], 1,
                              cfg['nerf_rgb_branch_width'], (), 3))
  return shapes


def levels(cfg: Dict) -> List[str]:
  return ['coarse', 'fine'] if cfg['num_fine_samples'] > 0 else ['coarse']


# -- primitives ---------------------------------------------------------------


def posenc(x: torch.Tensor, min_deg: int, max_deg: int,
           alpha=None) -> torch.Tensor:
  """Band-major sin/cos encoding at 2^[min_deg, max_deg), each band
  weighted by the truncated-Hann window at ``alpha``."""
  bands = max_deg - min_deg
  scales = 2.0 ** torch.arange(min_deg, max_deg, dtype=x.dtype,
                               device=x.device)
  xb = (x[..., None, :] * scales[:, None]).reshape(*x.shape[:-1], -1)
  sin, cos = torch.sin(xb), torch.sin(xb + 0.5 * math.pi)
  if alpha is not None:
    band = torch.arange(min_deg, max_deg, dtype=torch.float32,
                        device=x.device)
    a = torch.full((), float(alpha), dtype=torch.float32, device=x.device)
    window = 0.5 * (1.0 + torch.cos(
        math.pi * torch.clamp(a - band, 0.0, 1.0) + math.pi))
    window = window.repeat_interleave(x.shape[-1])
    sin, cos = window * sin, window * cos
  c = x.shape[-1]
  return torch.cat([sin.reshape(*x.shape[:-1], bands, 1, c),
                    cos.reshape(*x.shape[:-1], bands, 1, c)],
                   -2).reshape(*x.shape[:-1], -1)


def normalize(v: torch.Tensor) -> torch.Tensor:
  return v / torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True),
                                    min=F32_EPS))


def dense(P: Params, name: str, blocks) -> torch.Tensor:
  """``concat(blocks) @ kernel + bias``, each block against its rows."""
  kernel = P[name + '.kernel']
  if isinstance(blocks, torch.Tensor):
    blocks = [blocks]
  y, row = None, 0
  for b in blocks:
    part = b @ kernel[row:row + b.shape[-1]]
    y = part if y is None else y + part
    row += b.shape[-1]
  assert row == kernel.shape[0], (name, row, kernel.shape)
  return y + P[name + '.bias']


def mlp(P: Params, prefix: str, inputs: List[torch.Tensor], depth: int,
        skips: Sequence[int], logit: bool = False,
        out_act=None) -> torch.Tensor:
  h = None
  for i in range(depth):
    layer_in = inputs if i == 0 else [h]
    if i in skips:
      layer_in = layer_in + inputs
    h = torch.relu(dense(P, f'{prefix}.hidden_{i}', layer_in))
  if logit:
    h = dense(P, f'{prefix}.logit', [h])
    if out_act is not None:
      h = out_act(h)
  return h


def cross(a, b):
  return torch.linalg.cross(a, b, dim=-1)


def screw(P: Params, cfg: Dict, p, warp_in, warp_alpha):
  """(w unit axis, v, θ) of the SE(3) field at points ``p``."""
  feat = [posenc(p, cfg['warp_min_deg'], cfg['warp_max_deg'], warp_alpha),
          warp_in]
  h = mlp(P, 'warp_field.trunk', feat, cfg['se3_trunk_depth'],
          cfg['se3_skips'])
  w_raw = dense(P, 'warp_field.w', [h])
  v_raw = dense(P, 'warp_field.v', [h])
  theta = torch.linalg.vector_norm(w_raw, dim=-1)
  denom = torch.clamp(theta, min=1e-12)[..., None]
  return w_raw / denom, v_raw / denom, theta


def rotate(s, x, inverse: bool = False):
  w, _, theta = s
  th = theta[..., None]
  sign = -1.0 if inverse else 1.0
  return (x * torch.cos(th) + sign * cross(w, x) * torch.sin(th)
          + w * (w * x).sum(-1, keepdim=True) * (1.0 - torch.cos(th)))


def transform(s, x):
  w, v, theta = s
  th = theta[..., None]
  p = (th * v + (1.0 - torch.cos(th)) * cross(w, v)
       + (th - torch.sin(th)) * (w * (w * v).sum(-1, keepdim=True) - v))
  return rotate(s, x) + p


def weights_of(sigma, z_vals, dirs, eps=1e-10):
  """(alpha, weights) of compositing at infinity."""
  dists = torch.cat([z_vals[..., 1:] - z_vals[..., :-1],
                     torch.full_like(z_vals[..., :1], 1e10)], -1)
  dists = dists * torch.linalg.vector_norm(dirs[..., None, :], dim=-1)
  alpha = 1.0 - torch.exp(-sigma * dists)
  trans = torch.cat([torch.ones_like(alpha[..., :1]),
                     torch.cumprod(1.0 - alpha[..., :-1] + eps, -1)], -1)
  return alpha, alpha * trans


def sharpen(weights, z_vals, std):
  idx = torch.argmax(weights, -1)
  mz = torch.gather(z_vals, -1, idx[..., None])
  s2 = std * std
  pdf = torch.exp((math.log(2 * math.pi * s2) + (z_vals - mz) ** 2 / s2)
                  / -2.0)
  sharp = weights * pdf
  return sharp / (sharp.sum(-1, keepdim=True) + 1e-12)


def depth_index(weights, threshold=0.5):
  opaque = torch.cumsum(weights, -1) >= threshold
  first = torch.logical_xor(opaque, torch.cat(
      [torch.zeros_like(opaque[..., :1]), opaque[..., :-1]], -1))
  return torch.argmax(first.to(weights.dtype), -1)


def stratified(origins, directions, n, near, far, draw):
  t = torch.linspace(0.0, 1.0, n, device=origins.device)
  z = near * (1.0 - t) + far * t
  mids = 0.5 * (z[1:] + z[:-1])
  upper = torch.cat([mids, z[-1:]])
  lower = torch.cat([z[:1], mids])
  u = draw((origins.shape[0], n))
  z = lower + (upper - lower) * u
  return z, origins[:, None, :] + z[..., None] * directions[:, None, :]


def importance(bins, weights, z_vals, origins, directions, n, draw):
  """Inverse-CDF samples of the piecewise-constant PDF ``weights`` over
  ``bins``, merged with ``z_vals`` and sorted."""
  weights = weights + 1e-5
  pdf = weights / weights.sum(-1, keepdim=True)
  cdf = torch.cat([torch.zeros_like(pdf[..., :1]), torch.cumsum(pdf, -1)],
                  -1)
  u = draw((*cdf.shape[:-1], n))
  below = u[..., None, :] >= cdf[..., :, None]

  def bracket(x):
    lo = torch.where(below, x[..., None], x[..., :1, None]).amax(-2)
    hi = torch.where(~below, x[..., None], x[..., -1:, None]).amin(-2)
    return torch.minimum(lo, x[..., -2:-1]), torch.maximum(hi, x[..., 1:2])

  b0, b1 = bracket(bins)
  c0, c1 = bracket(cdf)
  denom = torch.where(c1 - c0 < 1e-5, torch.ones_like(c0), c1 - c0)
  z_new = (b0 + (u - c0) / denom * (b1 - b0)).detach()
  z, _ = torch.sort(torch.cat([z_vals, z_new], -1), -1)
  return z, origins[:, None, :] + z[..., None] * directions[:, None, :]


# -- one level ----------------------------------------------------------------


def level_forward(P: Params, cfg: Dict, level: str, points, z_vals,
                  directions, ids, gt_mask, scalars: Dict[str, float],
                  with_grad: bool, sigma_gradient: bool = True
                  ) -> Dict[str, torch.Tensor]:
  """One level over ``points`` [R, S, 3]. ``ids`` [R] warp ids; ``gt_mask``
  [R, 1]. ``with_grad``: keep the graph of ∇σ (training);
  ``sigma_gradient`` False leaves ∇σ and the normal target out, as the
  program's renderer does by default."""
  ds = is_nerf_ds(cfg)
  r, s = points.shape[:2]
  n = r * s
  pts = points.reshape(n, 3)

  def per_sample(x):
    return x[:, None, :].expand(r, s, x.shape[-1]).reshape(n, x.shape[-1])

  warp_embed = per_sample(P['warp_embed.embedding'][ids])
  viewdir_feat = per_sample(posenc(directions, cfg['viewdir_min_deg'],
                                   cfg['viewdir_max_deg']))
  out = {}
  if ds:
    mask_embed = per_sample(P['mask_embed.embedding'][ids])
    pm = mlp(P, 'mask_mlp.mlp',
             [posenc(pts, cfg['mask_min_deg'], cfg['mask_max_deg'],
                     scalars['warp_alpha']), mask_embed],
             cfg['mask_mlp_depth'], cfg['mask_skips'], logit=True,
             out_act=torch.relu)
    ratio = scalars['mask_ratio']
    mask = pm * ratio + per_sample(gt_mask) * (1.0 - ratio)
    warp_in = torch.cat([warp_embed, mask], -1)
    out['predicted_mask'] = pm.reshape(r, s)
  else:
    warp_in = warp_embed
  hyper_in = warp_in  # the hyper sheet reads the warp's embedding

  def sigma_fn(p):
    sc = screw(P, cfg, p, warp_in, scalars['warp_alpha'])
    hyper = mlp(P, 'hyper_sheet.mlp',
                [posenc(p, cfg['hyper_sheet_min_deg'],
                        cfg['hyper_sheet_max_deg'],
                        scalars['hyper_sheet_alpha']), hyper_in],
                cfg['hyper_sheet_depth'], cfg['hyper_sheet_skips'],
                logit=True)
    warped = torch.cat([transform(sc, p), hyper], -1)
    feat = [posenc(warped[:, :3], cfg['spatial_point_min_deg'],
                   cfg['spatial_point_max_deg'], scalars['nerf_alpha']),
            posenc(warped[:, 3:], cfg['hyper_point_min_deg'],
                   cfg['hyper_point_max_deg'], scalars['hyper_alpha'])]
    trunk = mlp(P, f'nerf.{level}.trunk', feat, cfg['nerf_trunk_depth'],
                cfg['nerf_skips'])
    bottleneck = dense(P, f'nerf.{level}.bottleneck', [trunk])
    head = dense(P, f'nerf.{level}.alpha.logit', [trunk])
    return head, trunk, bottleneck, sc, warped

  target = None
  if ds and sigma_gradient:
    p = pts.detach().requires_grad_()
    with torch.enable_grad():
      head, trunk, bottleneck, sc, warped = sigma_fn(p)
      (grad,) = torch.autograd.grad(head[:, 0].sum(), p,
                                    create_graph=with_grad)
    target = normalize(rotate(sc, normalize(-grad)))
  else:
    head, trunk, bottleneck, sc, warped = sigma_fn(pts)
  sigma_raw = head[:, 0]
  rgb_in = [bottleneck, viewdir_feat]
  if ds:
    norm = head[:, 1:4]
    norm_in = normalize(rotate(sc, normalize(norm), inverse=True).detach())
    rgb_in += [trunk, posenc(norm_in, cfg['norm_input_min_deg'],
                             cfg['norm_input_max_deg'],
                             scalars['norm_input_alpha'])]
  rgb = torch.sigmoid(mlp(P, f'nerf.{level}.rgb', rgb_in, 1, (),
                          logit=True)).reshape(r, s, 3)
  sigma = F.softplus(sigma_raw.reshape(r, s))
  alpha, weights = weights_of(sigma, z_vals, directions)
  out.update(
      rgb=(weights[..., None] * rgb).sum(-2),
      depth=(weights * z_vals).sum(-1),
      acc=weights[..., :-1].sum(-1),
      weights=weights,
      points=points,
      warped=warped.reshape(r, s, -1))
  if ds:
    norm = norm.reshape(r, s, 3)
    out['predicted_norm'] = norm
    out['ray_norm'] = (weights[..., None] * norm).sum(-2)
    if target is not None:
      out['target_norm'] = target.reshape(r, s, 3)
    out['back_facing'] = torch.relu((norm * directions[:, None, :]).sum(-1)
                                    ) ** 2
    mask_weights = weights_of(sigma, z_vals, directions)[1].detach()
    out['sharp_weights'] = sharpen(mask_weights, z_vals,
                                   scalars['sharp_weights_std'])
  return out


def render(P: Params, cfg: Dict, origins, directions, ids, gt_mask,
           scalars: Dict[str, float], draw, near: float, far: float,
           with_grad: bool, sigma_gradient: bool = True
           ) -> Dict[str, Dict[str, torch.Tensor]]:
  """Coarse then fine level of a ray batch (unit ``directions``, which
  are also the view directions); ``draw(shape)`` gives the uniforms."""
  z, pts = stratified(origins, directions, cfg['num_coarse_samples'], near,
                      far, draw)
  coarse = level_forward(P, cfg, 'coarse', pts, z, directions, ids, gt_mask,
                         scalars, with_grad, sigma_gradient)
  out = {'coarse': coarse}
  if cfg['num_fine_samples'] > 0:
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    z, pts = importance(mids, coarse['weights'][..., 1:-1], z, origins,
                        directions, cfg['num_fine_samples'], draw)
    out['fine'] = level_forward(P, cfg, 'fine', pts, z, directions, ids,
                                gt_mask, scalars, with_grad, sigma_gradient)
  return out
