"""The benchmark's yardstick: the H100's published peaks, the operations
and bytes of the trunk kernels K1f and K1b and of the compositing kernel
K2, their least times, and the model FLOPs of a ray.

The kernel counts are frozen copies of ``chip_smoke.py``'s
``trunk_flops``, ``trunk_weight_count``, ``trunk_fwd_bound``,
``trunk_bwd_flops``, ``trunk_bwd_bound`` and ``composite_bound``, taking a
:class:`TrunkSpec` of numbers instead of the program's weight tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

from h100_bench.reference import model as ref

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit.
PEAK_F32_FLOP_PER_S = 67e12      # float32 on the CUDA cores
PEAK_BYTES_PER_S = 3.35e12       # HBM3


@dataclasses.dataclass(frozen=True)
class TrunkSpec:
  """The NeRF trunk as K1 runs it."""
  depth: int
  width: int
  skips: Tuple[int, ...]
  in_dim: int
  alpha_channels: int
  norm_dim: int
  has_bottleneck: bool


def trunk_spec(model_cfg: Dict) -> TrunkSpec:
  d = ref.dims(model_cfg)
  return TrunkSpec(depth=model_cfg['nerf_trunk_depth'],
                   width=model_cfg['nerf_trunk_width'],
                   skips=tuple(model_cfg['nerf_skips']), in_dim=d['trunk'],
                   alpha_channels=1, norm_dim=d['head'] - 1,
                   has_bottleneck=True)


def trunk_flops(spec: TrunkSpec) -> int:
  """K1f: multiply-adds of one row, forward and reverse sweep, times two."""
  w, d = spec.width, spec.in_dim
  n_skips = len([i for i in spec.skips if i])
  fwd = d * w + (spec.depth - 1) * w * w + n_skips * d * w
  fwd += w * (spec.alpha_channels + spec.norm_dim)
  fwd += w * w if spec.has_bottleneck else 0
  rev = (spec.depth - 1) * w * w + d * w * (1 + n_skips)
  return 2 * (fwd + rev)


def trunk_weight_count(spec: TrunkSpec) -> int:
  """Floats of the trunk's, the head's and the bottleneck's weights."""
  w, d = spec.width, spec.in_dim
  n = 0
  for i in range(spec.depth):
    rows = (d if i == 0 else w) + (d if i in spec.skips and i else 0)
    n += rows * w + w
  heads = spec.alpha_channels + spec.norm_dim
  n += w * heads + heads
  n += w * w + w if spec.has_bottleneck else 0
  return n


def trunk_fwd_bound(spec: TrunkSpec, n: int) -> Tuple[float, str]:
  """(seconds, what bounds it) of K1f on N rows: its operations at the
  float32 peak, or feat, the weights and the five outputs moved once."""
  flops = n * trunk_flops(spec)
  nbytes = 4 * (n * spec.in_dim + trunk_weight_count(spec) + n * (
      1 + spec.norm_dim + 2 * spec.width + spec.in_dim))
  t_ops, t_bytes = flops / PEAK_F32_FLOP_PER_S, nbytes / PEAK_BYTES_PER_S
  return max(t_ops, t_bytes), 'operations' if t_ops >= t_bytes else 'bytes'


def trunk_bwd_flops(spec: TrunkSpec) -> int:
  """K1b: the forward recompute, the tangent sweep, the first-order reverse
  sweep and the two weight-grad contractions are one trunk each; the
  g-path sweep skips the input rows; then the head and the bottleneck.
  Two per multiply-add."""
  w, d = spec.width, spec.in_dim
  n_skips = len([i for i in spec.skips if i])
  trunk = d * w + (spec.depth - 1) * w * w + n_skips * d * w
  r_g = (spec.depth - 1) * w * w
  hcu = spec.alpha_channels + spec.norm_dim
  head = 2 * w * hcu + w
  bneck = 2 * w * w if spec.has_bottleneck else 0
  return 2 * (5 * trunk + r_g + head + bneck)


def trunk_bwd_bound(spec: TrunkSpec, n: int) -> Tuple[float, str]:
  """(seconds, what bounds it) of K1b on N rows: its operations at the
  float32 peak, or feat and the five cotangents in, feat̄ out, the
  weights read and their grads written, each once."""
  flops = n * trunk_bwd_flops(spec)
  cots = 1 + spec.norm_dim + (2 if spec.has_bottleneck else 1) * spec.width
  nbytes = 4 * (n * (2 * spec.in_dim + cots + spec.in_dim)
                + 2 * trunk_weight_count(spec))
  t_ops, t_bytes = flops / PEAK_F32_FLOP_PER_S, nbytes / PEAK_BYTES_PER_S
  return max(t_ops, t_bytes), 'operations' if t_ops >= t_bytes else 'bytes'


def composite_bound(r: int, s: int) -> Tuple[float, str]:
  """(seconds, what bounds it) of K2 on R rays of S samples: each input
  read once, each output written once, float32; about 12 operations a
  sample."""
  nbytes = 4 * (r * s * 3 + r * s + r * s + r * 3
                + r * 3 + r + r + 3 * r * s)
  t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, 12 * r * s / PEAK_F32_FLOP_PER_S
  return max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


# -- model FLOPs ------------------------------------------------------------------


def mlp_macs(in_dim: int, depth: int, width: int, skips: Sequence[int],
             out: int = 0) -> int:
  """Multiply-adds of one point through an MLP with input re-feed skips
  and an optional output layer."""
  macs = 0
  for i in range(depth):
    macs += ((in_dim if i == 0 else width) + (in_dim if i in skips else 0)
             ) * width
  return macs + (width if depth else in_dim) * out


def point_macs(model_cfg: Dict) -> Dict[str, int]:
  """Multiply-adds of one sample point's forward, by component."""
  c, d = model_cfg, ref.dims(model_cfg)
  w = c['nerf_trunk_width']
  macs = {
      'warp': mlp_macs(d['warp'], c['se3_trunk_depth'], c['se3_trunk_width'],
                       c['se3_skips']) + 2 * c['se3_trunk_width'] * 3,
      'hyper': mlp_macs(d['hyper'], c['hyper_sheet_depth'],
                        c['hyper_sheet_width'], c['hyper_sheet_skips'],
                        c['hyper_num_dims']),
      'trunk': mlp_macs(d['trunk'], c['nerf_trunk_depth'], w,
                        c['nerf_skips']),
      'bottleneck': w * w,
      'head': w * d['head'],
      'rgb': mlp_macs(d['rgb'], 1, c['nerf_rgb_branch_width'], (), 3),
  }
  if ref.is_nerf_ds(model_cfg):
    macs['mask'] = mlp_macs(d['mask'], c['mask_mlp_depth'],
                            c['mask_mlp_width'], c['mask_skips'], 1)
  return macs


def points_per_ray(model_cfg: Dict) -> int:
  """Points a ray evaluates: the coarse samples, then the coarse and
  importance samples together at the fine level."""
  n = model_cfg['num_coarse_samples']
  if model_cfg['num_fine_samples'] > 0:
    n += model_cfg['num_coarse_samples'] + model_cfg['num_fine_samples']
  return n


def sigma_grad_macs(model_cfg: Dict) -> int:
  """Multiply-adds of a point's ∂σ/∂feat: the σ row of the head and the
  trunk in reverse. Zero where no normal is supervised."""
  if not ref.is_nerf_ds(model_cfg):
    return 0
  macs = point_macs(model_cfg)
  return macs['trunk'] + model_cfg['nerf_trunk_width']


def train_flops_per_ray(model_cfg: Dict) -> int:
  """2 FLOPs a multiply-add of every dense layer at every point, ×3 for
  the forward and the backward; with supervised normals, the trunk's
  input-gradient pass and its backward (×3 as well). Recomputation and
  elementwise work are left out, so the count is the model's, whatever
  runs it."""
  per_point = sum(point_macs(model_cfg).values()) + sigma_grad_macs(
      model_cfg)
  return points_per_ray(model_cfg) * 3 * 2 * per_point


def render_flops_per_ray(model_cfg: Dict) -> int:
  """The forward, as a render runs it (no density gradient): 2 FLOPs a
  multiply-add at every point."""
  return points_per_ray(model_cfg) * 2 * sum(point_macs(model_cfg).values())
