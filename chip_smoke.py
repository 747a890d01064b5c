#!/usr/bin/env python3
"""Drives the PyTorch port (``nerfds_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

1. Prints the card (``nvidia-smi``), fails without CUDA, and builds the
   hand-written kernels from ``nerfds_torch/kernels/csrc``.
2. K2, compositing forward: kernel against its plain PyTorch version.
3. K1f, trunk forward with ∂σ/∂feat: kernel against its plain version.
4. Renders a 128x128 image with the full-width ``nerf_ds()`` model through
   both kernels (launch counts checked), then again on the plain path, and
   compares the two.
5. Prints one JSON line describing every kernel, the card's line, and as the
   last line ``{"ok": true, "device": {...}}``.

TF32 is switched off for matmuls and convolutions, so every plain version
runs in full float32 like the kernels. Exits nonzero at the first failure.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

# Peak rates of one H100 SXM at its 700 W limit (NVIDIA data sheet).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12


def card_line() -> str:
  try:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, timeout=60)
  except (OSError, subprocess.TimeoutExpired) as e:
    return f'nvidia-smi unavailable: {e}'
  return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
      f'nvidia-smi failed: {out.stderr.strip()}')


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
  """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / iters


def compare(torch, name, got, want, atol, rtol, max_bad_frac=0.0):
  """Max abs error of ``got`` against ``want``; raises if more than
  ``max_bad_frac`` of the elements exceed ``atol + rtol * |want|``."""
  if got is None and want is None:
    return 0.0
  if tuple(got.shape) != tuple(want.shape):
    raise AssertionError(f'{name}: shape {tuple(got.shape)} != '
                         f'{tuple(want.shape)}')
  if not bool(torch.isfinite(got).all()):
    raise AssertionError(f'{name}: non-finite values')
  err = (got - want).abs()
  bad = (err > atol + rtol * want.abs()).float().mean().item()
  max_err = err.max().item() if err.numel() else 0.0
  print(f'  {name}: max_abs_err {max_err:.3e}, beyond tolerance '
        f'{bad:.2e} (allowed {max_bad_frac:.0e})')
  if bad > max_bad_frac:
    raise AssertionError(f'{name}: {bad:.2e} of elements beyond atol {atol} '
                         f'rtol {rtol}')
  return max_err


def composite_inputs(torch, num_rays, num_samples, gen, device):
  rgb = torch.rand(num_rays, num_samples, 3, generator=gen, device=device)
  sigma = torch.rand(num_rays, num_samples, generator=gen, device=device) * 3
  z = torch.sort(torch.rand(num_rays, num_samples, generator=gen,
                            device=device) * 1.8 + 0.2, dim=-1).values
  dirs = torch.randn(num_rays, 3, generator=gen, device=device)
  return rgb, sigma, z, dirs


def phase_composite(torch, device):
  """K2 at the chunk shapes of the render path and at R=8192."""
  from nerfds_torch.kernels import composite
  print('== K2 composite_fwd vs plain version')
  gen = torch.Generator(device=device).manual_seed(0)
  names = ('rgb', 'depth', 'acc_all', 'weights', 'alpha', 'accum')
  # Tolerance: float32; the kernel's sequential running product and sums
  # associate differently from torch.cumprod / torch.sum.
  atol, rtol = 1e-5, 1e-4
  max_err, main = 0.0, None
  for num_rays in (4096, 8192):
    for num_samples in (64, 128):
      args = composite_inputs(torch, num_rays, num_samples, gen, device)
      for at_inf in (True, False):
        got = composite.composite_forward(*args, at_inf)
        want = composite.composite_reference(*args, at_inf)
        torch.cuda.synchronize()
        print(f' R={num_rays} S={num_samples} sample_at_infinity={at_inf}')
        for n, g, w in zip(names, got, want):
          max_err = max(max_err, compare(torch, n, g, w, atol, rtol))
      ms = time_ms(torch, lambda: composite.composite_forward(*args), 20)
      plain_ms = time_ms(
          torch, lambda: composite.composite_reference(*args), 20)
      print(f'  time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms')
      if (num_rays, num_samples) == (4096, 128):
        r, s = num_rays, num_samples
        # Each input read once, each output written once, float32.
        nbytes = 4 * (r * s * 3 + r * s + r * s + r * 3
                      + r * 3 + r + r + 3 * r * s)
        flops = 12 * r * s
        bound_ms = 1e3 * max(nbytes / PEAK_BYTES_PER_S,
                             flops / PEAK_F32_FLOP_PER_S)
        main = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by='bytes' if nbytes / PEAK_BYTES_PER_S
                    >= flops / PEAK_F32_FLOP_PER_S else 'operations')
  return dict(name='composite_fwd', route='cuda',
              source='nerfds_torch/kernels/csrc/composite.cu',
              replaces='nerfds_tpu/pallas/composite.py:49',
              max_abs_err=max_err, library_ms=None, **main)


def nerf_ds_trunk(torch, device, seed):
  """The full nerf_ds NeRF trunk (8x256, skip at 4, 52 input channels, a
  σ + normal head and a bottleneck) with glorot-initialised weights."""
  from nerfds_torch import config as config_lib
  from nerfds_torch.kernels import fused_trunk
  from nerfds_torch.models.mlp import NerfMLP
  cfg = config_lib.nerf_ds()
  gen = torch.Generator().manual_seed(seed)
  in_dim = 52
  mlp = NerfMLP(in_dim=in_dim, alpha_cond_dim=0, rgb_cond_dim=0,
                has_condition=True, trunk_depth=cfg.nerf_trunk_depth,
                trunk_width=cfg.nerf_trunk_width, skips=cfg.nerf_skips,
                predict_norm=True, generator=gen).to(device)
  spec = fused_trunk.TrunkSpec(
      depth=cfg.nerf_trunk_depth, width=cfg.nerf_trunk_width,
      skips=tuple(cfg.nerf_skips), in_dim=in_dim, alpha_channels=1,
      norm_dim=3, has_bottleneck=True)
  return spec, mlp.trunk_weights()


def trunk_flops(spec) -> int:
  """Multiply-adds of one row, forward and reverse sweep, times two."""
  w, d = spec.width, spec.in_dim
  fwd = d * w + (spec.depth - 1) * w * w + len(
      [i for i in spec.skips if i]) * d * w
  fwd += w * (spec.alpha_channels + spec.norm_dim)
  fwd += w * w if spec.has_bottleneck else 0
  rev = (spec.depth - 1) * w * w + d * w * (1 + len(
      [i for i in spec.skips if i]))
  return 2 * (fwd + rev)


def phase_fused_trunk(torch, device):
  from nerfds_torch.kernels import fused_trunk
  print('== K1f fused_trunk_fwd vs plain version')
  spec, weights = nerf_ds_trunk(torch, device, seed=1)
  names = ('sigma', 'normal', 'trunk_out', 'bottleneck', 'g')
  max_err, main = 0.0, None
  with torch.no_grad():
    # The coarse and fine shapes of a 4096-ray chunk, R=8192 fine, and a
    # ragged count (the last 32-row tile is partial).
    for n in (4096 * 64, 4096 * 128, 8192 * 128, 4099):
      gen = torch.Generator(device=device).manual_seed(n)
      feat = torch.rand(n, spec.in_dim, generator=gen, device=device) * 2 - 1
      got = fused_trunk.trunk_sigma_grad(feat, weights, spec)
      want = fused_trunk.trunk_sigma_grad_reference(feat, weights, spec)
      torch.cuda.synchronize()
      print(f' N={n}')
      for name, g, w in zip(names, got, want):
        # Tolerance: float32 sums over 256 channels in another order than
        # cuBLAS. g also follows the relu masks: where a pre-activation is
        # within rounding of 0 the two versions may take the other side of
        # the kink, which moves that row's g, so up to 1e-3 of g's elements
        # may exceed the tolerance (measured on an H100: 5.4e-5 to 6.0e-5
        # at 0.5M to 1M rows).
        bad_frac = 1e-3 if name == 'g' else 0.0
        max_err = max(max_err, compare(torch, name, g, w, 1e-4, 1e-4,
                                       bad_frac))
      del got, want
      ms = time_ms(torch, lambda: fused_trunk.trunk_sigma_grad(
          feat, weights, spec), 3, warmup=1)
      plain_ms = time_ms(torch, lambda: fused_trunk.trunk_sigma_grad_reference(
          feat, weights, spec), 3, warmup=1)
      print(f'  time: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms')
      if n == 4096 * 128:
        flops = n * trunk_flops(spec)
        n_weights = sum(w.numel() + b.numel() for w, b in weights.layers) + \
            sum(t.numel() for t in (*weights.head, *weights.bottleneck))
        nbytes = 4 * (n * spec.in_dim + n_weights + n * (
            1 + spec.norm_dim + 2 * spec.width + spec.in_dim))
        t_ops = flops / PEAK_F32_FLOP_PER_S
        t_bytes = nbytes / PEAK_BYTES_PER_S
        main = dict(ms=ms, plain_ms=plain_ms,
                    bound_ms=1e3 * max(t_ops, t_bytes),
                    bound_by='operations' if t_ops >= t_bytes else 'bytes')
        print(f'  {flops / 1e12:.3f} TFLOP, {nbytes / 1e6:.1f} MB at N={n}')
      del feat
  return dict(name='fused_trunk_fwd', route='cuda',
              source='nerfds_torch/kernels/csrc/fused_trunk_fwd.cu',
              replaces='nerfds_tpu/pallas/fused_trunk.py:252',
              max_abs_err=max_err, library_ms=None, **main)


def pinhole_rays(size: int, num_embeds: int):
  """An image of pinhole rays from the origin looking down +z, made with
  numpy, with one warp id for the whole image."""
  import numpy as np
  ys, xs = np.meshgrid(np.arange(size, dtype=np.float32),
                       np.arange(size, dtype=np.float32), indexing='ij')
  focal = float(size)
  dirs = np.stack([(xs + 0.5 - size / 2) / focal,
                   (ys + 0.5 - size / 2) / focal,
                   np.ones_like(xs)], -1)
  return {
      'origins': np.zeros_like(dirs),
      'directions': dirs,
      'metadata': {'warp': np.full((size, size, 1), num_embeds // 2,
                                   np.int32)},
  }


def phase_render(torch, device, kernel_names, size=128, chunk=4096):
  """The main path: full-width nerf_ds rendered through both kernels."""
  import dataclasses
  import numpy as np
  from nerfds_torch import config as config_lib
  from nerfds_torch import kernels
  from nerfds_torch.evaluation import render as render_lib
  from nerfds_torch.models import NerfDSModel, default_extra_params
  print(f'== render: nerf_ds() at full width, {size}x{size}, chunk {chunk}')
  num_embeds = 8
  cfg = dataclasses.replace(config_lib.nerf_ds(), use_pallas_compositing=True,
                            sigma_gradient_mode='fused')
  plain_cfg = dataclasses.replace(cfg, use_pallas_compositing=False,
                                  sigma_gradient_mode='vmap')
  model = NerfDSModel(cfg, num_warp_embeds=num_embeds,
                      generator=torch.Generator().manual_seed(0),
                      device=device)
  plain = NerfDSModel(plain_cfg, num_warp_embeds=num_embeds, device=device)
  plain.load_state_dict(model.state_dict())
  extra = default_extra_params(cfg)
  rays = pinhole_rays(size, num_embeds)
  gen = lambda: torch.Generator(device=device).manual_seed(0)

  # One chunk through model.render both ways: the per-sample target_norm,
  # which render_image's keys leave out. This also warms both paths up.
  one = {k: torch.from_numpy(v.reshape(-1, v.shape[-1])[:chunk]).to(device)
         for k, v in rays.items() if k != 'metadata'}
  one['metadata'] = {'warp': torch.full((chunk, 1), num_embeds // 2,
                                        device=device)}
  one['mask'] = torch.zeros(chunk, 1, device=device)
  with torch.no_grad():
    k_out = model.render(one, extra, generator=gen(),
                         compute_sigma_gradient=True)
    p_out = plain.render(one, extra, generator=gen(),
                         compute_sigma_gradient=True)
  torch.cuda.synchronize()
  max_err = {}
  for level in ('coarse', 'fine'):
    # Tolerance: float32; normalize(∇σ) amplifies rounding where |∇σ| is
    # small, and a relu pre-activation within rounding of 0 may fall on
    # the other side of the kink in the kernel than in cuBLAS, which turns
    # that point's ∇σ. Each point crosses 2048 trunk units, so up to 5e-3
    # of the elements may exceed the tolerance (measured on an H100:
    # 1.7e-4 coarse, 7.9e-4 fine).
    max_err[f'{level}/target_norm'] = compare(
        torch, f'{level}/target_norm', k_out[level]['target_norm'],
        p_out[level]['target_norm'], 1e-3, 1e-3, max_bad_frac=5e-3)
    max_err[f'{level}/predicted_norm'] = compare(
        torch, f'{level}/predicted_norm', k_out[level]['predicted_norm'],
        p_out[level]['predicted_norm'], 1e-4, 1e-4)
  del k_out, p_out

  render_fn = render_lib.make_render_fn(model, compute_sigma_gradient=True)
  plain_fn = render_lib.make_render_fn(plain, compute_sigma_gradient=True)
  num_chunks = -(-size * size // chunk)
  torch.cuda.reset_peak_memory_stats()
  kernels.reset_launch_counts()
  start = time.perf_counter()
  out = render_lib.render_image(model, rays, extra, generator=gen(),
                                chunk=chunk, render_fn=render_fn)
  torch.cuda.synchronize()
  seconds = time.perf_counter() - start
  launches = dict(kernels.launch_counts)
  peak = torch.cuda.max_memory_allocated() / 2**30
  print(f'  kernel path: {seconds:.3f} s, {size * size / seconds:.0f} rays/s,'
        f' peak {peak:.2f} GiB, launches {launches}')
  for name in kernel_names:
    if launches[name] != 2 * num_chunks:
      raise AssertionError(f'{name} launched {launches[name]} times, want '
                           f'2 per chunk x {num_chunks} chunks')
  want_shapes = {'rgb': (3,), 'depth': (), 'med_depth': (), 'acc': (),
                 'ray_norm': (3,), 'ray_delta_x': (3,),
                 'ray_hyper_points': (2,), 'ray_predicted_mask': (1,),
                 'med_points': (1, 5), 'ray_rotation_field': (3,),
                 'ray_translation_field': (3,)}
  for k, tail in want_shapes.items():
    if out[k].shape != (size, size, *tail):
      raise AssertionError(f'{k}: shape {out[k].shape}')
    if not np.isfinite(out[k]).all():
      raise AssertionError(f'{k}: non-finite values')

  start = time.perf_counter()
  ref = render_lib.render_image(plain, rays, extra, generator=gen(),
                                chunk=chunk, render_fn=plain_fn)
  torch.cuda.synchronize()
  plain_seconds = time.perf_counter() - start
  print(f'  plain path: {plain_seconds:.3f} s, '
        f'{size * size / plain_seconds:.0f} rays/s')
  # Tolerance: float32 throughout; the kernels sum in another order than
  # cuBLAS and torch.cumprod, and the fine samples follow the coarse weights.
  for k in ('rgb', 'depth', 'acc'):
    max_err[k] = compare(torch, k, torch.from_numpy(out[k]),
                         torch.from_numpy(ref[k]), 1e-4, 1e-4)
  print(f'  rgb mean {out["rgb"].mean():.4f}, depth range '
        f'[{out["depth"].min():.3f}, {out["depth"].max():.3f}]')
  return launches


def main() -> int:
  import torch
  line = card_line()
  print(f'card: {line}')
  if not torch.cuda.is_available():
    print('chip_smoke: CUDA is not available', file=sys.stderr)
    return 1
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  device = torch.device('cuda')
  print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'{torch.cuda.get_device_name(0)}')

  from nerfds_torch.kernels import build
  start = time.perf_counter()
  build.load_library()
  print(f'== build: {time.perf_counter() - start:.1f} s')
  for text in build.build_report().splitlines():
    if any(s in text for s in ('entry function', 'registers', 'spill')):
      print(f'  ptxas: {text.strip()}')

  results = [phase_composite(torch, device), phase_fused_trunk(torch, device)]
  launches = phase_render(torch, device, [r['name'] for r in results])
  for r in results:
    r['launches'] = launches[r['name']]
  print(json.dumps({'kernels': results}))
  print(f'card: {card_line()}')
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
