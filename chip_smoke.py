#!/usr/bin/env python3
"""Drives the PyTorch port (``nerfds_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

1. Prints the card (``nvidia-smi``), fails without CUDA, and builds the
   hand-written kernels from ``nerfds_torch/kernels/csrc``.
2. K2, compositing forward: kernel against its plain PyTorch version, at
   the render and the training shapes.
3. K1f, trunk forward with ∂σ/∂feat: kernel against its plain version, at
   the render and the training shapes, each timed as a share of its bound.
4. Renders a 128x128 image with the full-width ``nerf_ds()`` model through
   K1f and K2 (launch counts checked), then again on the plain path, and
   compares the two.
5. K1b, the trunk's hand-derived backward: kernel against its plain version
   at the training shapes and a ragged N; two launches must give the same
   bits; timed at both training shapes, split into the sweep, the weight
   grads and their reduction by the profiler.
6. K3, the whole-MLP forward: kernel against its plain version at every
   ``nerf_ds()`` MLP shape (the NeRF trunk also at a render chunk's sample
   rows), a ragged N, N = 0, each activation and bf16 compute.
7. Trains the full-width ``nerf_ds()`` on the synthetic scene for 24 steps
   at batch 512 through ``Trainer.train`` (K1f, K1b and K2 twice a step,
   checked), compares the kernel path's gradients with the plain path's,
   and times and profiles steady steps of both paths, counting the host's
   waits on the card in one step of each.
8. The held-out evaluation path at full width: the train CLI with an
   experiment directory, resumed from its checkpoint, then the eval CLI
   (K2 on every eval chunk, K1f never); ``eval_psnr`` of the restored state
   on the kernel and plain paths; K3 through ``fused_apply`` on every MLP
   of the restored model, fed what each received in one render chunk.
9. Prints one JSON line describing every kernel ("launches": the render's
   count for K1f and K2, the training run's for K1b, the eval path's for
   K3; "launches_render" and "launches_train" for all four), a line of the
   training numbers, a line of the eval numbers, the card's line, and as
   the last line ``{"ok": true, "device": {...}}``.

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
# The training run: rays a batch (nerf_ds_train_config's), steps through
# Trainer.train, and steady steps timed per turn on each path.
TRAIN_BATCH = 512
TRAIN_STEPS = 24
TRAIN_TIMED_STEPS = 6
# K1b's check: the coarse and fine rows of a training batch (64 + 64
# samples a ray) and a ragged N.
K1B_SIZES = (TRAIN_BATCH * 64, TRAIN_BATCH * 128, 4099)
# K1f's main-path shapes: the coarse and fine rows of a 4096-ray render
# chunk and of a training batch.
K1F_MAIN_SIZES = (4096 * 64, 4096 * 128, TRAIN_BATCH * 64, TRAIN_BATCH * 128)
# K3's check: the render chunk's sample rows (4096 rays x 128 samples), a
# ragged N (the last 32-row tile is partial) and none.
K3_SIZES = (4096 * 128, 4099, 0)
# The eval phase: the train CLI's first run and the step its second resumes
# to.
EVAL_STEPS = (24, 30)


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
  bad = ((err > atol + rtol * want.abs()).float().mean().item()
         if err.numel() else 0.0)
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


def composite_bound(r: int, s: int):
  """(ms, what bounds it) of K2 on R rays of S samples: each input read
  once, each output written once, float32; about 12 operations a sample."""
  nbytes = 4 * (r * s * 3 + r * s + r * s + r * 3
                + r * 3 + r + r + 3 * r * s)
  t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, 12 * r * s / PEAK_F32_FLOP_PER_S
  return 1e3 * max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else \
      'operations'


def phase_composite(torch, device):
  """K2 at the chunk shapes of the render path and at R=8192."""
  from nerfds_torch.kernels import composite
  print('== K2 composite_fwd vs plain version')
  gen = torch.Generator(device=device).manual_seed(0)
  names = ('rgb', 'depth', 'acc_all', 'weights', 'alpha', 'accum')
  # Tolerance: float32; the kernel's sequential running product and sums
  # associate differently from torch.cumprod / torch.sum.
  atol, rtol = 1e-5, 1e-4
  max_err, main, train = 0.0, None, {}
  # The render chunk (4096 rays) and R=8192, and a 512-ray training batch.
  for num_rays in (4096, 8192, 512):
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
      if num_rays == 512:
        train[f'train_ms_s{num_samples}'] = ms
        train[f'train_plain_ms_s{num_samples}'] = plain_ms
        train[f'train_bound_ms_s{num_samples}'] = composite_bound(
            num_rays, num_samples)[0]
      if (num_rays, num_samples) == (4096, 128):
        bound_ms, bound_by = composite_bound(num_rays, num_samples)
        main = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by)
  return dict(name='composite_fwd', route='cuda',
              source='nerfds_torch/kernels/csrc/composite.cu',
              replaces='nerfds_tpu/pallas/composite.py:49',
              max_abs_err=max_err, library_ms=None, **main, **train)


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


def trunk_fwd_bound(spec, weights, n: int):
  """(ms, what bounds it) of K1f on N rows: its operations at f32 peak, or
  feat, the weights and the five outputs moved once."""
  flops = n * trunk_flops(spec)
  n_weights = sum(w.numel() + b.numel() for w, b in weights.layers) + \
      sum(t.numel() for t in (*weights.head, *weights.bottleneck))
  nbytes = 4 * (n * spec.in_dim + n_weights + n * (
      1 + spec.norm_dim + 2 * spec.width + spec.in_dim))
  t_ops, t_bytes = flops / PEAK_F32_FLOP_PER_S, nbytes / PEAK_BYTES_PER_S
  print(f'  K1f bound at N={n}: {flops / 1e12:.4f} TFLOP, '
        f'{nbytes / 1e6:.1f} MB, {1e3 * max(t_ops, t_bytes):.3f} ms')
  return 1e3 * max(t_ops, t_bytes), 'operations' if t_ops >= t_bytes else \
      'bytes'


def mlp_forward_bound(layers, n: int):
  """(TFLOP, ms, what bounds it) of K3 on N rows of an MLP given as its
  ``[(W, b), ...]``: its multiply-adds (W's rows times columns a layer) at
  f32 peak, or the input, the weights and the output moved once."""
  macs = sum(w.shape[0] * w.shape[1] for w, _ in layers)
  flops = 2 * n * macs
  n_weights = sum(w.numel() + b.numel() for w, b in layers)
  in_dim = layers[0][0].shape[0]  # without a skip at layer 0
  nbytes = 4 * (n * (in_dim + layers[-1][0].shape[1]) + n_weights)
  t_ops, t_bytes = flops / PEAK_F32_FLOP_PER_S, nbytes / PEAK_BYTES_PER_S
  return flops / 1e12, 1e3 * max(t_ops, t_bytes), (
      'operations' if t_ops >= t_bytes else 'bytes')


def nerf_ds_mlps(torch, device, seed):
  """Every MLP stack of the full-width nerf_ds() model (the mask MLP, the
  SE(3) trunk, the hyper sheet, and the NeRF trunk, σ/normal head and rgb
  branch of one level), every layer glorot-initialised so that no output
  sits near 0 by its head's tiny init."""
  from nerfds_torch import config as config_lib
  from nerfds_torch.models import NerfDSModel
  from nerfds_torch.models.mlp import MLP, glorot_uniform
  gen = torch.Generator().manual_seed(seed)
  model = NerfDSModel(config_lib.nerf_ds(), num_warp_embeds=8,
                      generator=gen, device='cpu')
  mlps = {name: m for name, m in model.named_modules()
          if isinstance(m, MLP) and not name.startswith('nerf.fine')}
  for m in mlps.values():
    for p in m.parameters():
      if p.dim() == 2:
        glorot_uniform(p, gen)
      else:
        with torch.no_grad():
          p.uniform_(-0.1, 0.1, generator=gen)
  return {name: m.to(device) for name, m in mlps.items()}


def phase_fused_mlp(torch, device):
  """K3 against its plain version at every nerf_ds() MLP shape (the NeRF
  trunk also at the render chunk's sample rows), a ragged N and N = 0,
  each activation, and bf16 compute."""
  from nerfds_torch.kernels import fused_mlp
  from nerfds_torch.models.mlp import MLP
  print('== K3 fused_mlp_fwd vs plain version')
  mlps = nerf_ds_mlps(torch, device, seed=3)
  # Five small stacks with each activation, hidden and output.
  for act in ('relu', 'sigmoid', 'softplus', 'tanh', None):
    gen = torch.Generator().manual_seed(4)
    mlps[f'act={act}'] = MLP(52, 3, 128, (2,), act or 'none',
                             output_channels=3, output_activation=act,
                             generator=gen).to(device)
  max_err, main = 0.0, None
  with torch.no_grad():
    for name, mlp in mlps.items():
      layers, has_out = fused_mlp.mlp_params_to_layers(mlp, None)
      sizes = K3_SIZES if name == 'nerf.coarse.trunk' else K3_SIZES[1:]
      for n in sizes:
        gen = torch.Generator(device=device).manual_seed(n + 5)
        x = torch.rand(n, mlp.in_dim, generator=gen, device=device) * 2 - 1
        got = fused_mlp.fused_apply(mlp, None, x)
        want = fused_mlp.fused_mlp_reference(
            x, layers, mlp.skips, mlp.hidden_activation,
            mlp.output_activation, has_out)
        torch.cuda.synchronize()
        print(f' {name} ({mlp.depth}x{mlp.width}, skips {mlp.skips}, '
              f'{mlp.in_dim} in, {tuple(got.shape)[1]} out) N={n}')
        # Tolerance: float32 sums in another order than cuBLAS (as the
        # JAX package's own test of this kernel, 1e-5). Where a relu
        # pre-activation lies within rounding of 0 the two versions may
        # take the other side of the kink, as in K1f's check: up to 1e-3
        # of the elements of a relu stack may exceed the tolerance.
        relu = 'relu' in (mlp.hidden_activation, mlp.output_activation)
        max_err = max(max_err, compare(torch, 'out', got, want, 1e-5, 1e-5,
                                       1e-3 if relu else 0.0))
        if n == K3_SIZES[0]:
          ms = time_ms(torch, lambda: fused_mlp.fused_apply(mlp, None, x),
                       5, warmup=1)
          plain_ms = time_ms(torch, lambda: fused_mlp.fused_mlp_reference(
              x, layers, mlp.skips, mlp.hidden_activation,
              mlp.output_activation, has_out), 5, warmup=1)
          tflop, bound_ms, bound_by = mlp_forward_bound(layers, n)
          main = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by)
          print(f'  time: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound '
                f'{bound_ms:.3f} ms ({tflop:.4f} TFLOP, {bound_by})')
        del x, got, want
    # bf16 compute. Tolerance: bf16 keeps 8 significant bits. The kernel's
    # f32 sums differ from cuBLAS's in the last bits, so a sum that lies
    # near a bf16 rounding boundary rounds the other way (one bf16 ulp,
    # 2^-8 to 2^-7 of the value) and the later layers carry the flip on:
    # 2^-6 of each element and of the output's largest magnitude is 2 to 4
    # ulps (measured on the CPU with float64 against float32 sums: at most
    # 2^-8 of the largest magnitude).
    for name in ('nerf.coarse.trunk', 'nerf.coarse.rgb', 'mask_mlp.mlp',
                 'act=sigmoid', 'act=softplus'):
      mlp = mlps[name]
      layers, has_out = fused_mlp.mlp_params_to_layers(mlp, None)
      gen = torch.Generator(device=device).manual_seed(6)
      x = torch.rand(4099, mlp.in_dim, generator=gen, device=device) * 2 - 1
      got = fused_mlp.fused_apply(mlp, None, x, compute_dtype=torch.bfloat16)
      want = fused_mlp.fused_mlp_reference(
          x, layers, mlp.skips, mlp.hidden_activation, mlp.output_activation,
          has_out, compute_dtype=torch.bfloat16)
      torch.cuda.synchronize()
      print(f' {name} bf16 compute, N=4099')
      scale = want.abs().max().item()
      compare(torch, 'out', got, want, 2 ** -6 * scale, 2 ** -6)
  return dict(name='fused_mlp_fwd', route='cuda',
              source='nerfds_torch/kernels/csrc/fused_mlp_fwd.cu',
              replaces='nerfds_tpu/pallas/fused_mlp.py:48',
              max_abs_err=max_err, library_ms=None, **main)


def phase_fused_trunk(torch, device):
  from nerfds_torch.kernels import fused_trunk
  print('== K1f fused_trunk_fwd vs plain version')
  spec, weights = nerf_ds_trunk(torch, device, seed=1)
  names = ('sigma', 'normal', 'trunk_out', 'bottleneck', 'g')
  max_err, main, train = 0.0, None, {}
  with torch.no_grad():
    # The coarse and fine shapes of a 4096-ray render chunk, R=8192 fine,
    # those of a 512-ray training batch, and a ragged count (the last
    # 64-row tile is partial).
    for n in (4096 * 64, 4096 * 128, 8192 * 128, 512 * 64, 512 * 128, 4099):
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
      bound_ms, bound_by = trunk_fwd_bound(spec, weights, n)
      print(f'  time: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound '
            f'{bound_ms:.3f} ms: {bound_ms / ms:.1%} of the bound')
      if n in K1F_MAIN_SIZES and n != 4096 * 128:
        train[f'ms_n{n}'] = ms
        train[f'plain_ms_n{n}'] = plain_ms
        train[f'bound_ms_n{n}'] = bound_ms
      if n == 4096 * 128:
        main = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by)
      del feat
  return dict(name='fused_trunk_fwd', route='cuda',
              source='nerfds_torch/kernels/csrc/fused_trunk_fwd.cu',
              replaces='nerfds_tpu/pallas/fused_trunk.py:252',
              max_abs_err=max_err, library_ms=None, **main, **train)


def trunk_bwd_flops(spec) -> int:
  """Operations of one row of K1b, counted from _bwd_kernel: the forward
  recompute, the tangent sweep, the first-order reverse sweep and the two
  weight-grad contractions are one trunk each; the g-path sweep skips the
  input rows; then the head and the bottleneck. Two per multiply-add."""
  w, d = spec.width, spec.in_dim
  n_skips = len([i for i in spec.skips if i])
  trunk = d * w + (spec.depth - 1) * w * w + n_skips * d * w
  r_g = (spec.depth - 1) * w * w
  hcu = spec.alpha_channels + spec.norm_dim
  head = 2 * w * hcu + w
  bneck = 2 * w * w if spec.has_bottleneck else 0
  return 2 * (5 * trunk + r_g + head + bneck)


def trunk_bwd_bound(spec, weights, n: int):
  """(ms, what bounds it, TFLOP, MB) of K1b on N rows: its operations at
  f32 peak, or its inputs and outputs moved once (feat and the five
  cotangents in, feat_bar out, the weights read and their grads
  written)."""
  flops = n * trunk_bwd_flops(spec)
  n_weights = sum(w.numel() + b.numel() for w, b in weights.layers) + \
      sum(t.numel() for t in (*weights.head, *weights.bottleneck))
  nbytes = 4 * (n * (2 * spec.in_dim + 1 + spec.norm_dim + 2 * spec.width
                     + spec.in_dim) + 2 * n_weights)
  t_ops, t_bytes = flops / PEAK_F32_FLOP_PER_S, nbytes / PEAK_BYTES_PER_S
  return (1e3 * max(t_ops, t_bytes),
          'operations' if t_ops >= t_bytes else 'bytes', flops / 1e12,
          nbytes / 1e6)


def phase_fused_trunk_bwd(torch, device):
  """K1b against its plain version at the training shapes (coarse and fine
  rows of a 512-ray batch) and a ragged N; two launches must agree bit for
  bit."""
  from nerfds_torch.kernels import fused_trunk
  print('== K1b fused_trunk_bwd vs plain version')
  spec, weights = nerf_ds_trunk(torch, device, seed=2)
  tile_rows = fused_trunk.KERNEL_TILE_ROWS
  flat_names = [f'{k}{i}' for i in range(spec.depth) for k in ('dW', 'db')]
  flat_names += ['bottleneck_dW', 'bottleneck_db', 'head_dW', 'head_db']
  max_err, main, train = 0.0, None, {}
  with torch.no_grad():
    for n in K1B_SIZES:
      gen = torch.Generator(device=device).manual_seed(n + 1)
      feat = torch.rand(n, spec.in_dim, generator=gen, device=device) * 2 - 1
      cots = tuple(torch.randn(n, c, generator=gen, device=device)
                   for c in (1, spec.norm_dim, spec.width, spec.width,
                             spec.in_dim))
      got_x, got_w = fused_trunk.trunk_sigma_grad_backward(
          feat, weights, spec, cots)
      again_x, again_w = fused_trunk.trunk_sigma_grad_backward(
          feat, weights, spec, cots)
      want_x, want_w = fused_trunk.trunk_sigma_grad_backward_reference(
          feat, weights, spec, cots)
      torch.cuda.synchronize()
      got = [got_x, *fused_trunk._flatten(got_w)]
      again = [again_x, *fused_trunk._flatten(again_w)]
      same = all(torch.equal(a, b) for a, b in zip(got, again))
      print(f' N={n}: repeat launch bit-identical: {same}')
      if not same:
        raise AssertionError('K1b: two launches on the same inputs differ')
      # Rows at relu kinks: each feat_bar row beyond tolerance must be
      # proven by fused_trunk.kink_flip, at most 1e-3 of N
      # (fused_trunk.check_kink_rows); here also none at a ragged N and
      # none in the last block of the sweep (KERNEL_TILE_ROWS rows). With
      # their cotangents zeroed they add nothing to any output, and then
      # everything must agree tightly.
      err = (got_x - want_x).abs()
      bad, rows, flips = fused_trunk.check_kink_rows(feat, weights, spec,
                                                     cots, got_x, want_x)
      last_block = (n - 1) // tile_rows * tile_rows
      print(f'  feat_bar: max_abs_err {err.max().item():.3e}; rows beyond '
            f'tolerance {len(rows)} of {n}: {rows[:12]}; |a| of the relu '
            f'flipped there: {flips[:12]}')
      max_err = max(max_err, err.max().item())
      if (rows and n % tile_rows) or any(r >= last_block for r in rows):
        raise AssertionError(f'K1b feat_bar: rows {rows} beyond tolerance')
      rel_all = [((g - w).norm() / w.norm().clamp_min(1e-30)).item()
                 for g, w in zip(got[1:], fused_trunk._flatten(want_w))]
      print(f'  worst grad |got - want| / |want| with those rows: '
            f'{max(rel_all):.3e}')
      keep = (~bad).float()[:, None]
      cots = tuple(c * keep for c in cots)
      got_x, got_w = fused_trunk.trunk_sigma_grad_backward(
          feat, weights, spec, cots)
      want_x, want_w = fused_trunk.trunk_sigma_grad_backward_reference(
          feat, weights, spec, cots)
      got = [got_x, *fused_trunk._flatten(got_w)]
      want = [want_x, *fused_trunk._flatten(want_w)]
      worst = 0.0
      for name, g, w in zip(['feat_bar', *flat_names], got, want):
        if not bool(torch.isfinite(g).all()):
          raise AssertionError(f'K1b {name}: non-finite values')
        rel = ((g - w).norm() / w.norm().clamp_min(1e-30)).item()
        worst = max(worst, rel)
        max_err = max(max_err, (g - w).abs().max().item())
        # Tolerance relative to the tensor's norm: float32 sums over N rows
        # in another order than cuBLAS.
        if rel > 1e-5:
          raise AssertionError(f'K1b {name}: |got - want| / |want| = '
                               f'{rel:.2e} > 1e-5 without the kink rows')
      print(f'  without them, worst |got - want| / |want| over feat_bar '
            f'and {len(flat_names)} grads: {worst:.3e}')
      del got, again, want, got_w, again_w, want_w, err, bad
      if n in (TRAIN_BATCH * 64, TRAIN_BATCH * 128):  # coarse, fine rows
        ms = time_ms(torch, lambda: fused_trunk.trunk_sigma_grad_backward(
            feat, weights, spec, cots), 3, warmup=1)
        plain_ms = time_ms(
            torch, lambda: fused_trunk.trunk_sigma_grad_backward_reference(
                feat, weights, spec, cots), 3, warmup=1)
        bound_ms, bound_by, tflop, mbytes = trunk_bwd_bound(spec, weights, n)
        print(f'  time: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound '
              f'{bound_ms:.3f} ms ({tflop:.4f} TFLOP, {mbytes:.1f} MB): '
              f'{bound_ms / ms:.1%} of the bound')
        parts = profile_device(
            torch, lambda: fused_trunk.trunk_sigma_grad_backward(
                feat, weights, spec, cots), f'K1b at N={n}', top=4)
        split = bwd_kernel_split(parts)
        print(f'  K1b at N={n} by kernel: sweep {split["sweep_ms"]:.3f} ms, '
              f'weight grads {split["wgrad_ms"]:.3f} ms, reduction '
              f'{split["reduce_ms"]:.3f} ms')
        if n == TRAIN_BATCH * 128:  # the fine level's rows
          main = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by, **split)
        else:
          train.update({f'{k}_n{n}': v for k, v in dict(
              ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, **split).items()})
      del feat, cots
  return dict(name='fused_trunk_bwd', route='cuda',
              source='nerfds_torch/kernels/csrc/fused_trunk_bwd.cu',
              replaces='nerfds_tpu/pallas/fused_trunk.py:295',
              max_abs_err=max_err, library_ms=None, **main, **train)


def bwd_kernel_split(parts):
  """K1b's device time a call by its kernels: the sweep, the weight-grad
  products and the reduction of their partials."""
  pick = lambda key: sum(ms for name, ms in parts.items() if key in name)
  return dict(sweep_ms=pick('trunk_bwd_sweep'), wgrad_ms=pick('wgrad_kernel'),
              reduce_ms=pick('wgrad_reduce'))


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


def phase_train(torch, device):
  """The slice's main path: the full-width nerf_ds() trained through
  Trainer.from_experiment(...).train() on the synthetic scene, with
  'fused' ∇σ (K1f forward, K1b backward) and kernel compositing (K2).
  Then, from one state and one batch, the gradients of the kernel path
  against the plain path ('vmap', plain compositing), and steady step
  times of both paths in turns."""
  import dataclasses
  import numpy as np
  from nerfds_torch import config as config_lib
  from nerfds_torch import kernels
  from nerfds_torch.datasets import SyntheticDataSource, sample_batch
  from nerfds_torch.models import NerfDSModel
  from nerfds_torch.trainer import Trainer
  from nerfds_torch.training import step as step_lib
  steps, batch_size = TRAIN_STEPS, TRAIN_BATCH
  print(f'== train: nerf_ds() at full width, batch {batch_size}, {steps} '
        'steps')
  cfg = dataclasses.replace(config_lib.nerf_ds(), use_pallas_compositing=True,
                            sigma_gradient_mode='fused')
  plain_cfg = dataclasses.replace(cfg, use_pallas_compositing=False,
                                  sigma_gradient_mode='vmap')
  train_cfg = dataclasses.replace(
      config_lib.nerf_ds_train_config(batch_size=batch_size), print_every=1)
  start = time.perf_counter()
  source = SyntheticDataSource(num_frames=8, image_size=64)
  trainer = Trainer.from_experiment(cfg, train_cfg, source, use_mesh=False)
  store = trainer.build_store()
  print(f'  set-up (ground truth, model, store of {store.num_rays} rays): '
        f'{time.perf_counter() - start:.2f} s')

  losses = []
  kernels.reset_launch_counts()
  state = trainer.train(num_steps=steps, log_fn=lambda step, log: (
      losses.append(log['stats']['fine']['loss/rgb'])))
  torch.cuda.synchronize()
  launches = dict(kernels.launch_counts)
  print(f'  launches over {steps} steps: {launches}')
  for name, per_step in (('fused_trunk_fwd', 2), ('fused_trunk_bwd', 2),
                         ('composite_fwd', 2)):
    if launches[name] != per_step * steps:
      raise AssertionError(f'{name} launched {launches[name]} times in '
                           f'{steps} steps, want {per_step} a step')
  if not (len(losses) == steps and np.isfinite(losses).all()):
    raise AssertionError(f'training losses: {losses}')
  print(f'  fine rgb loss: first 4 steps {np.mean(losses[:4]):.5f}, last 4 '
        f'{np.mean(losses[-4:]):.5f} ({losses[0]:.5f} -> {losses[-1]:.5f})')

  # Gradients of both paths from the trained state and one batch, drawing
  # the same stratified samples.
  plain = NerfDSModel(plain_cfg, num_warp_embeds=trainer.model.num_warp_embeds,
                      num_hyper_embeds=trainer.model.num_hyper_embeds,
                      near=trainer.model.near, far=trainer.model.far,
                      device=device)
  scalars = step_lib.eval_schedules(step_lib.build_schedules(train_cfg),
                                    state.step)
  gen = lambda: torch.Generator(device=device).manual_seed(123)
  batch = sample_batch(store, gen(), batch_size)
  got, got_stats = step_lib._grads(
      step_lib.make_loss_fn(trainer.model, train_cfg), state.params, batch,
      gen(), scalars)
  want, want_stats = step_lib._grads(
      step_lib.make_loss_fn(plain, train_cfg), state.params, batch, gen(),
      scalars)
  torch.cuda.synchronize()
  rels = {k: ((got[k] - w).norm() / w.norm().clamp_min(1e-30)).item()
          for k, w in want.items()}
  worst = max(rels, key=rels.get)
  print(f'  gradients, kernel vs plain path, |got - want| / |want| over '
        f'{len(rels)} tensors: worst {rels[worst]:.3e} ({worst}), median '
        f'{float(np.median(list(rels.values()))):.3e}')
  for k in ('loss/total', 'loss/rgb', 'loss/norm_diff'):
    print(f'  fine {k}: kernel {float(got_stats["fine"][k]):.7f}, plain '
          f'{float(want_stats["fine"][k]):.7f}')
  # Tolerance relative to each tensor's norm: float32 sums in another order
  # than cuBLAS, and sample rows whose relu pre-activation lies within
  # rounding of 0 may take the other side of the kink (see K1b).
  for k, rel in rels.items():
    if not rel <= 1e-3:
      raise AssertionError(f'gradient {k}: |got - want| / |want| = {rel:.2e}')
  del got, want

  def timed(step_fn, n):
    run_state = state
    g = torch.Generator(device=device)
    for i in range(2):  # warm-up
      g.manual_seed(10_000 + i)
      run_state, _ = step_fn(run_state, g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(n):
      g.manual_seed(20_000 + i)
      run_state, _ = step_fn(run_state, g)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n, (
        torch.cuda.max_memory_allocated() / 2**30)

  kernel_step = step_lib.make_fused_train_step(trainer.model, train_cfg, store)
  plain_step = step_lib.make_fused_train_step(plain, train_cfg, store)
  runs = {'kernel': [], 'plain': []}
  for name in ('kernel', 'plain', 'plain', 'kernel'):
    runs[name].append(timed(kernel_step if name == 'kernel' else plain_step,
                            TRAIN_TIMED_STEPS))
  out = {}
  for name, rs in runs.items():
    sec = [r[0] for r in rs]
    out[name] = dict(step_ms=1e3 * float(np.mean(sec)),
                     rays_per_s=batch_size / float(np.mean(sec)),
                     peak_gib=max(r[1] for r in rs))
    print(f'  {name} path: steps of {", ".join(f"{1e3 * x:.1f}" for x in sec)}'
          f' ms -> {out[name]["rays_per_s"]:.0f} training rays/s, peak '
          f'{out[name]["peak_gib"]:.2f} GiB')
  for name, step_fn in (('kernel', kernel_step), ('plain', plain_step)):
    g = torch.Generator(device=device)
    g.manual_seed(30_000)
    box = [step_fn(state, g)[0]]

    def one_step(step_fn=step_fn, g=g, box=box):
      box[0] = step_fn(box[0], g)[0]

    profile_device(torch, one_step, f'{name}-path training step')
    syncs = host_syncs(torch, one_step)
    out[name]['host_syncs'] = sum(syncs.values())
    print(f'  host synchronisations in one {name}-path step: '
          f'{sum(syncs.values())}, at {syncs}')
  return launches, out


def eval_launches_check(launches, chunks: int):
  """K2 twice an eval chunk (coarse and fine); K1f, K1b and K3 never: eval
  renders skip ∇σ, and no model path calls K3."""
  want = {'composite_fwd': 2 * chunks, 'fused_trunk_fwd': 0,
          'fused_trunk_bwd': 0, 'fused_mlp_fwd': 0}
  if launches != want:
    raise AssertionError(f'eval launches {launches}, want {want}')


def phase_eval(torch, device):
  """The slice's path at full width: the train CLI with an experiment
  directory (24 steps, checkpoints at 12 and 24), the train CLI again to
  step 30 (it must resume at 24), and the eval CLI on the latest
  checkpoint; then eval_psnr of the restored state on the kernel and the
  plain paths, and against the untrained state; then K3 through
  fused_apply on every MLP of the restored model, fed the inputs each MLP
  received in one eval render chunk."""
  import dataclasses
  import pathlib
  import tempfile
  import numpy as np
  from nerfds_torch import config as config_lib
  from nerfds_torch import eval as eval_cli
  from nerfds_torch import kernels
  from nerfds_torch import train as train_cli
  from nerfds_torch import datasets
  from nerfds_torch.evaluation import render as render_lib
  from nerfds_torch.kernels import fused_mlp
  from nerfds_torch.models.mlp import MLP
  from nerfds_torch.trainer import Trainer, eval_extra_params
  from nerfds_torch.training.checkpoints import CheckpointManager
  first, last = EVAL_STEPS
  print(f'== eval: train CLI to step {first}, resumed to {last}, eval CLI; '
        'nerf_ds() at full width')
  out = {}
  with tempfile.TemporaryDirectory() as tmp:
    exp = pathlib.Path(tmp) / 'exp'
    args = ['--preset', 'nerf_ds', '--datasource', 'synthetic', '--exp_dir',
            str(exp), '--set', 'model.use_pallas_compositing=True', '--set',
            'model.sigma_gradient_mode=fused', '--batch_size',
            str(TRAIN_BATCH), '--set', f'train.save_every={first // 2}']
    start = time.perf_counter()
    state, metrics = train_cli.main([*args, '--max_steps', str(first)])
    ckpt = CheckpointManager(exp / 'checkpoints')
    print(f'  train CLI to step {state.step}: '
          f'{time.perf_counter() - start:.1f} s, checkpoints '
          f'{ckpt.all_steps()}, final val metrics {metrics}')
    if state.step != first or ckpt.all_steps() != [first // 2, first]:
      raise AssertionError(f'step {state.step}, checkpoints '
                           f'{ckpt.all_steps()}')
    kernels.reset_launch_counts()
    state, metrics = train_cli.main([*args, '--max_steps', str(last)])
    resumed = dict(kernels.launch_counts)
    print(f'  train CLI resumed to step {state.step}: launches {resumed}, '
          f'checkpoints {ckpt.all_steps()}')
    # K1b runs twice a step: the second run took last - first steps.
    if (state.step != last or ckpt.all_steps() != [first, last]
        or resumed['fused_trunk_bwd'] != 2 * (last - first)):
      raise AssertionError('the train CLI did not resume at its checkpoint')
    lines = (exp / 'summaries' / 'metrics.jsonl').read_text().splitlines()
    if [json.loads(x)['step'] for x in lines] != [first, last]:
      raise AssertionError(f'summaries/metrics.jsonl: {lines}')

    kernels.reset_launch_counts()
    start = time.perf_counter()
    eval_cli.main(['--exp_dir', str(exp), '--eval_once', '--num_val_eval',
                   '2', '--num_train_eval', '2', '--save_images'])
    torch.cuda.synchronize()
    out['eval_cli_s'] = time.perf_counter() - start
    launches = dict(kernels.launch_counts)
    report = json.loads((exp / 'metrics' / f'{last}.json').read_text())
    panels = sorted(p.name for p in (exp / 'renders' / str(last)).rglob(
        '*.png'))
    print(f'  eval CLI: {out["eval_cli_s"]:.2f} s, launches {launches}, '
          f'panels {panels}')
    for split in ('val', 'train'):
      print(f'  eval CLI {split}: {report[split]["mean"]}')
      if len(report[split]['per_item']) != 2 or not all(
          np.isfinite(m[k]) for m in report[split]['per_item'].values()
          for k in ('psnr', 'ssim', 'ms_ssim')):
        raise AssertionError(f'metrics/{last}.json {split}: {report[split]}')
    if len(panels) != 4:
      raise AssertionError(f'panels: {panels}')
    source = datasets.from_config(config_lib.ExperimentConfig(**json.loads(
      (exp / 'experiment.json').read_text())))
    eval_launches_check(launches, 4 * -(-source.image_size ** 2 // 8192))

    # eval_psnr of the restored state, kernel path against plain path.
    train_cfg = config_lib.TrainConfig(**json.loads(
        (exp / 'train_config.json').read_text()))
    cfg = config_lib.model_config_from_dict(json.loads(
        (exp / 'model_config.json').read_text()))
    trainer = Trainer.from_experiment(cfg, train_cfg, source)
    plain = Trainer.from_experiment(dataclasses.replace(
        cfg, use_pallas_compositing=False, sigma_gradient_mode='vmap'),
        train_cfg, source)
    restored, step = ckpt.restore(trainer.init_state())
    trainer.eval_psnr(restored)  # loads the val items' ground truth
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    k_psnr = trainer.eval_psnr(restored)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    eval_launches_check(dict(kernels.launch_counts),
                        len(source.val_ids) * -(-source.image_size ** 2
                                                // 8192))
    out['eval_rays_per_s'] = len(source.val_ids) * source.image_size ** 2 / (
        seconds)
    start = time.perf_counter()
    p_psnr = plain.eval_psnr(restored)
    torch.cuda.synchronize()
    out['eval_plain_rays_per_s'] = len(source.val_ids) * (
        source.image_size ** 2) / (time.perf_counter() - start)
    diff = abs(k_psnr['psnr'] - p_psnr['psnr'])
    print(f'  eval_psnr at step {step}: kernel path {k_psnr} '
          f'({out["eval_rays_per_s"]:.0f} rays/s), plain path {p_psnr} '
          f'({out["eval_plain_rays_per_s"]:.0f} rays/s); psnr differs by '
          f'{diff:.2e} dB')
    if step != last or not diff <= 1e-3:
      raise AssertionError('eval_psnr: kernel and plain paths differ')
    ids = source.train_ids[:2]
    trained = trainer.eval_psnr(restored, item_ids=ids)['psnr']
    untrained = trainer.eval_psnr(trainer.init_state(train_cfg.random_seed),
                                  item_ids=ids)['psnr']
    print(f'  train-split psnr: untrained {untrained:.3f} dB, step {step} '
          f'{trained:.3f} dB')
    if not trained > untrained:
      raise AssertionError('training did not raise the train-split psnr')
    out.update(val_psnr=k_psnr['psnr'], train_psnr=trained,
               untrained_train_psnr=untrained)

    # K3 on the restored model: every MLP's input blocks (concatenated) and
    # output in one render chunk, then fused_apply on each input.
    model = trainer.model_with_params(restored.params)
    captured = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, res, name=name: captured.append((
            name, mod, torch.cat(list(inp[0]), -1) if isinstance(
                inp[0], (list, tuple)) else inp[0], res)))
        for name, m in model.named_modules() if isinstance(m, MLP)]
    item = source.load_item(source.val_ids[0])
    render_lib.render_image(
        model, {k: item[k] for k in ('origins', 'directions', 'mask',
                                     'metadata')},
        eval_extra_params(cfg, train_cfg, step), chunk=4096, keys=('rgb',),
        generator=torch.Generator(device=device).manual_seed(0))
    for h in hooks:
      h.remove()
    kernels.reset_launch_counts()
    got = [fused_mlp.fused_apply(mod, None, x) for _, mod, x, _ in captured]
    torch.cuda.synchronize()
    out['k3_launches'] = kernels.launch_counts['fused_mlp_fwd']
    if out['k3_launches'] != len(captured):
      raise AssertionError(f'K3 launched {out["k3_launches"]} times for '
                           f'{len(captured)} MLP calls')
    print(f'  K3 on the restored model: {len(captured)} MLP calls in one '
          'render chunk of 4096 rays')
    for (name, mod, x, want), g in zip(captured, got):
      ms = time_ms(torch, lambda: fused_mlp.fused_apply(mod, None, x), 3,
                   warmup=1)
      print(f'  {name}: {x.shape[0]} rows, {x.shape[1]} in, kernel '
            f'{ms:.3f} ms')
      # The render-agreement tolerance: float32 in another order.
      compare(torch, name, g, want, 1e-4, 1e-4)
    del captured, got
  return out


def host_syncs(torch, fn):
  """Calls ``fn`` once under CUDA's sync debug mode and counts the calls
  that made the host wait for the card, by the line of Python that made
  them."""
  import collections
  import warnings
  torch.cuda.synchronize()
  with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter('always')
    torch.cuda.set_sync_debug_mode('warn')
    try:
      fn()
    finally:
      torch.cuda.set_sync_debug_mode('default')
  return dict(collections.Counter(
      f'{"/".join(w.filename.split("/")[-2:])}:{w.lineno}' for w in caught
      if 'synchroniz' in str(w.message)))


def profile_device(torch, fn, name, n=2, top=8):
  """Device time by kernel over ``n`` calls of ``fn`` (torch.profiler), and
  the device's idle share of their wall time with the profiler on; returns
  {kernel or copy name: device ms a call}."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for _ in range(n):
      fn()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / n
  # Kernels and copies on the card only: an operator's row repeats the
  # device time of the kernels it launched.
  events = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
  busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / n
  print(f'  profile, {name}: {wall_ms:.2f} ms a call with the profiler on, '
        f'device busy {busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}'
        f', {sum(e.count for e in events) // n} device ops a call; by device '
        'time:')
  for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
    print(f'    {e.self_device_time_total / 1e3 / n:8.3f} ms {e.count // n:5d}x '
          f'{e.key[:80]}')
  return {e.key: e.self_device_time_total / 1e3 / n for e in events}


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
  results.append(phase_fused_trunk_bwd(torch, device))
  results.append(phase_fused_mlp(torch, device))
  train_launches, train = phase_train(torch, device)
  for r in results:
    r['launches_render'] = launches[r['name']]
    r['launches_train'] = train_launches[r['name']]
    r['launches_per_train_step'] = train_launches[r['name']] / TRAIN_STEPS
  if launches['fused_mlp_fwd'] or train_launches['fused_mlp_fwd']:
    raise AssertionError('K3 ran on the render or the training path')
  results[2]['launches'] = train_launches['fused_trunk_bwd']
  evaluation = phase_eval(torch, device)
  results[3]['launches'] = evaluation['k3_launches']
  print(json.dumps({'kernels': results}))
  print(f'training at batch {TRAIN_BATCH}, steady steps: ' + '; '.join(
      f'{name} path {t["rays_per_s"]} rays/s, {t["step_ms"]} ms a step, peak '
      f'{t["peak_gib"]} GiB, {t["host_syncs"]} host syncs a step'
      for name, t in train.items()))
  print('eval: ' + json.dumps(evaluation))
  print(f'card: {card_line()}')
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
