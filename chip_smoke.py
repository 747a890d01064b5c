#!/usr/bin/env python3
"""Drives the PyTorch port (``nerfds_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

1. Prints the card (``nvidia-smi``), fails without CUDA, and builds the
   hand-written kernels from ``nerfds_torch/kernels/csrc``; reads the
   library's SASS (``cuobjdump``) and fails unless each bf16 trunk kernel's
   products run on the tensor cores (HMMA or HGMMA instructions, counted,
   and no FFMA).
2. K2, compositing forward: kernel against its plain PyTorch version, at
   the render and the training shapes, S = 12 and a ragged R; each timed
   shape by its device time as a share of its bound.
3. K1f, trunk forward with ∂σ/∂feat: kernel against its plain version, at
   the render and the training shapes, each timed as a share of its bound.
4. Renders a 128x128 image with the full-width ``nerf_ds()`` model through
   K1f and K2, and K3 for the no-grad mask MLP (launch counts checked),
   then again on the plain path, and compares the two.
5. K1b, the trunk's hand-derived backward: kernel against its plain version
   at the training shapes and a ragged N; two launches must give the same
   bits; timed at both training shapes, split into the sweep, the weight
   grads and their reduction by the profiler.
6. K3, the whole-MLP forward: kernel against its plain version at every
   ``nerf_ds()`` MLP shape, each also at a render chunk's sample rows
   (timed as a share of its bound), at the edges of the 64-row tile, a
   ragged N and N = 0; each activation and bf16 compute.
7. Trains the full-width ``nerf_ds()`` on the synthetic scene for 24 steps
   at batch 512 through ``Trainer.train`` (K1f, K1b and K2 twice a step,
   checked), compares the kernel path's gradients with the plain path's,
   and times and profiles steady steps of both paths, counting the host's
   waits on the card in one step of each.
8. The held-out evaluation path at full width: the train CLI with an
   experiment directory, resumed from its checkpoint, then the eval CLI
   (K2 twice and K3 8 times an eval chunk, K1f never); ``eval_psnr`` of the
   restored state on the kernel and plain paths; K3 through ``fused_apply``
   on every MLP of the restored model, fed what each received in one
   render chunk, against the plain version, each timed as a share of its
   bound.
9. The captured-scene path at full width, through the CLIs: exports a
   two-camera vrig capture (4 frames a camera, 480x480, 192 ground-truth
   samples) on the card, writes its split cameras, trains ``nerf_ds()`` on
   it for 24 steps at batch 512 (K1f, K1b and K2 twice a step), runs the
   eval CLI on its val, train and test splits (K2 and K3), renders a val
   view and a novel camera path (K2 and K3), and scores the rendered val
   frame with ``metrics_pipeline`` against the eval CLI's PSNR; times the
   PNG decode of an exported frame and of a Paeth-filtered panel.
10. The speed and precision modes at full width. (a) K1f and K1b in their
   bf16-operand mode (on the tensor cores) against their bf16 plain
   versions (K1f at the training batch's rows, a render chunk's and a
   ragged N; K1b at the training shapes and a ragged N, two launches
   giving the same bits): every row beyond the bf16 tolerance reproduced
   by the plain version in float64 with the roundings or masks moved that
   lie at a boundary (``fused_trunk.check_bf16_rows``), and K1b's outputs
   within 5e-3 of each norm; the float32 kernels shown to fail that rule;
   the plain version's products shown to be float32 sums in k order (what
   the kernels' resum reproduces at their rounding decisions);
   each timed by its device time beside the float32 kernel, with the bf16
   tensor-core bound, the f32-FMA ceiling and K1b's scratch floor (its
   scratch written and read once).
   (b) ``nerf_ds_fast`` (∇σ top-k) for 24 steps through
   ``Trainer.train`` (K2 twice a step, K1
   never: top-k acts in 'vmap' mode), its gradients against the plain
   path's, then the train CLI with ``--preset nerf_ds_fast``. (c)
   ``compute_dtype='bfloat16'`` in the trunk, rgb and mask zones with
   'fused' ∇σ, 24 steps (K1f, K1b in bf16 and K2 twice a step, K1 in
   float32 never), its gradients against the same model on K1's plain
   bf16 versions. (d) bf16 activation
   storage, 24 steps. (e) ``python -m nerfds_torch.quality_ablate`` with
   the cases f32 and topk16 at seeds 0 and 1, 30 steps: its rows and its
   PAIRED_SUMMARY line.
11. The deformation family of BASELINE config[2] at full width, on the
   train phase's store and its static points: (a) ``hypernerf()`` at 128 +
   128 samples with the elastic, background and hyper-reg losses and
   bendy-sheet slicing (DS), 24 steps through ``Trainer.train`` (K2 twice
   a step, K1 and K3 never; the three losses finite at every step), its
   gradients against the plain path's, its steady step with the warp's
   Jacobian on and off, one step profiled and its host waits counted; (b)
   the same with axis-aligned-plane slicing (AP), 12 steps; (c)
   ``nerf_ds()`` with the dual-quaternion field, the elastic loss and
   'fused' ∇σ, 24 steps (K1f, K1b and K2 twice a step), its gradients
   against the plain path's ('vmap', plain compositing); (d) the train CLI
   with ``--preset hypernerf`` and config[2]'s overrides, 6 steps, its
   ``summaries/metrics.jsonl`` holding the elastic loss.
12. The radiance variants: K1f and K1b at a σ-only head and without a
   bottleneck, in float32 and (by phase 10(a)'s rules) in bf16; (a) ∇σ
   as the colour's normal, (b) hyper-c with the 'canonical' target, (c)
   the 'direct' target with every rgb condition,
   12 steps each against the plain path; the ∇σ modes; a train CLI.
13. The model variants outside ``nerf_ds()``, 12 steps each against their
   plain twins ('vmap', plain compositing) within max(1e-3, twice the
   step's float32 floor), each with its steady step and peak memory: (a)
   ``vanilla_nerf()`` (K2 once a step) and its 128x128 render, held
   against the CPU's step too; (b) ``concat_dense_inputs`` and one step of
   'naive' + ``concat_dense_inputs``; (c) the bone field with its
   background loss, and the train CLI with its overrides; (d) the
   appearance embedding as an rgb condition ('fused') and an alpha
   condition too ('vmap'); (e) the 'layer' and 'group' norms ('vmap'),
   held against the CPU's step too; (f) ``remat_feat`` and ``remat_sigma``
   'nothing' and 'dots', their gradients within 1e-5 of the run without
   remat, the peak memory of both.
14. Data parallelism and the host sampler, on phase 7's scene at full
   width: (a) ``Trainer(use_mesh=True)`` with no process group, 12 steps,
   against two runs without a mesh (bit-equal where they are); (b1) one
   rank on NCCL, (b2) two ranks on the one card over gloo, (b3) two ranks
   on two cards over NCCL where the machine has them, each a child
   process of this script running ``nerf_ds_pod`` at 512 rays a rank for
   24 steps (K1f, K1b, K2 twice a step on every rank, the same parameter
   bits on every rank; (b1) against runs without a mesh; (b2), (b3) one
   explicit 2-rank step against one rank within 1e-3 of each gradient's
   norm, ``eval_psnr`` within 1e-3 dB and ``render_image`` within atol
   1e-4 + rtol 1e-4 of the rank alone, the all-reduce's time); (c)
   ``sampling='host'``, 24 steps, its first batches bit-equal to numpy's
   gather, no sampler thread left, its steady step beside the fused
   gather's. Every case's steady step and host waits.
15. The measuring and study CLIs, in this process or as child processes:
   (a) first each kernel of the bench's path against its plain version at
   the bench's shapes at batch 2048 (K1f and K1b, float32 and bf16, on
   131,072 and 262,144 rows, each timed; K2 on [2048, 64] and [2048,
   128]), and one
   step of ``bench.build(2048)`` on the kernel path against the plain
   path, every Adam first moment within 1e-3 of its norm; then
   ``python -m nerfds_torch.bench`` at batch 2048 (5 chains of 8
   steps) and 512 (``--quick``), on the kernel path with its baseline and
   on the plain path: one JSON line with ``bench.py``'s keys and "path",
   K1f, K1b and K2 twice a step on the kernel path, none of them on the
   plain path and in the baseline ('naive' ∇σ, concat inputs, plain
   compositing), each run's chains and peak memory; (b) ``bench_ablate``
   on the kernel path, every row timed but the four top-k rows, which are
   refused (top-k acts only in 'vmap' or 'naive'), the 'bf16' row on K1f
   and K1b in bf16 twice a step and K1 in float32 never; then the plain
   path's 'full' and 'topk16' rows; (c) ``bench_scaling`` under
   ``torch.distributed.run``: one rank at 2048 rays (within 25% of (a)'s
   kernel path), two gloo ranks sharing the card, NCCL over the cards
   where there are two or more; (d) ``convergence_run``,
   ``normals_ablation`` and ``batch_scaling_study`` at cut sizes (K1b
   twice a training step, or a microbatch, of a case that takes ∇σ;
   ``convergence_run``'s normal fidelity scores at least one pixel, with
   a finite cosine),
   then ``run_scenes`` over a capture exported on the card and a missing
   directory (a failure row in ``summary.csv``).
16. Prints one JSON line describing every kernel, the two bf16 modes of
   the trunk kernels included ("launches": the render's count for K1f and
   K2, the training run's for K1b, the eval path's for K3, phase 10(c)'s
   for the bf16 modes; "launches_render", "launches_train",
   "launches_capture", "launches_speed_modes", "launches_deformation",
   "launches_radiance", "launches_variants", "launches_parallel" and
   "launches_bench" for all six), a line of the training numbers, a line
   of the eval numbers, a line of the capture numbers, a line each of the
   speed modes', the deformation family's, the radiance variants', the
   model variants', phase 14's and phase 15's numbers ("bench:"), the
   card's line, and as the last line
   ``{"ok": true, "device": {...}}``. K2's and K3's
   entries hold their times at every timed shape under "shapes"; K3's
   σ/normal head there also holds its library call's time
   (``F.linear``).

TF32 is switched off for matmuls and convolutions, so every plain version
runs in full float32 like the kernels. Exits nonzero at the first failure.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time

# Peak rates of one H100 SXM at its 700 W limit (NVIDIA data sheet).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12  # dense, on the tensor cores
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
# K1f's shapes in its bf16 mode (phase 10): the training batch's fine and
# coarse rows (the main path, first), a render chunk's rows, a ragged N.
K1_BF16_FWD_SIZES = (TRAIN_BATCH * 128, TRAIN_BATCH * 64, 4096 * 128, 4099)
# Phase 10's paired-seed gate run: steps of each (case, seed).
GATE_STEPS = 30
# K3's check: the render chunk's sample rows (4096 rays x 128 samples,
# timed), a ragged N, the edges of the 64-row tile and none.
K3_SIZES = (4096 * 128, 4099, 65, 63, 1, 0)
# K2's shapes (rays, samples): the render chunk, R = 8192 and a training
# batch at both levels' samples, timed; a ragged R at synthetic_smoke's 12
# samples and one past a 128-sample pass, checked only.
K2_SHAPES = ((4096, 64), (4096, 128), (8192, 64), (8192, 128), (512, 64),
             (512, 128), (4099, 12), (4099, 129))
# The eval phase: the train CLI's first run and the step its second resumes
# to.
EVAL_STEPS = (24, 30)
# The capture phase: frames a camera of the exported vrig capture, their
# width and height, and the ground truth's samples a ray.
CAPTURE_FRAMES = 4
CAPTURE_SIZE = 480
CAPTURE_GT_SAMPLES = 192


# The bf16-operand trunk kernels whose products run on the tensor cores
# (csrc/fused_trunk_fwd_bf16.cu, csrc/fused_trunk_bwd_bf16.cu), by their
# __global__ functions, and the kernel name they count their launches under.
BF16_TC_KERNELS = {'fused_trunk_fwd_bf16_kernel': 'fused_trunk_fwd_bf16',
                   'trunk_bwd_bf16_sweep_kernel': 'fused_trunk_bwd_bf16',
                   'trunk_wgrad_bf16_kernel': 'fused_trunk_bwd_bf16'}
BF16_DESIGN = ('tensor cores: mma.sync m16n8k16 bf16 with f32 sums, 64-row '
               'tiles, sums near a rounding or a mask summed again in k order '
               '(csrc/trunk_mma.cuh)')
# What every trunk kernel's name holds (the launches of the float32 and the
# bf16 entries, their norm and reduction kernels included), and none of the
# wrappers' PyTorch operations: device_ms's match for a trunk kernel's time.
TRUNK_KERNEL_MATCH = 'trunk_'


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


def device_ms(torch, fn, n: int = 20, match: str = '', flush=None) -> float:
  """Device time a call of ``fn``, by the profiler: the kernels and copies
  it ran on the card whose name holds ``match``, without the host's time
  between launches (for kernels that take less time than their wrapper's
  Python). With ``flush``, a buffer larger than the L2 cache written before
  each call, the call finds its inputs in device memory, not in L2."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  # The profiler may record none of a window's kernels (seen once for K2
  # at R = 512 after an L2 flush), or miss one launch of n (seen for K1f at
  # n = 3): a window where a kernel's launches are not a multiple of n is
  # profiled again.
  for _ in range(3):
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      for _ in range(n):
        if flush is not None:
          flush.zero_()
        fn()
      torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and match in e.key]
    total = sum(e.self_device_time_total for e in events)
    if total > 0 and all(e.count % n == 0 for e in events):
      return total / 1e3 / n
    print(f'  (the profiler recorded {[e.count for e in events]} launches '
          f'matching {match!r} in {n} calls; profiling again)')
  # Then CUDA events around each call, which also hold the wrapper's
  # launch latency: an upper bound, said so in the output.
  print(f'  (no profile of {match!r}: timed by CUDA events around each call)')
  pairs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(n)]
  for start, end in pairs:
    if flush is not None:
      flush.zero_()
    start.record()
    fn()
    end.record()
  torch.cuda.synchronize()
  return sum(start.elapsed_time(end) for start, end in pairs) / n


def sass_counts():
  """{__global__ function of BF16_TC_KERNELS: {'mma': its HMMA and HGMMA
  instructions, 'ffma': its FFMA, 'fmul': its FMUL instructions}} in the
  built library's SASS, read with the toolkit's ``cuobjdump --dump-sass``.
  Raises without cuobjdump beside nvcc or on the PATH."""
  from nerfds_torch.kernels import build
  tool = os.path.join(os.path.dirname(build.nvcc_path()), 'cuobjdump')
  tool = tool if os.path.exists(tool) else shutil.which('cuobjdump')
  if tool is None:
    raise AssertionError('cuobjdump not found: the bf16 kernels\' tensor '
                         'cores cannot be shown')
  sass = subprocess.run([tool, '--dump-sass', str(build.library_path())],
                        capture_output=True, text=True, timeout=300,
                        check=True).stdout
  counts, name = {}, None
  for line in sass.splitlines():
    if 'Function :' in line:
      function = line.split('Function :')[1].strip()
      # The name mangled (length, name) or demangled (name, arguments).
      name = next((k for k in BF16_TC_KERNELS
                   if f'{len(k)}{k}' in function or f'{k}(' in function),
                  None)
      if name:
        counts[name] = {'mma': 0, 'ffma': 0, 'fmul': 0}
    elif name and re.search(r'\bHG?MMA\.', line):
      counts[name]['mma'] += 1
    elif name and re.search(r'\bFFMA\b', line):
      counts[name]['ffma'] += 1
    elif name and re.search(r'\bFMUL\b', line):
      counts[name]['fmul'] += 1
  return counts


def check_tensor_cores():
  """The bf16 trunk kernels' layer products run on the tensor cores:
  each of their __global__ functions holds HMMA (or HGMMA) instructions
  and no FFMA. Their FMUL belong to resum (csrc/trunk_mma.cuh), which sums
  again in k order, on the CUDA cores, the few sums that lie near a bf16
  rounding or a relu mask (a multiply and an add apart, as an FFMA would
  round them). Returns sass_counts()."""
  counts = sass_counts()
  for k in BF16_TC_KERNELS:
    c = counts.get(k)
    print(f'  SASS of {k}: {c["mma"] if c else "no function"} HMMA/HGMMA, '
          f'{c["ffma"] if c else "-"} FFMA, {c["fmul"] if c else "-"} FMUL')
    if not c or not c['mma']:
      raise AssertionError(f'{k}: no tensor-core instruction in its SASS')
    if c['ffma']:
      raise AssertionError(f'{k}: {c["ffma"]} FFMA in its SASS: products '
                           'on the CUDA cores beyond resum\'s')
  return counts


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


def check_composite(torch, args):
  """K2 against its plain version on ``args`` (``composite_inputs``), with
  and without the sample at infinity; returns the largest |got - want|."""
  from nerfds_torch.kernels import composite
  names = ('rgb', 'depth', 'acc_all', 'weights', 'alpha', 'accum')
  # Tolerance: float32; the kernel forms the running product by a warp scan
  # (a tree of products over 32 samples, then the product of the earlier
  # chunks) and sums by lanes and a butterfly, so it associates differently
  # from torch.cumprod / torch.sum: a relative error of a few float32 ulps
  # per factor over up to 129 factors.
  atol, rtol = 1e-5, 1e-4
  num_rays, num_samples = args[1].shape
  max_err = 0.0
  for at_inf in (True, False):
    got = composite.composite_forward(*args, at_inf)
    want = composite.composite_reference(*args, at_inf)
    torch.cuda.synchronize()
    print(f' R={num_rays} S={num_samples} sample_at_infinity={at_inf}')
    for n, g, w in zip(names, got, want):
      max_err = max(max_err, compare(torch, n, g, w, atol, rtol))
  return max_err


def composite_bound(r: int, s: int):
  """(ms, what bounds it) of K2 on R rays of S samples: each input read
  once, each output written once, float32; about 12 operations a sample."""
  nbytes = 4 * (r * s * 3 + r * s + r * s + r * 3
                + r * 3 + r + r + 3 * r * s)
  t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, 12 * r * s / PEAK_F32_FLOP_PER_S
  return 1e3 * max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else \
      'operations'


def phase_composite(torch, device):
  """K2 at the chunk shapes of the render path, R=8192, the training
  batch, and a ragged R at S = 12 and S = 129. A launch takes a few µs, less
  than its wrapper's Python, so each timed shape is timed by the profiler's
  device time ("ms", "plain_ms"); "events_ms" is the older measure, CUDA
  events around 20 back-to-back calls, which the host's time then sets."""
  from nerfds_torch.kernels import composite
  print('== K2 composite_fwd vs plain version')
  gen = torch.Generator(device=device).manual_seed(0)
  max_err, main, shapes = 0.0, None, {}
  flush = torch.empty(2**26, device=device)  # 256 MB, five times the L2
  for num_rays, num_samples in K2_SHAPES:
    args = composite_inputs(torch, num_rays, num_samples, gen, device)
    max_err = max(max_err, check_composite(torch, args))
    if num_rays == 4099:
      continue
    ms = device_ms(torch, lambda: composite.composite_forward(*args))
    plain_ms = device_ms(torch, lambda: composite.composite_reference(*args))
    events_ms = time_ms(torch, lambda: composite.composite_forward(*args), 20)
    # The same launches after the L2 cache is flushed: the inputs come
    # from device memory, as the bytes bound assumes.
    cold_ms = device_ms(torch, lambda: composite.composite_forward(*args),
                        match='composite_fwd_kernel', flush=flush)
    bound_ms, bound_by = composite_bound(num_rays, num_samples)
    print(f'  time: kernel {ms:.5f} ms on the card ({events_ms:.5f} ms by '
          f'events back to back), plain {plain_ms:.5f} ms on the card, bound '
          f'{bound_ms:.5f} ms ({bound_by}): {bound_ms / ms:.1%} of the bound; '
          f'after an L2 flush {cold_ms:.5f} ms, {bound_ms / cold_ms:.1%}')
    shapes[f'R={num_rays} S={num_samples}'] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, events_ms=events_ms,
        cold_ms=cold_ms)
    if (num_rays, num_samples) == (4096, 128):
      main = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                  bound_by=bound_by, events_ms=events_ms, cold_ms=cold_ms)
  del flush
  return dict(name='composite_fwd', route='cuda',
              source='nerfds_torch/kernels/csrc/composite.cu',
              replaces='nerfds_tpu/pallas/composite.py:49',
              max_abs_err=max_err, library_ms=None, **main, shapes=shapes)


def nerf_ds_trunk(torch, device, seed, norm_dim=3, has_bottleneck=True):
  """The full nerf_ds NeRF trunk (8x256, skip at 4, 52 input channels, a
  σ + normal head and a bottleneck) with glorot-initialised weights;
  ``norm_dim=0`` gives the σ-only head of ``use_sigma_gradient`` without
  ``predict_norm``, ``has_bottleneck=False`` the trunk of ``use_hyper_c``."""
  from nerfds_torch import config as config_lib
  from nerfds_torch.kernels import fused_trunk
  from nerfds_torch.models.mlp import NerfMLP
  cfg = config_lib.nerf_ds()
  gen = torch.Generator().manual_seed(seed)
  in_dim = 52
  mlp = NerfMLP(in_dim=in_dim, alpha_cond_dim=0, rgb_cond_dim=0,
                has_condition=has_bottleneck,
                trunk_depth=cfg.nerf_trunk_depth,
                trunk_width=cfg.nerf_trunk_width, skips=cfg.nerf_skips,
                predict_norm=norm_dim > 0, generator=gen).to(device)
  spec = fused_trunk.TrunkSpec(
      depth=cfg.nerf_trunk_depth, width=cfg.nerf_trunk_width,
      skips=tuple(cfg.nerf_skips), in_dim=in_dim, alpha_channels=1,
      norm_dim=norm_dim, has_bottleneck=has_bottleneck)
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


def trunk_weight_count(weights) -> int:
  """Floats of the trunk's, the head's and the bottleneck's weights."""
  return sum(w.numel() + b.numel() for w, b in weights.layers) + sum(
      t.numel() for t in (*weights.head, *(weights.bottleneck or ())))


def trunk_fwd_bound(spec, weights, n: int):
  """(ms, what bounds it) of K1f on N rows: its operations at f32 peak, or
  feat, the weights and the five outputs moved once."""
  flops = n * trunk_flops(spec)
  nbytes = 4 * (n * spec.in_dim + trunk_weight_count(weights) + n * (
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
  """K3 against its plain version at every nerf_ds() MLP shape, each also
  at the render chunk's sample rows (timed as a share of its bound), at
  the 64-row tile's edges, a ragged N and N = 0; each activation, and bf16
  compute."""
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
  max_err, main, shapes = 0.0, None, {}
  with torch.no_grad():
    for name, mlp in mlps.items():
      layers, has_out = fused_mlp.mlp_params_to_layers(mlp, None)
      sizes = K3_SIZES[1:] if name.startswith('act=') else K3_SIZES
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
          # One PyTorch call computes a single linear layer without an
          # activation (the σ/normal head): F.linear.
          library_ms = None
          if len(layers) == 1 and mlp.output_activation is None:
            w_t = layers[0][0].t().contiguous()
            b = layers[0][1]
            library_ms = time_ms(
                torch, lambda: torch.nn.functional.linear(x, w_t, b), 5,
                warmup=1)
            compare(torch, 'out vs F.linear', got,
                    torch.nn.functional.linear(x, w_t, b), 1e-5, 1e-5)
            print(f'  library call F.linear: {library_ms:.3f} ms')
          shapes[name] = dict(n=n, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by,
                              library_ms=library_ms)
          if name == 'nerf.coarse.trunk':
            main = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by)
          print(f'  time: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound '
                f'{bound_ms:.3f} ms ({tflop:.4f} TFLOP, {bound_by}): '
                f'{bound_ms / ms:.1%} of the bound')
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
              max_abs_err=max_err, library_ms=None, **main, shapes=shapes)


def check_trunk_fwd(torch, device, spec, weights, n: int):
  """K1f against its plain version on N rows of random feat; returns (max
  abs error, feat)."""
  from nerfds_torch.kernels import fused_trunk
  names = ('sigma', 'normal', 'trunk_out', 'bottleneck', 'g')
  gen = torch.Generator(device=device).manual_seed(n)
  feat = torch.rand(n, spec.in_dim, generator=gen, device=device) * 2 - 1
  got = fused_trunk.trunk_sigma_grad(feat, weights, spec)
  want = fused_trunk.trunk_sigma_grad_reference(feat, weights, spec)
  torch.cuda.synchronize()
  print(f' N={n}')
  max_err = 0.0
  for name, g, w in zip(names, got, want):
    # Tolerance: float32 sums over 256 channels in another order than
    # cuBLAS. g also follows the relu masks: where a pre-activation is
    # within rounding of 0 the two versions may take the other side of the
    # kink, which moves that row's g, so up to 1e-3 of g's elements may
    # exceed the tolerance (measured on an H100: 5.4e-5 to 6.0e-5 at 0.5M
    # to 1M rows).
    bad_frac = 1e-3 if name == 'g' else 0.0
    max_err = max(max_err, compare(torch, name, g, w, 1e-4, 1e-4, bad_frac))
  return max_err, feat


def phase_fused_trunk(torch, device):
  from nerfds_torch.kernels import fused_trunk
  print('== K1f fused_trunk_fwd vs plain version')
  spec, weights = nerf_ds_trunk(torch, device, seed=1)
  max_err, main, train = 0.0, None, {}
  with torch.no_grad():
    # The coarse and fine shapes of a 4096-ray render chunk, R=8192 fine,
    # those of a 512-ray training batch, and a ragged count (the last
    # 64-row tile is partial).
    for n in (4096 * 64, 4096 * 128, 8192 * 128, 512 * 64, 512 * 128, 4099):
      err, feat = check_trunk_fwd(torch, device, spec, weights, n)
      max_err = max(max_err, err)
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
  # B̄ is read only where there is a bottleneck.
  cots = 1 + spec.norm_dim + (2 if spec.has_bottleneck else 1) * spec.width
  nbytes = 4 * (n * (2 * spec.in_dim + cots + spec.in_dim)
                + 2 * trunk_weight_count(weights))
  t_ops, t_bytes = flops / PEAK_F32_FLOP_PER_S, nbytes / PEAK_BYTES_PER_S
  return (1e3 * max(t_ops, t_bytes),
          'operations' if t_ops >= t_bytes else 'bytes', flops / 1e12,
          nbytes / 1e6)


def check_trunk_bwd(torch, device, spec, weights, n: int):
  """K1b against its plain version on N rows of random feat and
  cotangents: two launches must agree bit for bit; every feat_bar row
  beyond tolerance must be a relu kink row (``check_kink_rows``), none at a
  ragged N and none in the last block of the sweep; with those rows'
  cotangents zeroed every output within 1e-5 of its norm. Returns (max abs
  error, feat, the cotangents with the kink rows zeroed)."""
  from nerfds_torch.kernels import fused_trunk
  tile_rows = fused_trunk.KERNEL_TILE_ROWS
  flat_names = [f'{k}{i}' for i in range(spec.depth) for k in ('dW', 'db')]
  if spec.has_bottleneck:
    flat_names += ['bottleneck_dW', 'bottleneck_db']
  flat_names += ['head_dW', 'head_db']
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
  max_err = err.max().item()
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
  return max_err, feat, cots


def phase_fused_trunk_bwd(torch, device):
  """K1b against its plain version at the training shapes (coarse and fine
  rows of a 512-ray batch) and a ragged N; two launches must agree bit for
  bit."""
  from nerfds_torch.kernels import fused_trunk
  print('== K1b fused_trunk_bwd vs plain version')
  spec, weights = nerf_ds_trunk(torch, device, seed=2)
  max_err, main, train = 0.0, None, {}
  with torch.no_grad():
    for n in K1B_SIZES:
      err, feat, cots = check_trunk_bwd(torch, device, spec, weights, n)
      max_err = max(max_err, err)
      if n in (TRAIN_BATCH * 64, TRAIN_BATCH * 128):  # coarse, fine rows
        ms = time_ms(torch, lambda: fused_trunk.trunk_sigma_grad_backward(
            feat, weights, spec, cots), 3, warmup=1)
        plain_ms = time_ms(
            torch, lambda: fused_trunk.trunk_sigma_grad_backward_reference(
                feat, weights, spec, cots), 3, warmup=1)
        bound_ms, bound_by, tflop, mbytes = trunk_bwd_bound(spec, weights, n)
        floor_ms = scratch_floor_ms(n, spec.depth)
        print(f'  time: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound '
              f'{bound_ms:.3f} ms ({tflop:.4f} TFLOP, {mbytes:.1f} MB): '
              f'{bound_ms / ms:.1%} of the bound; scratch floor '
              f'{floor_ms:.3f} ms')
        parts = profile_device(
            torch, lambda: fused_trunk.trunk_sigma_grad_backward(
                feat, weights, spec, cots), f'K1b at N={n}', top=4)
        split = bwd_kernel_split(parts)
        print(f'  K1b at N={n} by kernel: sweep {split["sweep_ms"]:.3f} ms, '
              f'weight grads {split["wgrad_ms"]:.3f} ms, reduction '
              f'{split["reduce_ms"]:.3f} ms')
        if n == TRAIN_BATCH * 128:  # the fine level's rows
          main = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by, scratch_floor_ms=floor_ms, **split)
        else:
          train.update({f'{k}_n{n}': v for k, v in dict(
              ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
              scratch_floor_ms=floor_ms, **split).items()})
      del feat, cots
  return dict(name='fused_trunk_bwd', route='cuda',
              source='nerfds_torch/kernels/csrc/fused_trunk_bwd.cu',
              replaces='nerfds_tpu/pallas/fused_trunk.py:295',
              max_abs_err=max_err, library_ms=None, **main, **train)


def bwd_kernel_split(parts):
  """K1b's device time a call by its kernels: the sweep, the weight-grad
  products and the reduction of their partials."""
  pick = lambda test: sum(ms for name, ms in parts.items() if test(name))
  return dict(sweep_ms=pick(lambda k: 'sweep_kernel' in k),
              wgrad_ms=pick(lambda k: 'wgrad' in k and 'reduce' not in k),
              reduce_ms=pick(lambda k: 'wgrad' in k and 'reduce' in k))


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
  # The mask MLP of each level runs under no_grad, so MLP.forward sends it
  # to K3; the fields and the trunk run with grad on for ∇σ.
  if (launches['fused_mlp_fwd'] != 2 * num_chunks
      or launches[K3_PREFETCHED] != 18 * num_chunks):
    raise AssertionError(f'K3 launched {launches["fused_mlp_fwd"]} times '
                         f'({launches[K3_PREFETCHED]} layers prefetched), '
                         f'want 2 per chunk x {num_chunks} chunks (18: the '
                         f'mask MLP\'s 9 layers a level)')
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
  return launches, out, trainer


def eval_launches_check(launches, chunks: int):
  """K2 twice an eval chunk (coarse and fine), K3 8 times (MLP.forward
  sends the NeRF trunk, mask MLP, SE(3) trunk and hyper sheet of each
  level, all under no_grad), their 60 layers' biases staged ahead of the
  epilogues (8, 9, 6 and 7 a level); K1f and K1b never: eval renders skip
  ∇σ."""
  want = {**dict.fromkeys(launches, 0), 'composite_fwd': 2 * chunks,
          'fused_mlp_fwd': 8 * chunks, K3_PREFETCHED: 60 * chunks}
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
    state, metrics, _ = train_cli.main([*args, '--max_steps', str(first)])
    ckpt = CheckpointManager(exp / 'checkpoints')
    print(f'  train CLI to step {state.step}: '
          f'{time.perf_counter() - start:.1f} s, checkpoints '
          f'{ckpt.all_steps()}, final val metrics {metrics}')
    if state.step != first or ckpt.all_steps() != [first // 2, first]:
      raise AssertionError(f'step {state.step}, checkpoints '
                           f'{ckpt.all_steps()}')
    kernels.reset_launch_counts()
    state, metrics, _ = train_cli.main([*args, '--max_steps', str(last)])
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

    # K3 on the restored model: every MLP's input blocks (concatenated) in
    # one render chunk, then fused_apply on each input against the plain
    # version (the render's own outputs came from K3 where MLP.forward
    # routes it).
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
      _, bound_ms, bound_by = mlp_forward_bound(
          fused_mlp.mlp_params_to_layers(mod, None)[0], x.shape[0])
      print(f'  {name}: {x.shape[0]} rows, {x.shape[1]} in, kernel '
            f'{ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}): '
            f'{bound_ms / ms:.1%} of the bound')
      layers, has_out = fused_mlp.mlp_params_to_layers(mod, None)
      with torch.no_grad():
        plain_out = fused_mlp.fused_mlp_reference(
            x, layers, mod.skips, mod.hidden_activation,
            mod.output_activation, has_out)
      # The render-agreement tolerance: float32 in another order.
      compare(torch, name, g, plain_out, 1e-4, 1e-4)
      compare(torch, f'{name} in the render', want, plain_out, 1e-4, 1e-4)
    del captured, got
  return out


def phase_capture(torch, device):
  """The captured-scene path at full width, through the CLIs a user runs:
  export a two-camera vrig capture on the card, write its split cameras,
  train nerf_ds on it (the Nerfies loader), evaluate it (val, train and
  test splits), render the val cameras and a novel camera path, and score
  the rendered val frame offline. The launch counts are set to 0 before
  each CLI and read after it; their sums are the capture path's."""
  import math
  import pathlib
  import tempfile
  import numpy as np
  from nerfds_torch import eval as eval_cli
  from nerfds_torch import export_synthetic, generate_test_cameras
  from nerfds_torch import image_utils, kernels, metrics_pipeline
  from nerfds_torch import render as render_cli
  from nerfds_torch import train as train_cli
  frames, size = CAPTURE_FRAMES, CAPTURE_SIZE
  print(f'== capture: vrig export ({frames} frames a camera, {size}x{size}),'
        f' train CLI {TRAIN_STEPS} steps, eval CLI, render CLI, '
        'metrics_pipeline; nerf_ds() at full width')
  # The CLIs' chunk: 8192 rays, a 480x480 view in 29 chunks.
  chunks_a_view = math.ceil(size * size / 8192)
  total = dict.fromkeys(kernels.launch_counts, 0)
  out = {}

  def run(fn, argv):
    kernels.reset_launch_counts()
    start = time.perf_counter()
    result = fn(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = dict(kernels.launch_counts)
    for k, v in launches.items():
      total[k] += v
    return result, seconds, launches

  with tempfile.TemporaryDirectory() as tmp:
    data, exp = pathlib.Path(tmp) / 'vrig', pathlib.Path(tmp) / 'exp'
    (_, export_s), _, launches = run(export_synthetic.main, [
        '--out_dir', str(data), '--frames', str(frames), '--image_size',
        str(size), '--gt_samples', str(CAPTURE_GT_SAMPLES),
        '--camera_path_frames', str(frames)])
    check_launches('export', launches)
    out['export_s_per_frame'] = export_s / (2 * frames)
    generate_test_cameras.main(['--data_dir', str(data), '--mode', 'split'])
    if len(list((data / 'vrig_camera').glob('*.json'))) != frames:
      raise AssertionError('generate_test_cameras --mode split')
    frame = data / 'rgb' / '1x' / 'left_0000.png'
    out['decode_ms_export_frame'] = 1e3 * min(
        time_host(lambda: image_utils.load_image(frame)) for _ in range(3))
    # A panel of three 480x480 frames written by the JAX package's eval
    # script, its rows filtered by Sub, Up and Paeth.
    panel = (pathlib.Path(__file__).resolve().parent / 'artifacts' / 'vrig_run'
             / 'panels' / 'eval_val_right_0000.png')
    out['decode_ms_panel_per_480'] = 1e3 * min(
        time_host(lambda: image_utils.load_image(panel))
        for _ in range(3)) / 3
    print(f'  export: {export_s:.2f} s, {out["export_s_per_frame"]:.3f} s a '
          f'frame; PNG decode of an exported frame '
          f'{out["decode_ms_export_frame"]:.1f} ms, of a Paeth-filtered '
          f'panel {out["decode_ms_panel_per_480"]:.1f} ms a 480x480 frame')

    (state, metrics, store), out['train_cli_s'], launches = run(
        train_cli.main, [
            '--preset', 'nerf_ds', '--datasource', 'nerfies', '--data_dir',
            str(data), '--exp_dir', str(exp), '--batch_size',
            str(TRAIN_BATCH), '--max_steps', str(TRAIN_STEPS), '--set',
            'model.use_pallas_compositing=True', '--set',
            'model.sigma_gradient_mode=fused', '--set',
            f'train.print_every={TRAIN_STEPS // 2}'])
    # K2 also runs twice a chunk in the closing eval of the 4 val views, K3
    # 8 times over 60 layers (eval_launches_check).
    steps = 2 * TRAIN_STEPS
    check_launches('train CLI', launches, fused_trunk_fwd=steps,
                  fused_trunk_bwd=steps,
                  composite_fwd=steps + 2 * frames * chunks_a_view,
                  fused_mlp_fwd=8 * frames * chunks_a_view,
                  **{K3_PREFETCHED: 60 * frames * chunks_a_view})
    if state.step != TRAIN_STEPS or not all(
        np.isfinite(v) for v in metrics.values()):
      raise AssertionError(f'train CLI: step {state.step}, {metrics}')
    out.update(store_rays=store.num_rays, store_nbytes=store.nbytes)
    print(f'  the train CLI\'s ray store: {store.num_rays} rays, '
          f'{store.nbytes} bytes on {store.rgb.device}')
    if store.num_rays != frames * size * size:
      raise AssertionError(f'store of {store.num_rays} rays')
    del store
    last = json.loads((exp / 'summaries' / 'metrics.jsonl').read_text(
        ).splitlines()[-1])
    out['train_rays_per_s'] = TRAIN_BATCH * last['time/steps_per_sec']
    out['train_val_psnr'] = metrics['psnr']
    print(f'  train CLI: {out["train_cli_s"]:.1f} s, steps '
          f'{TRAIN_STEPS // 2 + 1}-{TRAIN_STEPS} at '
          f'{out["train_rays_per_s"]:.0f} rays/s; closing val metrics '
          f'{metrics}')

    report, out['eval_cli_s'], launches = run(eval_cli.main, [
        '--exp_dir', str(exp), '--eval_once', '--num_val_eval', '1',
        '--num_train_eval', '1', '--num_test_eval', '1', '--save_images'])
    check_launches('eval CLI', launches, composite_fwd=2 * 3 * chunks_a_view,
                   fused_mlp_fwd=8 * 3 * chunks_a_view,
                   **{K3_PREFETCHED: 60 * 3 * chunks_a_view})
    for split in ('val', 'train'):
      print(f'  eval CLI {split}: {report[split]["per_item"]}')
      if not all(np.isfinite(v) for m in report[split]['per_item'].values()
                 for v in m.values()):
        raise AssertionError(f'eval CLI {split}: {report[split]}')
    print(f'  eval CLI test: {report["test"]}')
    if not [m['finite'] for m in report['test']['per_item'].values()] == [
        True]:
      raise AssertionError(f'eval CLI test split: {report["test"]}')
    val_psnr = report['val']['per_item']['right_0000']['psnr']

    for name, path in (('val', 'val'), ('novel', 'camera-paths/orbit-novel')):
      (render_dir, names), seconds, launches = run(render_cli.main, [
          '--exp_dir', str(exp), '--camera_path', path, '--interval',
          str(frames), '--out', str(exp / f'render_{name}')])
      check_launches(f'render CLI ({path})', launches,
                    composite_fwd=2 * chunks_a_view,
                    fused_mlp_fwd=8 * chunks_a_view,
                    **{K3_PREFETCHED: 60 * chunks_a_view})
      written = sorted(p.name for p in (render_dir / 'frames').glob('*.png'))
      print(f'  render CLI ({path}): {seconds:.1f} s, frames {written}')
      if written != [f'{n}.png' for n in names] or len(names) != 1:
        raise AssertionError(f'render CLI {path}: frames {written}')
      out[f'render_{name}_s_per_frame'] = seconds / len(names)

    means = metrics_pipeline.main([
        '--pred_dir', str(exp / 'render_val' / 'frames'), '--gt_dir',
        str(data / 'rgb' / '1x'), '--mask_dir',
        str(data / 'resized_mask' / '1x')])
    out.update(metrics_psnr=means['psnr'], eval_cli_val_psnr=val_psnr,
               metrics_masked_psnr=means.get('masked_psnr'),
               metrics_ms_ssim=means['ms_ssim'])
    print(f'  metrics_pipeline psnr {means["psnr"]:.4f} dB, eval CLI '
          f'{val_psnr:.4f} dB (right_0000)')
    if not abs(means['psnr'] - val_psnr) <= 0.05:
      raise AssertionError('metrics_pipeline and the eval CLI differ by '
                           'more than 0.05 dB')
  return total, out


def trunk_bf16_bounds(spec, weights, n: int, flops: int, in_out_floats: int):
  """(bound ms, what bounds it, f32-FMA ceiling ms) of a trunk kernel in
  bf16 on N rows: its operations at the bf16 tensor-core peak or its bytes
  (float32 inputs and outputs, bf16 weights) at the memory rate; and the
  same operations at the float32 CUDA-core peak, the best an engine of
  float32 FMAs could do (PR 7's widened each operand for one)."""
  n_weights = sum(w.numel() for w, _ in weights.layers) + \
      weights.head[0].numel() + weights.bottleneck[0].numel()
  n_biases = sum(b.numel() for _, b in weights.layers) + \
      weights.head[1].numel() + weights.bottleneck[1].numel()
  nbytes = 2 * n_weights + 4 * (n_biases + in_out_floats)
  t_ops, t_bytes = flops / PEAK_BF16_FLOP_PER_S, nbytes / PEAK_BYTES_PER_S
  return (1e3 * max(t_ops, t_bytes),
          'operations' if t_ops >= t_bytes else 'bytes',
          1e3 * flops / PEAK_F32_FLOP_PER_S)


def bf16_fwd_bound(spec, weights, n: int):
  """trunk_bf16_bounds of K1f in bf16 on N rows: feat in, the five
  outputs out."""
  return trunk_bf16_bounds(
      spec, weights, n, n * trunk_flops(spec),
      n * (2 * spec.in_dim + 1 + spec.norm_dim + 2 * spec.width))


def bf16_bwd_bound(spec, weights, n: int):
  """trunk_bf16_bounds of K1b in bf16 on N rows: feat and the cotangents
  in, feat_bar and every grad out."""
  n_weights = sum(w.numel() + b.numel() for w, b in weights.layers) + \
      sum(t.numel() for t in (*weights.head, *weights.bottleneck))
  return trunk_bf16_bounds(
      spec, weights, n, n * trunk_bwd_flops(spec),
      n * (2 * spec.in_dim + 1 + spec.norm_dim + 2 * spec.width
           + spec.in_dim) + n_weights)


def sites_used(flips) -> str:
  """'k rows with s moved sites, ...' of check_bf16_rows' explanations."""
  counts = {}
  for f in flips:
    counts[len(f)] = counts.get(len(f), 0) + 1
  return ', '.join(f'{c} with {k} moved site{"s" * (k != 1)}'
                   for k, c in sorted(counts.items())) or 'none'


def bf16_rows(torch, fused_trunk, names, feat, weights, spec, got, want):
  """K1f's outputs in bf16 against the plain bf16 version: finite, of the
  plain version's shapes, and every row beyond atol 1e-3 + rtol 1e-2 in
  one of them explained by fused_trunk.check_bf16_rows (which raises
  otherwise); a head without a normal has none on either side. Returns
  the largest |got - want|."""
  full_got, full_want = got, want
  if [g is None for g in got] != [w is None for w in want]:
    raise AssertionError('the kernel and the plain version return different '
                         'outputs')
  names, got, want = zip(*((name, g, w) for name, g, w in zip(names, got, want)
                           if w is not None))
  for name, g, w in zip(names, got, want):
    if tuple(g.shape) != tuple(w.shape) or not bool(torch.isfinite(g).all()):
      raise AssertionError(f'{name}: shape {tuple(g.shape)} against '
                           f'{tuple(w.shape)}, or non-finite values')
  errs = [(g - w).abs() for g, w in zip(got, want)]
  print('  ' + ', '.join(
      f'{name} max_abs_err {e.max().item():.3e} beyond '
      f'{(e > 1e-3 + 1e-2 * w.abs()).float().mean().item():.2e}'
      for name, e, w in zip(names, errs, want)))
  start = time.perf_counter()
  _, rows, flips = fused_trunk.check_bf16_rows(feat, weights, spec, full_got,
                                               full_want)
  print(f'  {len(rows)} rows beyond, each reproduced with '
        f'{sites_used(flips)} ({time.perf_counter() - start:.1f} s)')
  return max(e.max().item() for e in errs)


def check_trunk_fwd_bf16(torch, device, spec, weights, n: int):
  """K1f in bf16 against its plain bf16 version on N rows of random feat
  (``bf16_rows``); returns (max abs error, feat, the plain outputs)."""
  from nerfds_torch.kernels import fused_trunk
  bf16 = torch.bfloat16
  names = ('sigma', 'normal', 'trunk_out', 'bottleneck', 'g')
  gen = torch.Generator(device=device).manual_seed(n + 5)
  feat = torch.rand(n, spec.in_dim, generator=gen, device=device) * 2 - 1
  got = fused_trunk.trunk_sigma_grad(feat, weights, spec, compute_dtype=bf16)
  want = fused_trunk.trunk_sigma_grad_reference(feat, weights, spec,
                                                compute_dtype=bf16)
  torch.cuda.synchronize()
  print(f' K1f bf16, N={n}')
  err = bf16_rows(torch, fused_trunk, names, feat, weights, spec, got, want)
  return err, feat, want


def check_trunk_bwd_bf16(torch, device, spec, weights, n: int):
  """K1b in bf16 against its plain bf16 version on N rows of random feat
  and cotangents: two launches bit for bit, feat_bar's rows beyond
  tolerance explained by ``check_bf16_rows``, and every output within
  5e-3 of its norm. Returns (max abs error, feat, cotangents, the plain
  outputs flattened)."""
  from nerfds_torch.kernels import fused_trunk
  bf16 = torch.bfloat16
  gen = torch.Generator(device=device).manual_seed(n + 6)
  feat = torch.rand(n, spec.in_dim, generator=gen, device=device) * 2 - 1
  cots = tuple(torch.randn(n, c, generator=gen, device=device)
               for c in (1, spec.norm_dim, spec.width, spec.width,
                         spec.in_dim))
  runs = [fused_trunk.trunk_sigma_grad_backward(
      feat, weights, spec, cots, compute_dtype=bf16) for _ in range(2)]
  want_x, want_w = fused_trunk.trunk_sigma_grad_backward_reference(
      feat, weights, spec, cots, compute_dtype=bf16)
  torch.cuda.synchronize()
  got, again = ([x, *fused_trunk._flatten(w)] for x, w in runs)
  want = [want_x, *fused_trunk._flatten(want_w)]
  same = all(torch.equal(a, b) for a, b in zip(got, again))
  print(f' K1b bf16, N={n}: repeat launch bit-identical: {same}')
  if not same:
    raise AssertionError('K1b bf16: two launches on the same inputs differ')
  # Tolerance relative to each tensor's norm, over every row's contribution
  # to the grads: the kernel's roundings and masks fall as the plain
  # version's in-order f32 sums make them fall (resum), so what is left is
  # the order of the f32 sums (measured on an H100: at most 1.5e-6).
  rels = [((g - w).norm() / w.norm().clamp_min(1e-30)).item()
          for g, w in zip(got, want)]
  _, rows, flips = fused_trunk.check_bf16_rows(
      feat, weights, spec, got[0], want[0], cots, name='feat_bar')
  print(f'  feat_bar: {len(rows)} rows beyond atol 1e-3 + rtol 1e-2, '
        f'each reproduced with {sites_used(flips)}')
  print(f'  feat_bar and {len(got) - 1} grads: worst |got - want| / '
        f'|want| {max(rels):.3e} (feat_bar {rels[0]:.3e})')
  if max(rels) > 5e-3 or not all(bool(torch.isfinite(g).all())
                                 for g in got):
    raise AssertionError(f'K1b bf16 at N={n}: |got - want| / |want| '
                         f'{max(rels):.2e} > 5e-3')
  return max((g - w).abs().max().item() for g, w in zip(got, want)), \
      feat, cots, want


def scratch_floor_ms(n: int, depth: int, compute_dtype=None) -> float:
  """K1b's design floor on N rows: its device-memory scratch written once
  and read back once at the memory rate (not in its bound, which counts
  the work's inputs and outputs: a design may recompute instead)."""
  from nerfds_torch.kernels import fused_trunk
  nbytes = 4 * fused_trunk.backward_scratch_floats(n, depth, compute_dtype)
  return 1e3 * 2 * nbytes / PEAK_BYTES_PER_S


def check_plain_sums_in_order(torch, device, spec, weights):
  """The premise of the bf16 kernels' resum (csrc/trunk_mma.cuh): the
  plain bf16 version's products on the card (cuBLAS's float32 GEMM, TF32
  off) give the bits of float32 adds in k order, at the trunk's shapes,
  forward (h W) and reverse (c W^T)."""
  bf = lambda t: t.to(torch.bfloat16).float()
  gen = torch.Generator(device=device).manual_seed(11)
  w = bf(weights.layers[1][0])

  def in_order(a, b):
    s = torch.zeros(a.shape[0], b.shape[1], device=device)
    for k in range(a.shape[1]):
      s = s + a[:, k:k + 1] * b[k:k + 1, :]
    return s

  for n in (4099, 65_536):
    h = bf(torch.relu(torch.randn(n, spec.width, generator=gen,
                                  device=device)))
    c = bf(torch.randn(n, spec.width, generator=gen, device=device))
    for name, a, b in (('h W', h, w), ('c W^T', c, w.T)):
      same = torch.equal(a @ b, in_order(a, b.contiguous()))
      print(f'  the plain version\'s {name} at N={n}: the bits of float32 '
            f'adds in k order: {same}')
      if not same:
        raise AssertionError(f'{name} at N={n}: cuBLAS does not add in k '
                             'order, which resum reproduces')


def phase_trunk_bf16(torch, device):
  """Phase 10(a): K1f and K1b in their bf16-operand mode against their
  bf16 plain versions, at the render shape (K1f), the training shapes and
  a ragged N; each timed beside the float32 kernel on the same inputs."""
  from nerfds_torch.kernels import fused_trunk
  bf16 = torch.bfloat16
  print('== speed modes (a): K1f and K1b with bf16 operands vs their plain '
        'bf16 versions')
  spec, weights = nerf_ds_trunk(torch, device, seed=3)
  check_plain_sums_in_order(torch, device, spec, weights)
  names = ('sigma', 'normal', 'trunk_out', 'bottleneck', 'g')
  fwd = dict(name='fused_trunk_fwd_bf16', route='cuda',
             source='nerfds_torch/kernels/csrc/fused_trunk_fwd_bf16.cu',
             replaces='nerfds_tpu/pallas/fused_trunk.py:252',
             design=BF16_DESIGN, max_abs_err=0.0, library_ms=None)
  bwd = dict(name='fused_trunk_bwd_bf16', route='cuda',
             source='nerfds_torch/kernels/csrc/fused_trunk_bwd_bf16.cu',
             replaces='nerfds_tpu/pallas/fused_trunk.py:295',
             design=BF16_DESIGN, max_abs_err=0.0, library_ms=None)
  with torch.no_grad():
    for n in K1_BF16_FWD_SIZES:
      err, feat, want = check_trunk_fwd_bf16(torch, device, spec, weights, n)
      fwd['max_abs_err'] = max(fwd['max_abs_err'], err)
      if n == K1_BF16_FWD_SIZES[0]:
        # The float32 kernel against the same rule, which it must fail.
        f32 = fused_trunk.trunk_sigma_grad(feat, weights, spec)
        print('  the f32 kernel beyond that tolerance: ' + ', '.join(
            f'{name} {((g - w).abs() > 1e-3 + 1e-2 * w.abs()).float().mean().item():.2e}'
            for name, g, w in zip(names, f32, want)))
        try:
          fused_trunk.check_bf16_rows(feat, weights, spec, f32, want)
        except AssertionError as e:
          print(f'  the rule rejects the f32 kernel: {str(e)[:90]}')
        else:
          raise AssertionError('K1f: the f32 kernel meets the bf16 rule, so '
                               'the rule does not tell the modes apart')
        del f32
      del want
      bf16_fn = lambda: fused_trunk.trunk_sigma_grad(
          feat, weights, spec, compute_dtype=bf16)
      f32_fn = lambda: fused_trunk.trunk_sigma_grad(feat, weights, spec)
      ms, f32_ms = (device_ms(torch, fn, 10, match=TRUNK_KERNEL_MATCH)
                    for fn in (bf16_fn, f32_fn))
      wall_ms = time_ms(torch, bf16_fn, 10, warmup=2)
      plain_ms = time_ms(torch, lambda: fused_trunk.trunk_sigma_grad_reference(
          feat, weights, spec, compute_dtype=bf16), 3, warmup=1)
      bound_ms, bound_by, fma_ms = bf16_fwd_bound(spec, weights, n)
      print(f'  device time: bf16 kernel {ms:.3f} ms, f32 kernel '
            f'{f32_ms:.3f} ms; a bf16 call with its wrapper {wall_ms:.3f} '
            f'ms (events); plain bf16 {plain_ms:.3f} ms; bound '
            f'{bound_ms:.3f} ms ({bound_by}, bf16 tensor cores), f32-FMA '
            f'ceiling {fma_ms:.3f} ms: {bound_ms / ms:.1%} and '
            f'{fma_ms / ms:.1%}')
      if n == K1_BF16_FWD_SIZES[0]:
        fwd.update(ms=ms, f32_ms=f32_ms, wall_ms=wall_ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by, fma_ceiling_ms=fma_ms)
      elif n != 4099:
        fwd.update({f'{k}_n{n}': v for k, v in dict(
            ms=ms, f32_ms=f32_ms, wall_ms=wall_ms, plain_ms=plain_ms,
            bound_ms=bound_ms, fma_ceiling_ms=fma_ms).items()})
      del feat
    for n in K1B_SIZES:
      err, feat, cots, want = check_trunk_bwd_bf16(torch, device, spec,
                                                   weights, n)
      bwd['max_abs_err'] = max(bwd['max_abs_err'], err)
      if n == TRAIN_BATCH * 128:
        # The float32 kernel against the same tolerance, which it must fail.
        x32, w32 = fused_trunk.trunk_sigma_grad_backward(feat, weights, spec,
                                                         cots)
        rel32 = [((g - w).norm() / w.norm().clamp_min(1e-30)).item()
                 for g, w in zip([x32, *fused_trunk._flatten(w32)], want)]
        print(f'  the f32 kernel against the bf16 plain version: feat_bar '
              f'{rel32[0]:.3e}, the grads {min(rel32[1:]):.3e} to '
              f'{max(rel32[1:]):.3e}')
        if rel32[0] <= 5e-3 or max(rel32) <= 5e-3:
          raise AssertionError('K1b: the f32 kernel is within 5e-3 of the '
                               'bf16 plain version, so the tolerance does '
                               'not tell the modes apart')
        del x32, w32
      del want
      if n != 4099:
        bf16_fn = lambda: fused_trunk.trunk_sigma_grad_backward(
            feat, weights, spec, cots, compute_dtype=bf16)
        f32_fn = lambda: fused_trunk.trunk_sigma_grad_backward(
            feat, weights, spec, cots)
        ms, f32_ms = (device_ms(torch, fn, 10, match=TRUNK_KERNEL_MATCH)
                      for fn in (bf16_fn, f32_fn))
        wall_ms = time_ms(torch, bf16_fn, 10, warmup=2)
        plain_ms = time_ms(
            torch, lambda: fused_trunk.trunk_sigma_grad_backward_reference(
                feat, weights, spec, cots, compute_dtype=bf16), 3, warmup=1)
        torch.cuda.reset_peak_memory_stats()
        fused_trunk.trunk_sigma_grad_backward(feat, weights, spec, cots,
                                              compute_dtype=bf16)
        torch.cuda.synchronize()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        bound_ms, bound_by, fma_ms = bf16_bwd_bound(spec, weights, n)
        floor_ms = scratch_floor_ms(n, spec.depth, bf16)
        print(f'  device time: bf16 kernel {ms:.3f} ms, f32 kernel '
              f'{f32_ms:.3f} ms; a bf16 call with its wrapper {wall_ms:.3f} '
              f'ms (events); plain bf16 {plain_ms:.3f} ms; bound '
              f'{bound_ms:.3f} ms ({bound_by}), f32-FMA ceiling '
              f'{fma_ms:.3f} ms: '
              f'{bound_ms / ms:.1%} and {fma_ms / ms:.1%}; scratch floor '
              f'{floor_ms:.3f} ms (f32 {scratch_floor_ms(n, spec.depth):.3f}); '
              f'peak memory of a call {peak_gib:.2f} GiB (scratch '
              f'{4 * fused_trunk.backward_scratch_floats(n, spec.depth, bf16) / 2**30:.2f} GiB)')
        parts = profile_device(
            torch, lambda: fused_trunk.trunk_sigma_grad_backward(
                feat, weights, spec, cots, compute_dtype=bf16),
            f'K1b bf16 at N={n}', top=4)
        split = bwd_kernel_split(parts)
        print(f'  K1b bf16 at N={n} by kernel: sweep {split["sweep_ms"]:.3f} '
              f'ms, weight grads {split["wgrad_ms"]:.3f} ms, reduction '
              f'{split["reduce_ms"]:.3f} ms')
        vals = dict(ms=ms, f32_ms=f32_ms, wall_ms=wall_ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by,
                    fma_ceiling_ms=fma_ms, scratch_floor_ms=floor_ms,
                    peak_gib=peak_gib, **split)
        if n == TRAIN_BATCH * 128:
          bwd.update(vals)
        else:
          bwd.update({f'{k}_n{n}': v for k, v in vals.items()
                      if k != 'bound_by'})
      del feat, cots
  return [fwd, bwd]


class plain_trunk_kernels:
  """Within the block, K1f's and K1b's wrappers run their plain versions on
  CUDA tensors too: the plain path of a 'fused' model on the card (a check
  of this script; the package's wrappers launch the kernels there)."""

  def __enter__(self):
    from nerfds_torch.kernels import fused_trunk
    self.module, self.saved = fused_trunk, (fused_trunk._launch,
                                            fused_trunk._launch_backward)
    fused_trunk._launch = (
        lambda feat, weights, spec, operands=None, compute_dtype=None:
        fused_trunk.trunk_sigma_grad_reference(feat, weights, spec,
                                               compute_dtype))
    fused_trunk._launch_backward = (
        lambda feat, weights, spec, cots, operands=None, compute_dtype=None:
        fused_trunk.trunk_sigma_grad_backward_reference(
            feat, weights, spec, cots, compute_dtype))
    return self

  def __exit__(self, *exc):
    self.module._launch, self.module._launch_backward = self.saved


def train_mode(torch, device, trainer, name, cfg, plain_cfg=None,
               plain_ctx=None, train_cfg=None, steps=TRAIN_STEPS,
               stat_keys=(), **want):
  """``steps`` steps of ``cfg`` through Trainer.train on ``trainer``'s
  store, with ``train_cfg`` (default: ``trainer``'s); the launches must be
  ``want`` (0 for the rest), the losses finite and every logged step must
  hold the stats ``stat_keys``, each finite (``('coarse', 'loss/elastic')``
  for a level's, ``('loss/background',)`` for the step's).
  With ``plain_cfg`` (and ``plain_ctx``, a context the plain path runs in)
  the trained state's gradients on one batch (with the background loss's
  points where the config asks for that loss) are held against the plain
  path's. Returns (launches, numbers)."""
  import numpy as np
  from nerfds_torch import kernels
  from nerfds_torch.datasets import sample_batch
  from nerfds_torch.models import NerfDSModel
  from nerfds_torch.trainer import Trainer
  from nerfds_torch.training import step as step_lib
  batch_size = TRAIN_BATCH
  train_cfg = train_cfg or trainer.train_cfg
  run = Trainer.from_experiment(cfg, train_cfg, trainer.datasource)
  store = trainer.build_store()
  losses = []

  def log_fn(step, log):
    stats = log['stats']
    losses.append(stats['fine' if 'fine' in stats else 'coarse']
                  ['loss/total'])
    for *level, key in stat_keys:
      value = (stats[level[0]] if level else stats).get(key, float('nan'))
      if not np.isfinite(value):
        raise AssertionError(f'{name}: step {step} {level} {key} = {value}')

  kernels.reset_launch_counts()
  start = time.perf_counter()
  state = run.train(num_steps=steps, store=store, log_fn=log_fn)
  torch.cuda.synchronize()
  seconds = time.perf_counter() - start
  launches = dict(kernels.launch_counts)
  print(f' {name}: {steps} steps in {seconds:.2f} s, fine loss '
        f'{losses[0]:.5f} -> {losses[-1]:.5f}')
  check_launches(name, launches, **{k: v * steps for k, v in want.items()})
  if not (len(losses) == steps and np.isfinite(losses).all()):
    raise AssertionError(f'{name}: training losses {losses}')
  out = dict(seconds=seconds, loss_first=losses[0], loss_last=losses[-1])
  if plain_cfg is None:
    return launches, out
  plain = NerfDSModel(plain_cfg, num_warp_embeds=run.model.num_warp_embeds,
                      num_hyper_embeds=run.model.num_hyper_embeds,
                      num_nerf_embeds=run.model.num_nerf_embeds,
                      near=run.model.near, far=run.model.far, device=device)
  scalars = step_lib.eval_schedules(step_lib.build_schedules(train_cfg),
                                    state.step)
  gen = lambda: torch.Generator(device=device).manual_seed(321)
  batch = sample_batch(store, gen(), batch_size)
  if run.background_points() is not None:
    batch['background_points'] = run.background_points()
  got, _ = step_lib._grads(step_lib.make_loss_fn(run.model, train_cfg),
                           state.params, batch, gen(), scalars)
  import contextlib
  with plain_ctx or contextlib.nullcontext():
    want, _ = step_lib._grads(step_lib.make_loss_fn(plain, train_cfg),
                              state.params, batch, gen(), scalars)
  torch.cuda.synchronize()
  rels = {k: ((got[k] - w).norm() / w.norm().clamp_min(1e-30)).item()
          for k, w in want.items()}
  worst = max(rels, key=rels.get)
  print(f'  gradients vs the plain path, |got - want| / |want| over '
        f'{len(rels)} tensors: worst {rels[worst]:.3e} ({worst}), median '
        f'{float(np.median(list(rels.values()))):.3e}')
  out.update(grad_rel_worst=rels[worst], grad_rel_median=float(
      np.median(list(rels.values()))))
  return launches, out, rels, (state, batch, scalars, run)


def phase_speed_modes(torch, device, trainer):
  """Phase 10 (b)-(e): the speed and precision modes at the full width of
  nerf_ds(), on the train phase's synthetic store."""
  import dataclasses
  import tempfile
  import numpy as np
  from nerfds_torch import config as config_lib
  from nerfds_torch import kernels
  from nerfds_torch import train as train_cli
  print('== speed modes (b)-(e): nerf_ds_fast, bf16 zones with K1 in bf16, '
        'bf16 storage, quality_ablate; nerf_ds() at full width, batch '
        f'{TRAIN_BATCH}, {TRAIN_STEPS} steps')
  out, launches = {}, {}
  # (b) nerf_ds_fast: top-k acts in 'vmap' mode, so K1 never runs; K2
  # composites both levels.
  fast = dataclasses.replace(config_lib.nerf_ds_fast(),
                             use_pallas_compositing=True)
  launches['fast'], out['fast'], rels, _ = train_mode(
      torch, device, trainer, 'nerf_ds_fast', fast,
      plain_cfg=dataclasses.replace(fast, use_pallas_compositing=False),
      composite_fwd=2)
  # Tolerance relative to each tensor's norm: float32; K2 sums in another
  # order than torch.cumprod.
  if max(rels.values()) > 1e-3:
    raise AssertionError(f'nerf_ds_fast gradients: {max(rels.values()):.2e}')
  # The same preset through the train CLI, a few steps on the card.
  with tempfile.TemporaryDirectory() as tmp:
    kernels.reset_launch_counts()
    start = time.perf_counter()
    state, metrics, _ = train_cli.main([
        '--preset', 'nerf_ds_fast', '--datasource', 'synthetic', '--exp_dir',
        tmp, '--batch_size', str(TRAIN_BATCH), '--max_steps', '6', '--set',
        'model.use_pallas_compositing=True'])
    torch.cuda.synchronize()
    cli = dict(kernels.launch_counts)
  print(f'  train CLI --preset nerf_ds_fast: 6 steps and its closing eval in '
        f'{time.perf_counter() - start:.1f} s, launches {cli}, val psnr '
        f'{metrics["psnr"]:.2f}')
  if (state.step != 6 or not np.isfinite(metrics['psnr'])
      or cli['composite_fwd'] < 12 or cli['composite_fwd'] % 2
      or not k3_in_evals_only(cli, 6)
      or kernel_launches(cli) != cli['composite_fwd'] + cli['fused_mlp_fwd']):
    raise AssertionError(f'train CLI nerf_ds_fast: step {state.step}, '
                         f'launches {cli}, metrics {metrics}')
  out['fast']['cli_launches'] = cli
  # (c) bf16 compute in the trunk, rgb and mask zones, 'fused': K1f and K1b
  # in bf16 twice a step, never in float32; held against the same model
  # with K1's plain bf16 versions and plain compositing.
  zones = dataclasses.replace(
      config_lib.nerf_ds(), compute_dtype='bfloat16',
      bf16_zones=('trunk', 'rgb', 'mask'), sigma_gradient_mode='fused',
      use_pallas_compositing=True)
  launches['bf16'], out['bf16'], rels, (state, batch, scalars, run) = (
      train_mode(torch, device, trainer, 'bf16 zones', zones,
                 plain_cfg=dataclasses.replace(zones,
                                               use_pallas_compositing=False),
                 plain_ctx=plain_trunk_kernels(), composite_fwd=2,
                 fused_trunk_fwd_bf16=2, fused_trunk_bwd_bf16=2))
  # Tolerance relative to each tensor's norm: bf16 rounding boundaries, as
  # in phase (a), through the whole step.
  if max(rels.values()) > 1e-2:
    raise AssertionError(f'bf16 zones gradients: {max(rels.values()):.2e}')
  # What the bf16 mode changes: the same state and batch with K1 in float32.
  from nerfds_torch.training import step as step_lib
  gen = lambda: torch.Generator(device=device).manual_seed(321)
  f32_model = type(run.model)(
      dataclasses.replace(zones, compute_dtype=None),
      num_warp_embeds=run.model.num_warp_embeds,
      num_hyper_embeds=run.model.num_hyper_embeds, near=run.model.near,
      far=run.model.far, device=device)
  got, _ = step_lib._grads(step_lib.make_loss_fn(run.model, run.train_cfg),
                           state.params, batch, gen(), scalars)
  f32, _ = step_lib._grads(step_lib.make_loss_fn(f32_model, run.train_cfg),
                           state.params, batch, gen(), scalars)
  f32_rels = [((got[k] - w).norm() / w.norm().clamp_min(1e-30)).item()
              for k, w in f32.items()]
  out['bf16']['f32_grad_rel_median'] = float(np.median(f32_rels))
  print(f'  the float32 model on the same state and batch: |bf16 - f32| / '
        f'|f32| median {np.median(f32_rels):.3e}, worst {max(f32_rels):.3e}')
  del got, f32, state, batch, run, f32_model
  # (d) bf16 activation storage, 'fused' with K1 in float32.
  storage = dataclasses.replace(
      config_lib.nerf_ds(), storage_dtype='bfloat16',
      sigma_gradient_mode='fused', use_pallas_compositing=True)
  launches['storage'], out['storage'] = train_mode(
      torch, device, trainer, 'bf16 storage', storage, composite_fwd=2,
      fused_trunk_fwd=2, fused_trunk_bwd=2)
  # (e) The paired-seed gate's CLI on the card: two cases, two seeds.
  argv = [sys.executable, '-m', 'nerfds_torch.quality_ablate', '--cases',
          'f32,topk16', '--seeds', '0,1', '--steps', str(GATE_STEPS)]
  start = time.perf_counter()
  done = subprocess.run(argv, capture_output=True, text=True, timeout=900)
  seconds = time.perf_counter() - start
  lines = done.stdout.strip().splitlines()
  rows = [json.loads(x) for x in lines if x.startswith('{')]
  print(f'  {" ".join(argv[1:])}: {seconds:.1f} s, exit {done.returncode}')
  for x in lines:
    print(f'    {x}')
  if (done.returncode != 0 or [(r['case'], r['seed']) for r in rows] != [
      ('f32', 0), ('f32', 1), ('topk16', 0), ('topk16', 1)]
      or not lines[-1].startswith('PAIRED_SUMMARY ')
      or not all(np.isfinite(r['val_psnr']) for r in rows)):
    raise AssertionError(f'quality_ablate: {done.stderr[-3000:]}')
  out['quality_ablate'] = dict(seconds=seconds, rows=rows, summary=json.loads(
      lines[-1][len('PAIRED_SUMMARY '):]))
  return launches, out


# Phase 11: BASELINE config[2]'s losses at the JAX package's own test of
# them, its samples (configs/hypernerf.json), the steps of its AP run and of
# the train CLI's run, and the hyper embedding of its AP slicing (the
# coordinates themselves, so hyper_num_dims wide).
CONFIG2_LOSSES = dict(use_elastic_loss=True, use_background_loss=True,
                      background_loss_weight=1.0, use_hyper_reg_loss=True,
                      hyper_reg_loss_weight=0.001)
CONFIG2_SAMPLES = 128
AP_STEPS = 12
CLI_STEPS = 6
AP_SLICING = dict(hyper_slice_method='axis_aligned_plane',
                  hyper_use_warp_embed=False, hyper_embed_dims=2)


def steady_step_s(torch, device, step_fn, state, n=TRAIN_TIMED_STEPS):
  """Seconds a step over ``n`` steady steps of ``step_fn`` from ``state``,
  after two warm-up steps; the card synchronised at both ends."""
  g = torch.Generator(device=device)
  for i in range(2):
    g.manual_seed(40_000 + i)
    state, _ = step_fn(state, g)
  torch.cuda.synchronize()
  start = time.perf_counter()
  for i in range(n):
    g.manual_seed(50_000 + i)
    state, _ = step_fn(state, g)
  torch.cuda.synchronize()
  return (time.perf_counter() - start) / n


def phase_deformation(torch, device, trainer):
  """Phase 11: the deformation family of BASELINE config[2] at full width
  on the train phase's synthetic store (its ``load_points`` gives the
  background loss's static points)."""
  import dataclasses
  import tempfile
  from pathlib import Path
  import numpy as np
  from nerfds_torch import config as config_lib
  from nerfds_torch import kernels
  from nerfds_torch import train as train_cli
  from nerfds_torch.trainer import Trainer
  from nerfds_torch.training import step as step_lib
  print('== deformation family: BASELINE config[2] (hypernerf(), '
        f'{CONFIG2_SAMPLES} + {CONFIG2_SAMPLES} samples, elastic, background '
        'and hyper-reg losses) DS and AP, and the dual-quaternion nerf_ds() '
        f"with the elastic loss and 'fused' ∇σ; batch {TRAIN_BATCH}")
  out, launches = {}, {}
  # The preset's schedules compressed to the run (as --scale_schedules
  # does): the warp's posenc window opens within a few steps, so the warp
  # depends on x and its Jacobian is not a constant rotation.
  scaled = dataclasses.replace(
      config_lib.nerf_ds_train_config(max_steps=TRAIN_STEPS,
                                      batch_size=TRAIN_BATCH,
                                      scale_schedules=True), print_every=1)
  train_cfg = dataclasses.replace(scaled, **CONFIG2_LOSSES)
  ds = dataclasses.replace(config_lib.hypernerf(),
                           num_coarse_samples=CONFIG2_SAMPLES,
                           num_fine_samples=CONFIG2_SAMPLES,
                           use_pallas_compositing=True)
  keys = (('coarse', 'loss/elastic'), ('coarse', 'loss/hyper_reg'),
          ('loss/background',))
  # Tolerance relative to each tensor's norm, as in phase 7: float32; K2
  # sums in another order than torch.cumprod.
  for name, cfg, steps in (('config2_ds', ds, TRAIN_STEPS),
                           ('config2_ap', dataclasses.replace(
                               ds, **AP_SLICING), AP_STEPS)):
    launches[name], out[name], rels, (state, _, _, run) = train_mode(
        torch, device, trainer, name, cfg,
        plain_cfg=dataclasses.replace(cfg, use_pallas_compositing=False),
        train_cfg=train_cfg, steps=steps, stat_keys=keys, composite_fwd=2)
    if max(rels.values()) > 1e-3:
      raise AssertionError(f'{name} gradients: {max(rels.values()):.2e}')
    if name != 'config2_ds':
      continue
    # The steady step with the Jacobian (and so the elastic loss) on and
    # off, in turns; then one step profiled and one under the sync check.
    store, points = trainer.build_store(), run.background_points()
    steps_fn = {
        on: step_lib.make_fused_train_step(
            run.model, dataclasses.replace(train_cfg, use_elastic_loss=on),
            store, points) for on in (True, False)}
    times = {True: [], False: []}
    for on in (True, False, False, True):
      times[on].append(steady_step_s(torch, device, steps_fn[on], state))
    out[name]['step_ms'] = 1e3 * float(np.mean(times[True]))
    out[name]['step_ms_without_jacobian'] = 1e3 * float(np.mean(times[False]))
    print(f'  config[2] DS steady step: {out[name]["step_ms"]:.1f} ms with '
          f'the Jacobian ({", ".join(f"{1e3 * x:.1f}" for x in times[True])}'
          f'), {out[name]["step_ms_without_jacobian"]:.1f} ms without ('
          f'{", ".join(f"{1e3 * x:.1f}" for x in times[False])})')
    g = torch.Generator(device=device)
    g.manual_seed(60_000)
    box = [steps_fn[True](state, g)[0]]

    def one_step(g=g, box=box):
      box[0] = steps_fn[True](box[0], g)[0]

    profile = profile_device(torch, one_step, 'config[2] DS training step')
    out[name]['device_ms'] = sum(profile.values())
    syncs = host_syncs(torch, one_step)
    out[name]['host_syncs'] = sum(syncs.values())
    print(f'  host synchronisations in one config[2] DS step: '
          f'{sum(syncs.values())}, at {syncs}')
    del state, run, steps_fn, box
  # (c) The dual-quaternion nerf_ds with the elastic loss and 'fused' ∇σ:
  # the normal transport goes through the dual-quaternion motion into K1.
  dq = dataclasses.replace(config_lib.nerf_ds(),
                           warp_field_type='dual_quaternion',
                           sigma_gradient_mode='fused',
                           use_pallas_compositing=True)
  launches['nerf_ds_dq'], out['nerf_ds_dq'], rels, _ = train_mode(
      torch, device, trainer, 'nerf_ds dual quaternion', dq,
      plain_cfg=dataclasses.replace(dq, sigma_gradient_mode='vmap',
                                    use_pallas_compositing=False),
      train_cfg=dataclasses.replace(scaled, use_elastic_loss=True),
      stat_keys=(('coarse', 'loss/elastic'),), fused_trunk_fwd=2,
      fused_trunk_bwd=2, composite_fwd=2)
  # Tolerance as in phase 7: relu kinks may fall on the other side.
  if max(rels.values()) > 1e-3:
    raise AssertionError(f'nerf_ds dual quaternion gradients: '
                         f'{max(rels.values()):.2e}')
  # (d) The train CLI with --preset hypernerf and config[2]'s overrides.
  overrides = [f'train.{k}={v}' for k, v in CONFIG2_LOSSES.items()] + [
      f'model.num_coarse_samples={CONFIG2_SAMPLES}',
      f'model.num_fine_samples={CONFIG2_SAMPLES}',
      'model.use_pallas_compositing=True']
  with tempfile.TemporaryDirectory() as tmp:
    kernels.reset_launch_counts()
    start = time.perf_counter()
    state, metrics, _ = train_cli.main([
        '--preset', 'hypernerf', '--datasource', 'synthetic', '--exp_dir',
        tmp, '--batch_size', str(TRAIN_BATCH), '--max_steps', str(CLI_STEPS),
        '--scale_schedules', *(a for kv in overrides for a in ('--set', kv))])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    cli = dict(kernels.launch_counts)
    logged = [json.loads(x) for x in (
        Path(tmp) / 'summaries' / 'metrics.jsonl').read_text().splitlines()]
  print(f'  train CLI --preset hypernerf with config[2]: {CLI_STEPS} steps '
        f'and its closing eval in {seconds:.1f} s, launches {cli}, val psnr '
        f'{metrics["psnr"]:.2f}, logged loss/elastic '
        f'{[x.get("train/coarse/loss/elastic") for x in logged]}')
  if (state.step != CLI_STEPS or not np.isfinite(metrics['psnr'])
      or not logged or not all(np.isfinite(x.get(
          'train/coarse/loss/elastic', np.nan)) for x in logged)
      or cli['composite_fwd'] < 2 * CLI_STEPS or cli['composite_fwd'] % 2
      # No mask MLP: the SE(3) trunk, the sheet and the trunk of each level.
      or not k3_in_evals_only(cli, CLI_STEPS, per_chunk=6)
      or kernel_launches(cli) != cli['composite_fwd'] + cli['fused_mlp_fwd']):
    raise AssertionError(f'train CLI hypernerf: step {state.step}, launches '
                         f'{cli}, metrics {metrics}, logged {logged}')
  out['cli'] = dict(seconds=seconds, launches=cli)
  return launches, out


# Phase 12: the radiance branch's variants of nerf_ds(), their steps, the
# train CLI's steps, K1's new head shapes (norm_dim, has_bottleneck) and
# the rows they are checked at (a training level's and a ragged N).
RADIANCE_STEPS = 12
RADIANCE_HEADS = ((0, True), (3, False))
RADIANCE_K1_SIZES = (TRAIN_BATCH * 128, 4099)
SIGMA_NORMALS = dict(predict_norm=False, use_predicted_norm=False,
                     use_sigma_gradient=True, stop_norm_gradient=False,
                     use_ref_radiance=True)
HYPER_C_CANONICAL = dict(use_hyper_c=True, hyper_c_hyper_input=True,
                         use_ref_radiance=True,
                         norm_supervision_type='canonical')
DIRECT_CONDITIONS = dict(
    norm_supervision_type='direct', screw_input_mode='full',
    window_x_in_rgb_condition=True, use_delta_x_in_rgb_condition=True,
    use_hyper_for_rgb=True, use_mask_in_rgb=True,
    use_coarse_depth_for_mask=True, clamp_predicted_mask=True,
    use_mask_sharp_weights=False, use_mask_scaled_weights=True)


def float32_floor(torch, device, plain, train_cfg, state, batch, scalars):
  """Per tensor, |g' − g| / |g| of the plain path's gradients g on
  ``state`` and ``batch`` (train_mode's draws), g' with the rays' origins
  moved by one ulp: the step's own float32 sensitivity. Where ∇σ feeds the
  colour it is large: normalize(∇σ) multiplies rounding by 1/|∇σ|, and
  |∇σ| is small wherever the density is nearly flat."""
  from nerfds_torch.training import step as step_lib
  gen = lambda: torch.Generator(device=device).manual_seed(321)
  loss_fn = step_lib.make_loss_fn(plain, train_cfg)
  want, _ = step_lib._grads(loss_fn, state.params, batch, gen(), scalars)
  origins = batch['origins']
  nudged = dict(batch, origins=torch.nextafter(
      origins, torch.full_like(origins, float('inf'))))
  moved, _ = step_lib._grads(loss_fn, state.params, nudged, gen(), scalars)
  return {k: ((moved[k] - w).norm() / w.norm().clamp_min(1e-30)).item()
          for k, w in want.items()}


def check_grads(name, rels, floor):
  """Every gradient within 1e-3 of the plain path's, relative to its norm
  (phase 7's tolerance), or, where the step's own float32 floor (worst
  tensor) exceeds half of that, within twice the floor. Returns the
  bound."""
  import numpy as np
  bound = max(1e-3, 2 * max(floor.values()))
  worst = max(rels, key=rels.get)
  print(f'  {name}: float32 floor (origins moved one ulp) worst '
        f'{max(floor.values()):.3e}, median '
        f'{float(np.median(list(floor.values()))):.3e}; bound {bound:.3e}; '
        f'kernel vs plain worst {rels[worst]:.3e} ({worst})')
  if rels[worst] > bound:
    raise AssertionError(f'{name} gradients: {rels[worst]:.2e} > {bound:.2e}')
  return bound


def phase_trunk_heads(torch, device):
  """Phase 12, first part: K1f and K1b at the two head shapes that the
  radiance variants give K1, a one-column head (σ only, ``norm_dim`` 0)
  with a bottleneck and a σ + normal head without one, against their plain
  versions at a training level's rows and a ragged N, by the rules of
  phases 3 and 5; each timed beside its bound at the training rows.
  Returns {'fwd': {...}, 'bwd': {...}} keyed by head."""
  from nerfds_torch.kernels import fused_trunk
  names = ('sigma', 'normal', 'trunk_out', 'bottleneck', 'g')
  bf16 = torch.bfloat16
  out = {'fwd': {}, 'bwd': {}, 'fwd_bf16': {}, 'bwd_bf16': {}}
  for norm_dim, has_bn in RADIANCE_HEADS:
    head = f'norm{norm_dim}_bottleneck{int(has_bn)}'
    print(f'== K1f and K1b at norm_dim={norm_dim}, has_bottleneck={has_bn}')
    spec, weights = nerf_ds_trunk(torch, device, seed=12 + norm_dim,
                                  norm_dim=norm_dim, has_bottleneck=has_bn)
    fwd_err, bwd_err = 0.0, 0.0
    with torch.no_grad():
      for n in RADIANCE_K1_SIZES:
        gen = torch.Generator(device=device).manual_seed(n + norm_dim)
        feat = torch.rand(n, spec.in_dim, generator=gen, device=device) * 2 - 1
        got = fused_trunk.trunk_sigma_grad(feat, weights, spec)
        want = fused_trunk.trunk_sigma_grad_reference(feat, weights, spec)
        torch.cuda.synchronize()
        print(f' K1f N={n}')
        if (got[1] is None) != (norm_dim == 0):
          raise AssertionError(f'K1f {head}: normal output {got[1]}')
        for name, g, w in zip(names, got, want):
          # Tolerance and the share of g's kink elements as in phase 3.
          fwd_err = max(fwd_err, compare(torch, name, g, w, 1e-4, 1e-4,
                                         1e-3 if name == 'g' else 0.0))
        del got, want
        if n == RADIANCE_K1_SIZES[0]:
          ms = time_ms(torch, lambda: fused_trunk.trunk_sigma_grad(
              feat, weights, spec), 3, warmup=1)
          plain_ms = time_ms(
              torch, lambda: fused_trunk.trunk_sigma_grad_reference(
                  feat, weights, spec), 3, warmup=1)
          bound_ms, bound_by = trunk_fwd_bound(spec, weights, n)
          print(f'  K1f time: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, '
                f'bound {bound_ms:.3f} ms ({bound_by}): {bound_ms / ms:.1%} '
                'of the bound')
          out['fwd'][head] = dict(n=n, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by)
        del feat
        print(f' K1b N={n}')
        err, feat, cots = check_trunk_bwd(torch, device, spec, weights, n)
        bwd_err = max(bwd_err, err)
        if n == RADIANCE_K1_SIZES[0]:
          ms = time_ms(torch, lambda: fused_trunk.trunk_sigma_grad_backward(
              feat, weights, spec, cots), 3, warmup=1)
          plain_ms = time_ms(
              torch, lambda: fused_trunk.trunk_sigma_grad_backward_reference(
                  feat, weights, spec, cots), 3, warmup=1)
          bound_ms, bound_by, tflop, mbytes = trunk_bwd_bound(spec, weights,
                                                              n)
          print(f'  K1b time: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, '
                f'bound {bound_ms:.3f} ms ({tflop:.4f} TFLOP, {mbytes:.1f} '
                f'MB): {bound_ms / ms:.1%} of the bound')
          out['bwd'][head] = dict(n=n, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by)
        del feat, cots
        # The bf16-operand kernels at this head, by phase 10(a)'s rule.
        errs = [check_trunk_fwd_bf16(torch, device, spec, weights, n)[0]]
        err, feat, cots, _ = check_trunk_bwd_bf16(torch, device, spec,
                                                  weights, n)
        errs.append(err)
        for key, e in zip(('fwd_bf16', 'bwd_bf16'), errs):
          entry = out[key].setdefault(head, dict(max_abs_err=0.0))
          entry['max_abs_err'] = max(entry['max_abs_err'], e)
        if n == RADIANCE_K1_SIZES[0]:
          for key, fn in (
              ('fwd_bf16', lambda: fused_trunk.trunk_sigma_grad(
                  feat, weights, spec, compute_dtype=bf16)),
              ('bwd_bf16', lambda: fused_trunk.trunk_sigma_grad_backward(
                  feat, weights, spec, cots, compute_dtype=bf16))):
            f32_fn = ((lambda: fused_trunk.trunk_sigma_grad(
                feat, weights, spec)) if key == 'fwd_bf16' else
                (lambda: fused_trunk.trunk_sigma_grad_backward(
                    feat, weights, spec, cots)))
            ms, f32_ms = (device_ms(torch, f, 3, match=TRUNK_KERNEL_MATCH)
                          for f in (fn, f32_fn))
            print(f'  K1{key[0]} bf16 device time: {ms:.3f} ms (f32 kernel '
                  f'{f32_ms:.3f} ms)')
            out[key][head].update(n=n, ms=ms, f32_ms=f32_ms)
        del feat, cots
    out['fwd'][head]['max_abs_err'] = fwd_err
    out['bwd'][head]['max_abs_err'] = bwd_err
  return out


def phase_radiance(torch, device, trainer, train):
  """Phase 12: the radiance branch's variants of nerf_ds() at full width,
  batch 512, on the train phase's synthetic store: (a) ∇σ as the colour's
  normal with the reflected view direction (K1 with a σ-only head), (b)
  hyper-c with the reflection and the 'canonical' normal target (K1
  without a bottleneck), (c) the 'direct' target with the screw, window,
  Δx, hyper and mask conditions and the mask flags; each 12 steps on the
  kernel path (K1f, K1b and K2 twice a step), its gradients against the
  plain path's ('vmap', plain compositing) on one state and batch, its
  steady step on both paths in turns and its host waits a step beside
  phase 7's. (d) The ∇σ modes 'jvp', 'vjp' and 'naive', one step each
  (K2 only), gradients against 'vmap'. (e) The train CLI with (a)'s
  overrides."""
  import dataclasses
  import tempfile
  from pathlib import Path
  import numpy as np
  from nerfds_torch import config as config_lib
  from nerfds_torch import kernels
  from nerfds_torch import train as train_cli
  from nerfds_torch.training import step as step_lib
  print('== radiance variants of nerf_ds() at full width, batch '
        f'{TRAIN_BATCH}: (a) sigma_normals, (b) hyper_c_canonical, (c) '
        "direct_conditions, 'fused' ∇σ and K2; (d) the ∇σ modes jvp, vjp, "
        'naive; (e) the train CLI')
  out, launches = {}, {}
  # The preset's schedules compressed to the run (as --scale_schedules
  # does): the normal input's and the window's posenc open within a few
  # steps, so the colour reads ∇σ, the reflection and the points.
  train_cfg = dataclasses.replace(
      config_lib.nerf_ds_train_config(max_steps=TRAIN_STEPS,
                                      batch_size=TRAIN_BATCH,
                                      scale_schedules=True), print_every=1)
  variants = (('sigma_normals', SIGMA_NORMALS),
              ('hyper_c_canonical', HYPER_C_CANONICAL),
              ('direct_conditions', DIRECT_CONDITIONS))
  for name, flags in variants:
    cfg = dataclasses.replace(config_lib.nerf_ds(), **flags,
                              sigma_gradient_mode='fused',
                              use_pallas_compositing=True)
    plain_cfg = dataclasses.replace(cfg, sigma_gradient_mode='vmap',
                                    use_pallas_compositing=False)
    launches[name], out[name], rels, (state, batch, scalars, run) = (
        train_mode(torch, device, trainer, name, cfg, plain_cfg=plain_cfg,
                   train_cfg=train_cfg, steps=RADIANCE_STEPS,
                   stat_keys=(('fine', 'loss/rgb'), ('coarse', 'loss/rgb')),
                   fused_trunk_fwd=2, fused_trunk_bwd=2, composite_fwd=2))
    plain = type(run.model)(plain_cfg,
                            num_warp_embeds=run.model.num_warp_embeds,
                            num_hyper_embeds=run.model.num_hyper_embeds,
                            near=run.model.near, far=run.model.far,
                            device=device)
    # Tolerance as in phase 7 (float32, relu kinks may fall on the other
    # side, K2 sums in another order than torch.cumprod), or the step's
    # own float32 floor where that is larger.
    floor = float32_floor(torch, device, plain, train_cfg, state, batch,
                          scalars)
    out[name]['grad_floor_worst'] = max(floor.values())
    out[name]['grad_bound'] = check_grads(name, rels, floor)
    del batch
    # Steady steps of both paths in turns, then the host's waits.
    store = trainer.build_store()
    steps_fn = {
        'kernel': step_lib.make_fused_train_step(run.model, train_cfg, store),
        'plain': step_lib.make_fused_train_step(plain, train_cfg, store)}
    times = {'kernel': [], 'plain': []}
    for path in ('kernel', 'plain', 'plain', 'kernel'):
      times[path].append(steady_step_s(torch, device, steps_fn[path], state))
    for path in ('kernel', 'plain'):
      out[name][f'{path}_step_ms'] = 1e3 * float(np.mean(times[path]))
    # One step of each path profiled (device busy time, ops, idle share),
    # then the kernel path's host waits.
    for path in ('plain', 'kernel'):
      g = torch.Generator(device=device)
      g.manual_seed(70_000)
      box = [steps_fn[path](state, g)[0]]

      def one_step(g=g, box=box, step_fn=steps_fn[path]):
        box[0] = step_fn(box[0], g)[0]

      stats = {}
      profile_device(torch, one_step, f'{name} {path}-path training step',
                     stats=stats)
      out[name].update({f'{path}_{k}': v for k, v in stats.items()})
    syncs = host_syncs(torch, one_step)
    out[name]['host_syncs'] = sum(syncs.values())
    print(f'  {name} steady step: kernel path {out[name]["kernel_step_ms"]:.1f}'
          f' ms ({", ".join(f"{1e3 * x:.1f}" for x in times["kernel"])}), '
          f'plain path {out[name]["plain_step_ms"]:.1f} ms ('
          f'{", ".join(f"{1e3 * x:.1f}" for x in times["plain"])}); host '
          f'syncs a step {sum(syncs.values())} at {syncs}; phase 7 '
          f'(nerf_ds()): kernel {train["kernel"]["step_ms"]:.1f} ms, plain '
          f'{train["plain"]["step_ms"]:.1f} ms, host syncs a step '
          f'{train["kernel"]["host_syncs"]}')
    del state, run, plain, steps_fn, box, store
  # (d) The other ∇σ modes of nerf_ds(): plain PyTorch on every device, as
  # in JAX, where only 'fused' reaches a kernel. One step each, gradients
  # against 'vmap' on the state it reached.
  for mode in ('jvp', 'vjp', 'naive'):
    cfg = dataclasses.replace(config_lib.nerf_ds(), sigma_gradient_mode=mode,
                              use_pallas_compositing=True)
    vmap_cfg = dataclasses.replace(cfg, sigma_gradient_mode='vmap')
    launches[mode], out[mode], rels, (state, batch, scalars, run) = (
        train_mode(torch, device, trainer, f"'{mode}' ∇σ", cfg,
                   plain_cfg=vmap_cfg, train_cfg=train_cfg, steps=1,
                   composite_fwd=2))
    vmap = type(run.model)(vmap_cfg, num_warp_embeds=run.model.num_warp_embeds,
                           num_hyper_embeds=run.model.num_hyper_embeds,
                           near=run.model.near, far=run.model.far,
                           device=device)
    floor = float32_floor(torch, device, vmap, train_cfg, state, batch,
                          scalars)
    out[mode]['grad_floor_worst'] = max(floor.values())
    out[mode]['grad_bound'] = check_grads(f"'{mode}' against 'vmap'", rels,
                                          floor)
    del state, batch, run, vmap
  # (e) The train CLI with (a)'s overrides, 'fused' and K2. Its closing
  # eval renders with ∇σ too, since (a)'s colour reads it. The preset's
  # schedules, but the normal input's posenc window open from the start
  # (--scale_schedules makes the sharpening schedule NaN at step 0 of a
  # run shorter than about 20 steps, in both packages).
  overrides = [f'model.{k}={v}' for k, v in SIGMA_NORMALS.items()] + [
      'model.sigma_gradient_mode=fused', 'model.use_pallas_compositing=True',
      "train.norm_input_alpha_schedule=('constant', 4.0)"]
  with tempfile.TemporaryDirectory() as tmp:
    kernels.reset_launch_counts()
    start = time.perf_counter()
    state, metrics, _ = train_cli.main([
        '--preset', 'nerf_ds', '--datasource', 'synthetic', '--exp_dir', tmp,
        '--batch_size', str(TRAIN_BATCH), '--max_steps', str(CLI_STEPS),
        *(a for kv in overrides for a in ('--set', kv))])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    cli = dict(kernels.launch_counts)
    logged = [json.loads(x) for x in (
        Path(tmp) / 'summaries' / 'metrics.jsonl').read_text().splitlines()]
  rgb = [x.get('train/fine/loss/rgb') for x in logged]
  print(f'  train CLI --preset nerf_ds with (a)\'s overrides: {CLI_STEPS} '
        f'steps and its closing eval in {seconds:.1f} s, launches {cli}, val '
        f'psnr {metrics["psnr"]:.2f}, logged fine loss/rgb {rgb}')
  if (state.step != CLI_STEPS or not np.isfinite(metrics['psnr'])
      or not logged or not all(np.isfinite(x if x is not None else np.nan)
                               for x in rgb)
      or cli['fused_trunk_bwd'] != 2 * CLI_STEPS
      or cli['fused_trunk_fwd'] < 2 * CLI_STEPS
      or cli['composite_fwd'] < 2 * CLI_STEPS or cli['composite_fwd'] % 2
      # The eval takes ∇σ: only the mask MLP runs under no_grad.
      or not k3_in_evals_only(cli, CLI_STEPS, per_chunk=2)
      or kernel_launches(cli) != (cli['composite_fwd'] + cli['fused_trunk_fwd']
                               + cli['fused_trunk_bwd']
                               + cli['fused_mlp_fwd'])):
    raise AssertionError(f'train CLI sigma_normals: step {state.step}, '
                         f'launches {cli}, metrics {metrics}, logged {logged}')
  out['cli'] = dict(seconds=seconds, launches=cli, psnr=metrics['psnr'])
  return launches, out


# Phase 13: the model variants outside nerf_ds(), at full width on the train
# phase's store (the appearance cases on a store of the same scene that
# carries appearance ids).
VARIANT_STEPS = 12
VARIANT_CLI_STEPS = 6
# Rays of the card-against-CPU check of (a) and (e).
VARIANT_CPU_RAYS = 64
BONE_LOSS = dict(use_background_loss=True, background_loss_weight=1.0)


def sub_batch(batch, n):
  """The first ``n`` rays of a batch (its metadata too)."""
  return {k: sub_batch(v, n) if isinstance(v, dict) else v[:n]
          for k, v in batch.items()}


def variant_model(torch, run, cfg, device):
  """``cfg`` with ``run``'s embedding counts and bounds on ``device``."""
  m = run.model
  return type(m)(cfg, num_warp_embeds=m.num_warp_embeds,
                 num_hyper_embeds=m.num_hyper_embeds,
                 num_nerf_embeds=m.num_nerf_embeds, near=m.near, far=m.far,
                 device=device)


def grad_rels(torch, got, want):
  return {k: ((got[k].cpu() - w.cpu()).norm()
              / w.cpu().norm().clamp_min(1e-30)).item()
          for k, w in want.items()}


def steady_and_peak(torch, device, model, train_cfg, store, state,
                    background_points=None):
  """(ms a steady step, peak GiB) of ``model``'s fused step from ``state``."""
  from nerfds_torch.training import step as step_lib
  step_fn = step_lib.make_fused_train_step(model, train_cfg, store,
                                           background_points)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  seconds = steady_step_s(torch, device, step_fn, state)
  return 1e3 * seconds, torch.cuda.max_memory_allocated() / 2**30


def card_against_cpu(torch, device, name, cfg, run, train_cfg, state, batch,
                     scalars):
  """The plain path's gradients on the card against the CPU's, on the first
  ``VARIANT_CPU_RAYS`` rays of ``batch`` with unstratified samples and no σ
  noise (the two devices' generators draw different numbers): within
  max(1e-3, twice the card step's float32 floor)."""
  import dataclasses
  from nerfds_torch.training import step as step_lib
  det = dataclasses.replace(cfg, use_stratified_sampling=False,
                            noise_std=None, sigma_gradient_mode='vmap',
                            use_pallas_compositing=False)
  sub = sub_batch(batch, VARIANT_CPU_RAYS)
  card = variant_model(torch, run, det, device)
  cpu = variant_model(torch, run, det, 'cpu')
  on_card, _ = step_lib._grads(step_lib.make_loss_fn(card, train_cfg),
                               state.params, sub, None, scalars)
  on_cpu, _ = step_lib._grads(
      step_lib.make_loss_fn(cpu, train_cfg),
      {k: v.cpu() for k, v in state.params.items()},
      sub_batch({k: ({kk: vv.cpu() for kk, vv in v.items()}
                     if isinstance(v, dict) else v.cpu())
                 for k, v in sub.items()}, VARIANT_CPU_RAYS), None, scalars)
  floor = float32_floor(torch, device, card, train_cfg, state, sub, scalars)
  return check_grads(f'{name}, card against the CPU', grad_rels(
      torch, on_card, on_cpu), floor)


def phase_variants(torch, device, trainer):
  """Phase 13: the model variants outside nerf_ds() at full width, batch
  512, the preset's schedules compressed as in phase 12. Each case trains 12
  steps through Trainer.train with its launch counts checked, its gradients
  held against its plain twin ('vmap', plain compositing) on one state and
  batch within max(1e-3, twice the step's float32 floor), and its steady
  step and peak memory timed: (a) vanilla_nerf() (BASELINE config[0],
  coarse only, 64 samples; K2 once a step) and a 128x128 render (K2 once a
  chunk); (b) concat_dense_inputs, 'fused', and one step of the reference
  pattern 'naive' + concat_dense_inputs (K2 only); (c) the bone warp field
  with its background loss, 'fused', and the train CLI with (c)'s
  overrides; (d) the appearance embedding as an rgb condition ('fused')
  and as an alpha condition too ('vmap', as JAX takes it), on a store with
  appearance ids; (e) norm_type 'layer' and 'group' ('vmap': K1 has no
  norm); (f) remat_feat ('fused') and remat_sigma 'nothing' and 'dots'
  ('vmap'), their gradients within 1e-5 of the same path's without remat
  and the peak memory of both. (a) and (e) are also held against the CPU's
  step on the same rays."""
  import dataclasses
  import tempfile
  from pathlib import Path
  import numpy as np
  from nerfds_torch import config as config_lib
  from nerfds_torch import kernels
  from nerfds_torch import train as train_cli
  from nerfds_torch.datasets import SyntheticDataSource
  from nerfds_torch.evaluation import render as render_lib
  from nerfds_torch.models import default_extra_params
  from nerfds_torch.trainer import Trainer
  from nerfds_torch.training import step as step_lib
  print(f'== model variants at full width, batch {TRAIN_BATCH}, '
        f'{VARIANT_STEPS} steps each: (a) vanilla_nerf, (b) '
        'concat_dense_inputs, (c) the bone field, (d) the appearance '
        'embedding, (e) hidden norms, (f) remat')
  phase_start = time.perf_counter()
  # The schedules compressed to the train phase's run, as in phase 12
  # (compressed to fewer than about 20 steps, the sharpening schedule is
  # NaN at step 0, in both packages).
  train_cfg = dataclasses.replace(
      config_lib.nerf_ds_train_config(max_steps=TRAIN_STEPS,
                                      batch_size=TRAIN_BATCH,
                                      scale_schedules=True), print_every=1)
  base = dataclasses.replace(config_lib.nerf_ds(), use_pallas_compositing=True)
  k1 = dict(fused_trunk_fwd=2, fused_trunk_bwd=2, composite_fwd=2)
  out, launches = {}, {}

  def case(name, cfg, want, run_trainer=None, case_train_cfg=None,
           cpu_check=False):
    """Trains ``cfg`` and holds it against its plain twin; returns the
    run's state, batch and scalars."""
    tc = case_train_cfg or train_cfg
    plain_cfg = dataclasses.replace(cfg, sigma_gradient_mode='vmap',
                                    use_pallas_compositing=False)
    launches[name], out[name], rels, (state, batch, scalars, run) = (
        train_mode(torch, device, run_trainer or trainer, name, cfg,
                   plain_cfg=plain_cfg, train_cfg=tc, steps=VARIANT_STEPS,
                   **want))
    plain = variant_model(torch, run, plain_cfg, device)
    floor = float32_floor(torch, device, plain, tc, state, batch, scalars)
    out[name]['grad_floor_worst'] = max(floor.values())
    out[name]['grad_bound'] = check_grads(name, rels, floor)
    if cpu_check:
      out[name]['cpu_bound'] = card_against_cpu(
          torch, device, name, cfg, run, tc, state, batch, scalars)
    store = (run_trainer or trainer).build_store()
    out[name]['step_ms'], out[name]['peak_gib'] = steady_and_peak(
        torch, device, run.model, tc, store, state, run.background_points())
    print(f'  {name}: steady step {out[name]["step_ms"]:.1f} ms, peak '
          f'{out[name]["peak_gib"]:.2f} GiB')
    return state, batch, scalars, run

  # (a) BASELINE config[0]: coarse only, no ∇σ, K2 once a step.
  vanilla = dataclasses.replace(config_lib.vanilla_nerf(),
                                use_pallas_compositing=True)
  state, _, _, run = case('vanilla_nerf', vanilla, dict(composite_fwd=1),
                          cpu_check=True)
  size, chunk = 128, 4096
  plain = variant_model(torch, run, dataclasses.replace(
      vanilla, use_pallas_compositing=False), device)
  for model in (run.model, plain):
    model.load_state_dict({k: v.detach() for k, v in state.params.items()})
  rays = pinhole_rays(size, run.model.num_warp_embeds)
  extra = default_extra_params(vanilla)
  gen = lambda: torch.Generator(device=device).manual_seed(0)
  kernels.reset_launch_counts()
  start = time.perf_counter()
  image = render_lib.render_image(run.model, rays, extra, generator=gen(),
                                  chunk=chunk)
  torch.cuda.synchronize()
  render_s = time.perf_counter() - start
  render_launches = dict(kernels.launch_counts)
  check_launches('vanilla_nerf 128x128 render', render_launches,
                 composite_fwd=-(-size * size // chunk),
                 fused_mlp_fwd=-(-size * size // chunk))
  ref = render_lib.render_image(plain, rays, extra, generator=gen(),
                                chunk=chunk)
  for k in ('rgb', 'depth', 'acc'):
    if not np.isfinite(image[k]).all():
      raise AssertionError(f'vanilla_nerf render {k}: non-finite')
    # Tolerance as in phase 4: float32; K2 sums in another order than
    # torch.cumprod.
    compare(torch, f'vanilla_nerf render {k}', torch.from_numpy(image[k]),
            torch.from_numpy(ref[k]), 1e-4, 1e-4)
  out['vanilla_nerf']['render_s'] = render_s
  out['vanilla_nerf']['render_launches'] = render_launches
  print(f'  vanilla_nerf render {size}x{size}: {render_s:.3f} s, launches '
        f'{render_launches}')
  del state, run, plain, image, ref

  # (b) concat_dense_inputs, 'fused'; then the reference pattern.
  concat = dataclasses.replace(base, concat_dense_inputs=True,
                               sigma_gradient_mode='fused')
  case('concat_dense_inputs', concat, k1)
  naive = dataclasses.replace(concat, sigma_gradient_mode='naive')
  launches['naive_concat'], out['naive_concat'] = train_mode(
      torch, device, trainer, "'naive' + concat_dense_inputs", naive,
      train_cfg=train_cfg, steps=1, composite_fwd=2)

  # (c) The bone field with its background loss on the store's points.
  bone_cfg = dict(use_bone=True, sigma_gradient_mode='fused')
  bone = dataclasses.replace(base, **bone_cfg)
  bone_train = dataclasses.replace(train_cfg, **BONE_LOSS)
  case('bone', bone, dict(k1, stat_keys=(('loss/background',),)),
       case_train_cfg=bone_train)
  overrides = [f'model.{k}={v}' for k, v in bone_cfg.items()] + [
      'model.use_pallas_compositing=True'] + [
          f'train.{k}={v}' for k, v in BONE_LOSS.items()]
  with tempfile.TemporaryDirectory() as tmp:
    kernels.reset_launch_counts()
    start = time.perf_counter()
    cli_state, metrics, _ = train_cli.main([
        '--preset', 'nerf_ds', '--datasource', 'synthetic', '--exp_dir', tmp,
        '--batch_size', str(TRAIN_BATCH), '--max_steps',
        str(VARIANT_CLI_STEPS), *(a for kv in overrides
                                  for a in ('--set', kv))])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - start
    cli = dict(kernels.launch_counts)
    logged = [json.loads(x) for x in (
        Path(tmp) / 'summaries' / 'metrics.jsonl').read_text().splitlines()]
  background = [x.get('train/loss/background') for x in logged]
  print(f'  train CLI --preset nerf_ds with (c)\'s overrides: '
        f'{VARIANT_CLI_STEPS} steps and its closing eval in {cli_s:.1f} s, '
        f'launches {cli}, val psnr {metrics["psnr"]:.2f}, logged background '
        f'loss {background}')
  if (cli_state.step != VARIANT_CLI_STEPS or not np.isfinite(metrics['psnr'])
      or not any(x is not None for x in background)
      or not all(np.isfinite(x) for x in background if x is not None)
      or cli['fused_trunk_bwd'] != 2 * VARIANT_CLI_STEPS
      or cli['fused_trunk_fwd'] < 2 * VARIANT_CLI_STEPS
      or cli['composite_fwd'] < 2 * VARIANT_CLI_STEPS
      or cli['composite_fwd'] % 2
      # The bone field's two MLPs in place of the SE(3) trunk.
      or not k3_in_evals_only(cli, VARIANT_CLI_STEPS, per_chunk=10)
      or kernel_launches(cli) != (cli['composite_fwd'] + cli['fused_trunk_fwd']
                               + cli['fused_trunk_bwd']
                               + cli['fused_mlp_fwd'])):
    raise AssertionError(f'train CLI bone: step {cli_state.step}, launches '
                         f'{cli}, metrics {metrics}, logged {logged}')
  out['bone']['cli'] = dict(seconds=cli_s, launches=cli,
                            psnr=metrics['psnr'])

  # (d) The appearance embedding, on a store that carries appearance ids.
  start = time.perf_counter()
  source = SyntheticDataSource(num_frames=8, image_size=64,
                               use_appearance_id=True)
  appearance = Trainer.from_experiment(base, train_cfg, source)
  ids = appearance.build_store().metadata['appearance']
  print(f'  appearance store: {time.perf_counter() - start:.2f} s, '
        f'{int(ids.max()) + 1} appearance ids')
  embed = dict(use_nerf_embed=True, use_rgb_condition=True)
  case('appearance_rgb', dataclasses.replace(
      base, **embed, sigma_gradient_mode='fused'), k1, run_trainer=appearance)
  case('appearance_alpha', dataclasses.replace(
      base, **embed, use_alpha_condition=True, sigma_gradient_mode='fused'),
       dict(composite_fwd=2), run_trainer=appearance)
  del appearance, source

  # (e) The hidden norms: 'fused' is taken as 'vmap' (K1 has no norm).
  for norm in ('layer', 'group'):
    case(f'norm_{norm}', dataclasses.replace(
        base, norm_type=norm, sigma_gradient_mode='fused'),
         dict(composite_fwd=2), cpu_check=True)

  # (f) remat: the gradients and peak memory of the same path without it.
  for name, flags, mode, want in (
      ('remat_feat', dict(remat_feat=True), 'fused', k1),
      ('remat_sigma_nothing', dict(remat_sigma=True), 'vmap',
       dict(composite_fwd=2)),
      ('remat_sigma_dots', dict(remat_sigma=True, remat_policy='dots'),
       'vmap', dict(composite_fwd=2))):
    cfg = dataclasses.replace(base, **flags, sigma_gradient_mode=mode)
    state, batch, scalars, run = case(name, cfg, want)
    without = variant_model(torch, run, dataclasses.replace(
        cfg, remat_feat=False, remat_sigma=False), device)
    g = lambda: torch.Generator(device=device).manual_seed(321)
    got, _ = step_lib._grads(step_lib.make_loss_fn(run.model, train_cfg),
                             state.params, batch, g(), scalars)
    want_g, _ = step_lib._grads(step_lib.make_loss_fn(without, train_cfg),
                                state.params, batch, g(), scalars)
    rels = grad_rels(torch, got, want_g)
    worst = max(rels, key=rels.get)
    out[name]['remat_rel_worst'] = rels[worst]
    out[name]['without_step_ms'], out[name]['without_peak_gib'] = (
        steady_and_peak(torch, device, without, train_cfg,
                        trainer.build_store(), state))
    print(f'  {name}: gradients against the run without remat worst '
          f'{rels[worst]:.3e} ({worst}); peak {out[name]["peak_gib"]:.2f} '
          f'GiB with remat, {out[name]["without_peak_gib"]:.2f} GiB without;'
          f' steady step {out[name]["step_ms"]:.1f} ms with, '
          f'{out[name]["without_step_ms"]:.1f} ms without')
    if rels[worst] > 1e-5:
      raise AssertionError(f'{name}: gradients {rels[worst]:.2e} from the '
                           'run without remat')
    del state, batch, run, without, got, want_g
  out['wall_s'] = time.perf_counter() - phase_start
  print(f'  phase 13 wall time: {out["wall_s"]:.1f} s')
  return launches, out


# Phase 14: data parallelism and the host sampler, on phase 7's synthetic
# scene at full width. Ranks are child processes of this script (a
# FileStore rendezvous in a temporary directory), started after the kernels
# are built here, so they load the built library. nerf_ds_pod's schedules
# are NaN at step 0 of a run shorter than about 20 steps: 24 steps.
PARALLEL_STEPS = 24
PARALLEL_WORLD1_STEPS = 12
PARALLEL_TIMEOUT_S = 600
ALL_REDUCE_CALLS = 10
TRUNK_KERNELS = ('fused_trunk_fwd', 'fused_trunk_bwd', 'composite_fwd')


def parallel_spec(case: str, world: int, device_type: str = 'cuda',
                  model_overrides=None, source=None) -> dict:
  """What a rank of ``case`` runs: ``nerf_ds_pod(num_chips=world,
  per_chip_batch=TRAIN_BATCH, max_steps=PARALLEL_STEPS)`` with 'fused' ∇σ
  and K2 compositing, on phase 7's scene."""
  return dict(case=case, world=world, device_type=device_type,
              per_rank_batch=TRAIN_BATCH, steps=PARALLEL_STEPS,
              timed_steps=TRAIN_TIMED_STEPS,
              model_overrides=model_overrides or {},
              source=source or dict(num_frames=8, image_size=64))


def parallel_configs(spec):
  import dataclasses
  from nerfds_torch import config as config_lib
  model_cfg, train_cfg = config_lib.nerf_ds_pod(
      num_chips=spec['world'], per_chip_batch=spec['per_rank_batch'],
      max_steps=spec['steps'])
  model_cfg = dataclasses.replace(
      model_cfg, use_pallas_compositing=True, sigma_gradient_mode='fused',
      **spec['model_overrides'])
  return model_cfg, dataclasses.replace(train_cfg, print_every=1)


def sync(torch, device):
  if device.type == 'cuda':
    torch.cuda.synchronize(device)


def params_digest(torch, params) -> str:
  """A SHA-256 of every parameter's bytes, in name order: equal digests
  are bit-identical parameters."""
  import hashlib
  h = hashlib.sha256()
  for k in sorted(params):
    h.update(k.encode())
    h.update(params[k].detach().cpu().contiguous().numpy().tobytes())
  return h.hexdigest()


def max_abs_diff(a, b) -> float:
  return max((a[k] - b[k]).abs().max().item() for k in a)


def steady_ms(torch, device, step_fn, state, n):
  """ms a step over ``n`` steady steps after two warm-up steps, the device
  synchronised at both ends (the generator reseeded as phase 11's)."""
  g = torch.Generator(device=device)
  for i in range(2):
    g.manual_seed(40_000 + i)
    state, _ = step_fn(state, g)
  sync(torch, device)
  start = time.perf_counter()
  for i in range(n):
    g.manual_seed(50_000 + i)
    state, _ = step_fn(state, g)
  sync(torch, device)
  return 1e3 * (time.perf_counter() - start) / n


def image_batch(torch, source, n, device):
  """The first ``n`` rays of the first train item, as a batch on
  ``device``: the same global batch on every rank."""
  item = source.load_item(source.train_ids[0])

  def rows(x):
    x = torch.as_tensor(x.reshape(-1, x.shape[-1])[:n].copy())
    return x.to(device)

  return {k: ({m: rows(v) for m, v in item[k].items()} if k == 'metadata'
              else rows(item[k]))
          for k in ('origins', 'directions', 'rgb', 'mask', 'metadata')}


def parallel_rank(spec_path: str, rank: int) -> int:
  """One rank of phase 14 (b): run as ``chip_smoke.py --parallel-rank
  <spec.json> <rank>`` by :func:`run_ranks`; writes ``rank<r>.json``
  beside the spec."""
  from pathlib import Path
  import numpy as np
  import torch
  spec_path = Path(spec_path)
  spec = json.loads(spec_path.read_text())
  out_dir = spec_path.parent
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  case, world = spec['case'], spec['world']
  if spec['device_type'] == 'cuda':
    device = torch.device('cuda', rank if case == 'b3' else 0)
    torch.cuda.set_device(device)
  else:
    device = torch.device('cpu')
  # NCCL refuses two ranks on one card: (b2) shares it over gloo.
  backend = ('nccl' if case in ('b1', 'b3') and device.type == 'cuda'
             else 'gloo')
  torch.distributed.init_process_group(
      backend, init_method=f'file://{out_dir / "rendezvous"}',
      world_size=world, rank=rank)
  from nerfds_torch import kernels
  from nerfds_torch.datasets import SyntheticDataSource
  from nerfds_torch.evaluation.render import render_image
  from nerfds_torch.ops.sampling import RowShard
  from nerfds_torch.parallel import mesh as mesh_lib
  from nerfds_torch.trainer import Trainer, eval_extra_params
  from nerfds_torch.training import step as step_lib
  model_cfg, train_cfg = parallel_configs(spec)
  start = time.perf_counter()
  source = SyntheticDataSource(**spec['source'])
  trainer = Trainer.from_experiment(model_cfg, train_cfg, source,
                                    device=device)
  store = trainer.build_store()
  out = dict(rank=rank, backend=backend, device=str(device),
             world=trainer.mesh.world_size, store_rays=store.num_rays,
             setup_s=time.perf_counter() - start)
  losses = []
  kernels.reset_launch_counts()
  start = time.perf_counter()
  state = trainer.train(num_steps=spec['steps'], log_fn=lambda s, d: (
      losses.append(d['stats']['fine']['loss/total'])))
  sync(torch, device)
  out.update(train_s=time.perf_counter() - start,
             launches=dict(kernels.launch_counts), losses=losses,
             params_sha256=params_digest(torch, state.params))
  step_fn = step_lib.make_fused_train_step(trainer.model, train_cfg, store,
                                           None, trainer.mesh)
  out['step_ms'] = steady_ms(torch, device, step_fn, state,
                             spec['timed_steps'])
  if device.type == 'cuda':
    g = torch.Generator(device=device).manual_seed(60_000)
    syncs = host_syncs(torch, lambda: step_fn(state, g))
    out['host_syncs'] = sum(syncs.values())
    out['host_sync_sites'] = syncs

  if world == 1:
    # (b1): against two runs without a mesh.
    plain = []
    for _ in range(2):
      run = Trainer.from_experiment(model_cfg, train_cfg, source,
                                    use_mesh=False, device=device)
      plain.append(run.train(num_steps=spec['steps'], store=store).params)
    out['diff_mesh_plain'] = [max_abs_diff(state.params, p) for p in plain]
    out['diff_plain_plain'] = max_abs_diff(*plain)
  else:
    mesh = trainer.mesh
    # One explicit step on a global batch split over the ranks against the
    # whole batch on one rank, each rank drawing its rows' share of the
    # one-rank draws.
    n = train_cfg.batch_size
    batch = image_batch(torch, source, n, device)
    scalars = step_lib.eval_schedules(step_lib.build_schedules(train_cfg),
                                      state.step)
    per = n // world
    gen = lambda: torch.Generator(device=device).manual_seed(123)
    grads, stats = step_lib._accum_grads(
        step_lib.make_loss_fn(trainer.model, train_cfg, mesh),
        state.params, mesh_lib.shard_batch(batch, mesh),
        RowShard(gen(), n, rank * per, (rank + 1) * per), scalars, 1)
    grads, stats = step_lib._mesh_reduce(grads, stats, mesh)
    # The all-reduce a step (the gradients; the scalar stats add a few
    # floats), by CUDA events on the card.
    sync(torch, device)
    if device.type == 'cuda':
      begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
      begin.record()
    start = time.perf_counter()
    for _ in range(ALL_REDUCE_CALLS):
      mesh_lib.all_reduce_mean(grads, mesh)
    if device.type == 'cuda':
      end.record()
      end.synchronize()
      out['all_reduce_ms'] = begin.elapsed_time(end) / ALL_REDUCE_CALLS
    else:
      out['all_reduce_ms'] = 1e3 * (time.perf_counter() - start) / (
          ALL_REDUCE_CALLS)
    out['all_reduce_bytes'] = sum(4 * g.numel() for g in grads.values())
    if rank == 0:
      want, _ = step_lib._grads(step_lib.make_loss_fn(trainer.model,
                                                      train_cfg),
                                state.params, batch, gen(), scalars)
      rels = {k: ((grads[k] - w).norm() / w.norm().clamp_min(1e-30)).item()
              for k, w in want.items()}
      worst = max(rels, key=rels.get)
      out.update(grad_rel_worst=rels[worst], grad_rel_worst_name=worst,
                 grad_rel_median=float(np.median(list(rels.values()))))
      del want
    del grads, stats, batch
    # eval_psnr and render_image through the mesh against the rank alone.
    item_ids = source.val_ids[:1]
    out['eval_mesh'] = trainer.eval_psnr(state, item_ids=item_ids)
    item = source.load_item(item_ids[0])
    rays = {k: item[k] for k in ('origins', 'directions', 'mask',
                                 'metadata')}
    extra = eval_extra_params(model_cfg, train_cfg, state.step)
    model = trainer.model_with_params(state.params)
    rgb = render_image(model, rays, extra, keys=('rgb',), mesh=mesh,
                       generator=torch.Generator(device=device).manual_seed(0)
                       )['rgb']
    if rank == 0:
      alone = Trainer.from_experiment(model_cfg, train_cfg, source,
                                      use_mesh=False, device=device)
      out['eval_alone'] = alone.eval_psnr(state, item_ids=item_ids)
      want = render_image(
          model, rays, extra, keys=('rgb',),
          generator=torch.Generator(device=device).manual_seed(0))['rgb']
      out['render_max_abs'] = float(np.abs(rgb - want).max())
      out['render_bad'] = int((np.abs(rgb - want)
                               > 1e-4 + 1e-4 * np.abs(want)).sum())
    torch.distributed.barrier()
  (out_dir / f'rank{rank}.json').write_text(json.dumps(out))
  torch.distributed.destroy_process_group()
  return 0


def run_ranks(spec: dict, ranks: int, name: str):
  """Starts ``ranks`` processes of :func:`parallel_rank` on ``spec`` and
  returns their results; kills them all if one fails or they outlast
  ``PARALLEL_TIMEOUT_S``."""
  import os
  import tempfile
  from pathlib import Path
  with tempfile.TemporaryDirectory() as tmp:
    spec_path = Path(tmp) / 'spec.json'
    spec_path.write_text(json.dumps(spec))
    logs = [open(Path(tmp) / f'log{r}.txt', 'w+') for r in range(ranks)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), '--parallel-rank',
         str(spec_path), str(r)], stdout=logs[r], stderr=subprocess.STDOUT,
        cwd=os.path.dirname(os.path.abspath(__file__)))
        for r in range(ranks)]
    deadline = time.monotonic() + PARALLEL_TIMEOUT_S
    try:
      while any(p.poll() is None for p in procs):
        if (time.monotonic() > deadline
            or any(p.returncode not in (None, 0) for p in procs)):
          break
        time.sleep(0.5)
    finally:
      for p in procs:
        if p.poll() is None:
          p.kill()
        p.wait()
      texts = []
      for log in logs:
        log.seek(0)
        texts.append(log.read())
        log.close()
    if any(p.returncode != 0 for p in procs):
      for r, text in enumerate(texts):
        print(f'  {name} rank {r} (rc {procs[r].returncode}):\n'
              + text[-3000:])
      raise AssertionError(f'{name}: ranks exited with '
                           f'{[p.returncode for p in procs]}')
    return [json.loads((Path(tmp) / f'rank{r}.json').read_text())
            for r in range(ranks)]


def check_world_one(name, d_mesh, d_plain):
  """A mesh of one rank runs the ops of the run without one: bit-equal
  where two runs without a mesh are bit-equal, otherwise within twice
  their distance (three runs of one nondeterministic program)."""
  print(f'  {name}: max |mesh - plain run| {d_mesh[0]:.3e} and '
        f'{d_mesh[1]:.3e}, max |plain run - plain run| {d_plain:.3e}')
  ok = (max(d_mesh) == 0) if d_plain == 0 else max(d_mesh) <= 2 * d_plain
  if not ok:
    raise AssertionError(f'{name}: mesh differs from the plain runs by '
                         f'{d_mesh}, they from each other by {d_plain}')


def check_ranks(name, results, steps):
  """Every rank: K1f, K1b, K2 twice a step and nothing else, finite losses,
  and the same parameter bits."""
  import math
  for r in results:
    check_launches(f'{name} rank {r["rank"]}', r['launches'],
                   **dict.fromkeys(TRUNK_KERNELS, 2 * steps))
    if not (len(r['losses']) == steps
            and all(math.isfinite(x) for x in r['losses'])):
      raise AssertionError(f'{name} rank {r["rank"]}: losses {r["losses"]}')
  digests = {r['params_sha256'] for r in results}
  print(f'  {name}: parameter digests {sorted(digests)}')
  if len(digests) != 1:
    raise AssertionError(f'{name}: the ranks hold different parameters')


def phase_parallel(torch, device, trainer):
  """Phase 14: (a) a mesh of one rank in this process against two runs
  without one; (b1) one rank on NCCL, (b2) two ranks on the one card over
  gloo, (b3) two ranks on two cards over NCCL where there are two, each
  ``nerf_ds_pod`` at 512 rays a rank, 24 steps; (c) ``sampling='host'``
  on phase 7's store held in host memory."""
  import dataclasses
  import threading
  import numpy as np
  from nerfds_torch import config as config_lib
  from nerfds_torch import kernels
  from nerfds_torch.datasets import HostRayIterator
  from nerfds_torch.trainer import Trainer
  from nerfds_torch.training import step as step_lib
  phase_start = time.perf_counter()
  print('== phase 14: data parallelism and the host sampler')
  cfg = dataclasses.replace(config_lib.nerf_ds(), use_pallas_compositing=True,
                            sigma_gradient_mode='fused')
  train_cfg = dataclasses.replace(
      config_lib.nerf_ds_train_config(batch_size=TRAIN_BATCH), print_every=1)
  store = trainer.build_store()
  out, launches = {}, {}

  # (a) World 1 in this process, no process group.
  runs = {}
  for name, use_mesh in (('mesh', True), ('plain_1', False),
                         ('plain_2', False)):
    run = Trainer.from_experiment(cfg, train_cfg, trainer.datasource,
                                  use_mesh=use_mesh, device=device)
    kernels.reset_launch_counts()
    runs[name] = run, run.train(num_steps=PARALLEL_WORLD1_STEPS, store=store)
    sync(torch, device)
    if name == 'mesh':
      launches['world1'] = dict(kernels.launch_counts)
      check_launches('(a) world 1', launches['world1'],
                     **dict.fromkeys(TRUNK_KERNELS,
                                     2 * PARALLEL_WORLD1_STEPS))
  params = {k: s.params for k, (_, s) in runs.items()}
  d_mesh = [max_abs_diff(params['mesh'], params[p])
            for p in ('plain_1', 'plain_2')]
  d_plain = max_abs_diff(params['plain_1'], params['plain_2'])
  check_world_one('(a) world 1', d_mesh, d_plain)
  out['world1'] = dict(diff_mesh_plain=d_mesh, diff_plain_plain=d_plain)
  for name in ('mesh', 'plain_1'):
    run, state = runs[name]
    step_fn = step_lib.make_fused_train_step(run.model, train_cfg, store,
                                             None, run.mesh)
    out['world1'][f'{name}_step_ms'] = steady_ms(torch, device, step_fn,
                                                 state, TRAIN_TIMED_STEPS)
    g = torch.Generator(device=device).manual_seed(60_000)
    syncs = host_syncs(torch, lambda: step_fn(state, g))
    out['world1'][f'{name}_host_syncs'] = sum(syncs.values())
  print(f'  (a) steady step: mesh {out["world1"]["mesh_step_ms"]:.1f} ms, '
        f'without {out["world1"]["plain_1_step_ms"]:.1f} ms; host waits a '
        f'step {out["world1"]["mesh_host_syncs"]} and '
        f'{out["world1"]["plain_1_host_syncs"]}')
  del runs, params

  # (b1)-(b3): ranks in child processes.
  cases = [('b1', 1), ('b2', 2)]
  if torch.cuda.device_count() >= 2:
    cases.append(('b3', 2))
  else:
    print(f'  (b3) two ranks on NCCL: not run, the machine has '
          f'{torch.cuda.device_count()} card (NCCL refuses two ranks on '
          'one card)')
    out['b3'] = 'not run: one card'
  for case, world in cases:
    start = time.perf_counter()
    results = run_ranks(parallel_spec(case, world), world, case)
    wall = time.perf_counter() - start
    check_ranks(case, results, PARALLEL_STEPS)
    for r in results:
      launches[f'{case}_rank{r["rank"]}'] = r['launches']
      print(f'  {case} rank {r["rank"]} ({r["backend"]}, {r["device"]}): '
            f'{r["store_rays"]} rays in its store, set-up '
            f'{r["setup_s"]:.1f} s, {PARALLEL_STEPS} steps in '
            f'{r["train_s"]:.2f} s, steady step {r["step_ms"]:.1f} ms, host '
            f'waits a step {r.get("host_syncs")} at {r.get("host_sync_sites")}'
            f', loss {r["losses"][0]:.5f} -> {r["losses"][-1]:.5f}')
    first = results[0]
    if world == 1:
      check_world_one(f'({case}) one rank', first['diff_mesh_plain'],
                      first['diff_plain_plain'])
    else:
      print(f'  {case}: one explicit step on {2 * TRAIN_BATCH} rays split '
            f'over 2 ranks against one rank: gradients worst '
            f'{first["grad_rel_worst"]:.3e} ({first["grad_rel_worst_name"]}),'
            f' median {first["grad_rel_median"]:.3e}; all-reduce '
            f'{first["all_reduce_ms"]:.3f} ms for '
            f'{first["all_reduce_bytes"]} bytes; eval psnr mesh '
            f'{first["eval_mesh"]["psnr"]:.5f} dB, alone '
            f'{first["eval_alone"]["psnr"]:.5f}; render rgb max |mesh - '
            f'alone| {first["render_max_abs"]:.3e}, '
            f'{first["render_bad"]} beyond atol 1e-4 + rtol 1e-4')
      # Phase 7's tolerance: float32 sums in another order, relu kinks.
      if not first['grad_rel_worst'] <= 1e-3:
        raise AssertionError(f'{case}: gradients {first["grad_rel_worst"]}')
      if not abs(first['eval_mesh']['psnr']
                 - first['eval_alone']['psnr']) <= 1e-3:
        raise AssertionError(f'{case}: eval_psnr {first["eval_mesh"]} vs '
                             f'{first["eval_alone"]}')
      if first['render_bad']:
        raise AssertionError(f'{case}: render rgb off at '
                             f'{first["render_bad"]} values')
      if results[1]['eval_mesh'] != first['eval_mesh']:
        raise AssertionError(f'{case}: the ranks evaluate differently')
    out[case] = dict(wall_s=wall, ranks=results)

  # (c) sampling='host' on phase 7's store in host memory.
  host = Trainer.from_experiment(cfg, train_cfg, trainer.datasource,
                                 sampling='host', device=device)
  host_store = host.build_store()
  it = HostRayIterator(host_store, TRAIN_BATCH, seed=train_cfg.random_seed,
                       device=device)
  rng = np.random.RandomState(train_cfg.random_seed)
  try:
    for i in range(3):
      got = next(it)
      idx = rng.randint(0, host_store.num_rays, TRAIN_BATCH)
      for k, x in host_store.as_dict().items():
        pairs = ((x, got[k]),) if k != 'metadata' else tuple(
            (x[m], got[k][m]) for m in x)
        for want, have in pairs:
          if not torch.equal(have.cpu(), torch.from_numpy(
              np.ascontiguousarray(want[idx]))):
            raise AssertionError(f'(c) batch {i} {k} differs from numpy')
  finally:
    it.close()
  threads = set(threading.enumerate())
  kernels.reset_launch_counts()
  losses = []
  state = host.train(num_steps=PARALLEL_STEPS, log_fn=lambda s, d: (
      losses.append(d['stats']['fine']['loss/total'])))
  sync(torch, device)
  launches['host'] = dict(kernels.launch_counts)
  check_launches('(c) host sampling', launches['host'],
                 **dict.fromkeys(TRUNK_KERNELS, 2 * PARALLEL_STEPS))
  alive = [t.name for t in set(threading.enumerate()) - threads]
  if alive or not np.isfinite(losses).all():
    raise AssertionError(f'(c) threads left {alive}, losses {losses}')
  # Steady steps through Trainer.train (steps 12 to 24, logging only at the
  # last), host and fused in turns.
  quiet = dataclasses.replace(train_cfg, print_every=10**6)
  timed = {'fused': [], 'host': []}
  for sampling in ('fused', 'host', 'host', 'fused'):
    run = Trainer.from_experiment(cfg, quiet, trainer.datasource,
                                  sampling=sampling, device=device)
    run_store = host_store if sampling == 'host' else store
    half = run.train(num_steps=PARALLEL_STEPS // 2, store=run_store)
    sync(torch, device)
    start = time.perf_counter()
    run.train(num_steps=PARALLEL_STEPS, state=half, store=run_store)
    sync(torch, device)
    timed[sampling].append(1e3 * (time.perf_counter() - start)
                           / (PARALLEL_STEPS - PARALLEL_STEPS // 2))
  out['host'] = dict(step_ms=timed['host'], fused_step_ms=timed['fused'],
                     loss_first=losses[0], loss_last=losses[-1])
  print(f'  (c) host sampling: batches 0-2 bit-equal to numpy\'s gather, '
        f'no sampler thread left, loss {losses[0]:.5f} -> {losses[-1]:.5f};'
        f' steady step through Trainer.train: host '
        f'{", ".join(f"{x:.1f}" for x in timed["host"])} ms, fused '
        f'{", ".join(f"{x:.1f}" for x in timed["fused"])} ms')
  out['wall_s'] = time.perf_counter() - phase_start
  print(f'  phase 14 wall time: {out["wall_s"]:.1f} s')
  return launches, out


BENCH_BATCHES = (2048, 512)
# bench.py's JSON keys, and the port's one more.
BENCH_KEYS = ['metric', 'value', 'unit', 'vs_baseline', 'baseline', 'path']
ABLATE_ARGS = ['--batch', '2048', '--warmup', '1', '--iters', '3']
TOPK_ROWS = ('topk32', 'topk16', 'topk12', 'topk8')
# Steps of the study CLIs' cut runs. convergence_run needs about 300 at
# batch 512 before every foreground ray's median-weight sample carries
# the weight that normal_fidelity selects (> 0.1): at 40 none did, at 120
# steps of 2048 rays 44% (NVIDIA H100 80GB HBM3, 700 W).
CONVERGENCE_STEPS = 300
NORMALS_STEPS = 16
STUDY_GRID = ((512, 'none'), (2048, 'sqrt'), (4096, 'linear'))
# 4 steps at 4096 rays: at 3 the recipe's sharpening schedule decays over
# one step and is NaN at step 0, in both packages.
STUDY_RAY_BUDGET = 16_384
SCENE_STEPS = 6
CHILD_TIMEOUT_S = 600
# bench_scaling's one rank against the bench at the same batch: the host
# moves a step by up to 25% between calls (PERF.md §5).
SCALING_TOLERANCE = 0.25


def run_cli(main, argv):
  """``main(argv)`` of a CLI in this process; returns its result and the
  lines it printed, which are echoed indented."""
  import contextlib
  import io
  buf = io.StringIO()
  with contextlib.redirect_stdout(buf):
    result = main(argv)
  lines = buf.getvalue().splitlines()
  for line in lines:
    print(f'  | {line}')
  return result, lines


def run_child(argv, name):
  """Runs ``argv`` from this script's directory in a session of its own;
  returns its standard output's lines. Kills the whole session if it
  outlasts ``CHILD_TIMEOUT_S``; raises if it exits with another code than
  0."""
  import os
  import signal
  proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True,
                          start_new_session=True,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
  try:
    stdout, stderr = proc.communicate(timeout=CHILD_TIMEOUT_S)
  except subprocess.TimeoutExpired:
    os.killpg(proc.pid, signal.SIGKILL)
    proc.communicate()
    raise AssertionError(f'{name}: still running after {CHILD_TIMEOUT_S} s')
  finally:
    if proc.poll() is None:
      os.killpg(proc.pid, signal.SIGKILL)
      proc.wait()
  for line in stdout.splitlines():
    print(f'  | {line}')
  if proc.returncode != 0:
    print(f'  {name} (rc {proc.returncode}), stderr:\n{stderr[-4000:]}')
    raise AssertionError(f'{name} exited with {proc.returncode}')
  return stdout.splitlines()


def json_lines(lines):
  return [json.loads(x) for x in lines if x.startswith('{')]


def free_port() -> int:
  import socket
  with socket.socket() as s:
    s.bind(('127.0.0.1', 0))
    return s.getsockname()[1]


def torchrun(ranks: int):
  return [sys.executable, '-m', 'torch.distributed.run', '--nnodes', '1',
          '--nproc_per_node', str(ranks), '--master_addr', '127.0.0.1',
          '--master_port', str(free_port())]


def check_finite(name, row, keys):
  import math
  if not all(math.isfinite(row[k]) for k in keys):
    raise AssertionError(f'{name}: {row}')


# The entry of kernels.launch_counts that counts the layers K3 ran with
# their bias staged ahead of the epilogue, not launches.
K3_PREFETCHED = 'fused_mlp_fwd_prefetched_layers'


def kernel_launches(counts) -> int:
  """The launches of every kernel in a ``kernels.launch_counts`` copy."""
  return sum(counts.values()) - counts[K3_PREFETCHED]


def k3_in_evals_only(launches, steps, per_chunk=8) -> bool:
  """Whether K3 ran in a run's evaluations alone, for a run of ``steps``
  training steps (K2 twice each) and evaluations (K2 twice a chunk): at
  most ``per_chunk`` launches an evaluation chunk, the stacks that
  ``MLP.forward`` routes at both levels of the run's model (8 for
  ``nerf_ds()``: its NeRF trunk, mask MLP, SE(3) trunk and hyper sheet)."""
  return launches['fused_mlp_fwd'] <= per_chunk * (
      launches['composite_fwd'] - 2 * steps) // 2


def check_trainer_launches(name, launches, steps):
  """Training runs that take ∇σ for ``steps`` steps on the kernel path,
  and evaluations: K1b twice a step, K1f and K2 at least as often (the
  evaluations add theirs); K3 in the evaluations alone, at most 8 times an
  evaluation chunk (4 for each of its 2 K2 launches)."""
  print(f'  {name} launches: {launches}')
  if not (launches['fused_trunk_bwd'] == 2 * steps
          and launches['fused_trunk_fwd'] >= 2 * steps
          and launches['composite_fwd'] >= 2 * steps
          and k3_in_evals_only(launches, steps)):
    raise AssertionError(f'{name}: launches {launches}, want K1b '
                         f'{2 * steps}')


def check_bench_kernels(torch, device):
  """Phase 15 (a), first: each kernel of the bench's path against its plain
  version at the shapes the bench gives it at batch ``BENCH_BATCHES[0]``
  (K1f and K1b, f32 and the bf16 row's, on the coarse and fine levels'
  rows; K2 on [rays, 64] and [rays, 128]); then one step of
  ``bench.build`` at that batch on the kernel path against the plain path
  from the same parameters, batch and draws, each Adam first moment (a
  tenth of the gradient) within 1e-3 of its norm, as the card test holds
  it at batch 512. Returns ({kernel: max abs error}, the worst moment's
  |got - want| / |want|, the plain step's own float32 floor: the same
  on the plain path with the rays' origins moved one ulp, and each trunk
  kernel's time at each of those rows, {'<kernel>_ms_n<N>': ms})."""
  from nerfds_torch import bench
  from nerfds_torch.kernels import fused_trunk
  batch = BENCH_BATCHES[0]
  print(f' the kernels at the bench\'s shapes, batch {batch}')
  spec, weights = nerf_ds_trunk(torch, device, seed=4)
  gen = torch.Generator(device=device).manual_seed(1)
  checks = {
      'fused_trunk_fwd': lambda n: check_trunk_fwd(torch, device, spec,
                                                   weights, n),
      'fused_trunk_bwd': lambda n: check_trunk_bwd(torch, device, spec,
                                                   weights, n),
      'fused_trunk_fwd_bf16': lambda n: check_trunk_fwd_bf16(
          torch, device, spec, weights, n),
      'fused_trunk_bwd_bf16': lambda n: check_trunk_bwd_bf16(
          torch, device, spec, weights, n)}
  errs = dict.fromkeys([*checks, 'composite_fwd'], 0.0)
  bounds = {
      'fused_trunk_fwd': lambda n: trunk_fwd_bound(spec, weights, n)[0],
      'fused_trunk_bwd': lambda n: trunk_bwd_bound(spec, weights, n)[0],
      'fused_trunk_fwd_bf16': lambda n: bf16_fwd_bound(spec, weights, n)[0],
      'fused_trunk_bwd_bf16': lambda n: bf16_bwd_bound(spec, weights, n)[0]}
  times = {}
  bf16 = torch.bfloat16
  with torch.no_grad():
    for samples in (64, 128):  # the coarse and the fine level
      n = batch * samples
      for name, check in checks.items():
        err, feat, *rest = check(n)
        errs[name] = max(errs[name], err)
        # Each trunk kernel timed on the inputs it was checked on, the
        # bf16 ones beside the float32 ones.
        cdt = bf16 if name.endswith('bf16') else None
        if name.startswith('fused_trunk_fwd'):
          fn = lambda: fused_trunk.trunk_sigma_grad(feat, weights, spec,
                                                    compute_dtype=cdt)
        else:
          fn = lambda: fused_trunk.trunk_sigma_grad_backward(
              feat, weights, spec, rest[0], compute_dtype=cdt)
        times[f'{name}_ms_n{n}'] = device_ms(torch, fn, 3,
                                             match=TRUNK_KERNEL_MATCH)
        times[f'{name}_bound_ms_n{n}'] = bounds[name](n)
        if name.startswith('fused_trunk_bwd'):
          times[f'{name}_scratch_floor_ms_n{n}'] = scratch_floor_ms(
              n, spec.depth, cdt)
        del feat, rest
      print(f'  times at N={n} (bound): ' + ', '.join(
          f'{name} {times[f"{name}_ms_n{n}"]:.3f} ms '
          f'({times[f"{name}_bound_ms_n{n}"]:.3f})' for name in checks))
      errs['composite_fwd'] = max(errs['composite_fwd'], check_composite(
          torch, composite_inputs(torch, batch, samples, gen, device)))
  moments = {}
  for path in (*bench.PATHS, 'plain, origins moved one ulp'):
    state, step_fn, data = bench.build(batch, path=path.split(',')[0],
                                       device=device)
    if path not in bench.PATHS:
      origins = data['origins']
      data['origins'] = torch.nextafter(
          origins, torch.full_like(origins, float('inf')))
    new, stats = step_fn(state, data,
                         torch.Generator(device=device).manual_seed(7))
    check_finite(f'bench step, {path}', stats['fine'], ('loss/total',))
    moments[path] = new.opt_state.mu
    del state, step_fn, data, new
  floor = grad_rels(torch, moments.pop('plain, origins moved one ulp'),
                    moments['plain'])
  rels = grad_rels(torch, moments['kernel'], moments['plain'])
  worst = max(rels, key=rels.get)
  print(f'  bench step at batch {batch}, Adam first moments: kernel vs '
        f'plain worst {rels[worst]:.3e} ({worst}); the plain step\'s float32 '
        f'floor (origins moved one ulp) worst {max(floor.values()):.3e}')
  if not rels[worst] < 1e-3:
    raise AssertionError(f'bench step at batch {batch}: {worst} '
                         f'{rels[worst]:.2e} of its norm from the plain path')
  return errs, rels[worst], max(floor.values()), times


def phase_clis(torch, device):
  """Phase 15: the measuring and study CLIs on the card. (a) ``bench`` at
  batch 2048 and 512: kernel path (K1f, K1b, K2 twice a step) with the
  baseline (none of them), plain path (none); (b) ``bench_ablate`` on the
  kernel path (the top-k rows refused, the bf16 row on K1 bf16) and the
  plain path's full and topk16 rows; (c) ``bench_scaling``: one rank, two
  gloo ranks sharing the card, NCCL over the cards where there are two or
  more; (d) ``convergence_run``, ``normals_ablation``,
  ``batch_scaling_study`` and ``run_scenes`` (an exported capture and a
  missing directory) at cut sizes. (a) starts with
  ``check_bench_kernels``."""
  import csv
  import tempfile
  from pathlib import Path
  import numpy as np
  from nerfds_torch import (batch_scaling_study, bench, bench_ablate,
                            convergence_run, export_synthetic, kernels,
                            normals_ablation)
  phase_start = time.perf_counter()
  print('== phase 15: the measuring and study CLIs')
  launches, out = {}, {'bench': {}}
  out['bench_shapes'] = dict(zip(
      ('max_abs_err', 'moment_rel_worst', 'moment_floor_worst', 'trunk_ms'),
      check_bench_kernels(torch, device)))
  walls = out['wall_s'] = {'bench_shapes': time.perf_counter() - phase_start}

  # (a) The bench, each path at each batch; 512 with --quick.
  for batch in BENCH_BATCHES:
    for path, extra in (('kernel', []), ('plain', ['--no-baseline'])):
      argv = ['--batch', str(batch), '--path', path, *extra]
      if batch != BENCH_BATCHES[0]:
        argv.append('--quick')
      kernels.reset_launch_counts()
      (result, runs), lines = run_cli(bench.main, argv)
      launches[f'bench_{path}_{batch}'] = dict(kernels.launch_counts)
      if (len(lines) != 1 or json.loads(lines[0]) != result
          or list(result) != BENCH_KEYS or result['unit'] != 'rays/s/chip'
          or result['metric'] != bench.METRIC):
        raise AssertionError(f'bench {argv}: printed {lines}')
      for name, run in runs.items():
        kind = path if name == 'path' else 'baseline'
        per_step = dict.fromkeys(TRUNK_KERNELS, 2) if kind == 'kernel' else {}
        check_launches(f'bench {kind}, batch {batch}', run['launches'],
                       **{k: n * run['steps'] for k, n in per_step.items()})
        chains = [1e3 * s for s in run['chains']]
        out['bench'][f'{kind}_{batch}'] = dict(
            rays_per_s=batch / run['sec'], step_ms=1e3 * run['sec'],
            chains_ms=chains, spread=(max(chains) - min(chains))
            / (1e3 * run['sec']), steps=run['steps'],
            peak_gib=run['peak_gib'])
      out['bench'][f'{path}_{batch}']['vs_baseline'] = result['vs_baseline']
  for key, r in out['bench'].items():
    print(f'  bench {key}: {r["rays_per_s"]:.1f} rays/s, median chain '
          f'{r["step_ms"]:.2f} ms a step (chains {", ".join(f"{c:.2f}" for c in r["chains_ms"])}'
          f'; spread {r["spread"]:.3f} of the median), peak '
          f'{r["peak_gib"]:.2f} GiB')

  walls['bench'] = time.perf_counter() - phase_start - walls['bench_shapes']

  # (b) bench_ablate: the kernel path's table, then the plain path's top-k.
  start = time.perf_counter()
  kernels.reset_launch_counts()
  (results, runs), lines = run_cli(bench_ablate.main, ABLATE_ARGS)
  launches['ablate_kernel'] = dict(kernels.launch_counts)
  rows = {r['ablation']: r for r in json_lines(lines)}
  if list(rows) != list(bench_ablate.ABLATIONS):
    raise AssertionError(f'bench_ablate rows {list(rows)}')
  refused = {name for name, r in rows.items() if 'error' in r}
  if (refused != set(TOPK_ROWS) or not all(
      'norm_grad_topk is active only' in rows[n]['error'] for n in refused)):
    raise AssertionError(f'bench_ablate errors: '
                         f'{ {n: rows[n]["error"] for n in refused} }')
  steps = runs['full']['steps']
  check_launches('bench_ablate full', runs['full']['launches'],
                 **dict.fromkeys(TRUNK_KERNELS, 2 * steps))
  check_launches('bench_ablate bf16', runs['bf16']['launches'],
                 fused_trunk_fwd_bf16=2 * steps,
                 fused_trunk_bwd_bf16=2 * steps, composite_fwd=2 * steps)
  out['ablate_kernel'] = {
      name: dict(ms=results[name], launches_per_step={
          k: n / steps for k, n in run['launches'].items() if n},
          peak_gib=run['peak_gib']) for name, run in runs.items()}
  kernels.reset_launch_counts()
  (results, runs), lines = run_cli(
      bench_ablate.main, ABLATE_ARGS + ['--path', 'plain', '--only', 'full',
                                        'topk16'])
  launches['ablate_plain'] = dict(kernels.launch_counts)
  check_launches('bench_ablate --path plain', launches['ablate_plain'])
  if sorted(results) != ['full', 'topk16']:
    raise AssertionError(f'bench_ablate --path plain: {lines}')
  out['ablate_plain'] = {name: dict(ms=results[name],
                                    peak_gib=run['peak_gib'])
                         for name, run in runs.items()}

  walls['bench_ablate'] = time.perf_counter() - start

  # (c) bench_scaling in child processes under torchrun.
  scaling = [sys.executable, '-m', 'nerfds_torch.bench_scaling']
  batch = str(BENCH_BATCHES[0])
  cases = [('one_rank', 1, ['--per_chip_batch', batch, '--warmup', '2',
                            '--iters', '8']),
           ('two_gloo_ranks_one_card', 2,
            ['--backend', 'gloo', '--per_chip_batch', '512', '--warmup', '1',
             '--iters', '3'])]
  cards = torch.cuda.device_count()
  if cards >= 2:
    cases.append(('nccl_cards', min(cards, 4),
                  ['--per_chip_batch', batch, '--warmup', '2', '--iters',
                   '8']))
  else:
    out['scaling_nccl_cards'] = 'not run: one card'
  for name, ranks, argv in cases:
    start = time.perf_counter()
    rows = json_lines(run_child(torchrun(ranks) + scaling[1:] + argv, name))
    want = [n for n in (1, 2, 4) if n <= ranks]
    if [r['devices'] for r in rows[:-1]] != want or (
        rows[-1]['metric'] != 'weak_scaling_efficiency'):
      raise AssertionError(f'bench_scaling {name}: {rows}')
    out[f'scaling_{name}'] = rows
    walls[f'bench_scaling_{name}'] = time.perf_counter() - start
  alone = out['scaling_one_rank'][0]['rays_per_sec_per_chip']
  ref = out['bench'][f'kernel_{batch}']['rays_per_s']
  print(f'  bench_scaling, one rank at {batch} rays: {alone:.1f} rays/s '
        f'against the bench\'s {ref:.1f} ({alone / ref - 1:+.3f})')
  if not abs(alone / ref - 1) <= SCALING_TOLERANCE:
    raise AssertionError(f'bench_scaling one rank {alone} vs bench {ref}')

  # (d) The study CLIs at cut sizes, kernel path.
  with tempfile.TemporaryDirectory() as tmp:
    tmp = Path(tmp)
    runs = {}
    start = time.perf_counter()
    kernels.reset_launch_counts()
    rows, _ = run_cli(convergence_run.main, [
        '--steps', str(CONVERGENCE_STEPS), '--eval_every',
        str(CONVERGENCE_STEPS // 2), '--frames', '4', '--image_size', '32',
        '--batch', '512', '--out', str(tmp / 'convergence.jsonl')])
    runs['convergence_run'] = rows, CONVERGENCE_STEPS
    for r in rows[1:3]:
      check_finite('convergence_run', r, ('train_psnr', 'val_psnr',
                                          'val_ms_ssim'))
    if not rows[3]['normal_pixels'] > 0:
      raise AssertionError(f'convergence_run: no pixel to score: {rows[3]}')
    check_finite('convergence_run', rows[3], ('normal_cosine_train_views',))
    launches['convergence_run'] = dict(kernels.launch_counts)
    kernels.reset_launch_counts()
    (rows, summary), _ = run_cli(normals_ablation.main, [
        '--steps', str(NORMALS_STEPS), '--batch', '512', '--frames', '4',
        '--image_size', '32', '--cases', 'full,no_normals', '--out',
        str(tmp / 'normals')])
    # 'no_normals' takes no ∇σ: K1 runs in 'full' alone.
    runs['normals_ablation'] = rows, NORMALS_STEPS
    for r in rows:
      check_finite('normals_ablation', r, ('val_psnr', 'val_masked_psnr'))
    launches['normals_ablation'] = dict(kernels.launch_counts)
    kernels.reset_launch_counts()
    (rows, summary), _ = run_cli(batch_scaling_study.main, [
        '--ray_budget', str(STUDY_RAY_BUDGET), '--seeds', '0', '--grid',
        ','.join(f'{b}:{r}' for b, r in STUDY_GRID), '--out',
        str(tmp / 'batch_scaling.json')])
    # Microbatches of 1024 rays from a batch of 4096: K1b once each a level.
    study_steps = sum(STUDY_RAY_BUDGET // b * max(b // 1024, 1)
                      if b >= 4096 else STUDY_RAY_BUDGET // b
                      for b, _ in STUDY_GRID)
    runs['batch_scaling_study'] = rows, study_steps
    for r in rows:
      check_finite('batch_scaling_study', r, ('val_psnr', 'rays_per_sec'))
    launches['batch_scaling_study'] = dict(kernels.launch_counts)
    for name, (rows, n) in runs.items():
      check_trainer_launches(name, launches[name], n)
    out['studies'] = {name: rows for name, (rows, _) in runs.items()}
    walls['studies'] = time.perf_counter() - start

    # run_scenes: a capture exported on the card and a missing directory,
    # each scene trained by a child train CLI.
    data_root = tmp / 'scenes'
    export_synthetic.main([
        '--out_dir', str(data_root / 'sphere_novel_view'), '--frames', '4',
        '--image_size', '32', '--gt_samples', '64', '--camera_path_frames',
        '2'])
    exp_root = tmp / 'scene_runs'
    start = time.perf_counter()
    run_child([sys.executable, '-m', 'nerfds_torch.run_scenes',
               '--data_root', str(data_root), '--exp_root', str(exp_root),
               '--scenes', 'sphere', 'missing', '--max_steps',
               str(SCENE_STEPS), '--batch_size', '512'], 'run_scenes')
    with open(exp_root / 'summary.csv') as f:
      table = list(csv.reader(f))
    psnr = table[0].index('psnr')
    model_cfg = json.loads((exp_root / 'sphere' / 'model_config.json')
                           .read_text())
    if ([r[0] for r in table[1:]] != ['sphere', 'missing']
        or not np.isfinite(float(table[1][psnr]))
        or any(table[2][1:])
        or (model_cfg['sigma_gradient_mode'],
            model_cfg['use_pallas_compositing']) != ('fused', True)):
      raise AssertionError(f'run_scenes summary {table}')
    out['run_scenes'] = table
    walls['run_scenes'] = time.perf_counter() - start
  walls['phase'] = time.perf_counter() - phase_start
  print(f'  phase 15 wall times: {json.dumps(walls)}')
  return launches, out

def check_launches(name, launches, **given):
  """``launches`` must hold the counts in ``given``, and 0 for every other
  kernel; K3's count of layers (``K3_PREFETCHED``) where ``given`` has it,
  and 0 where K3 does not run."""
  want = {**dict.fromkeys(launches, 0), **given}
  if given.get('fused_mlp_fwd') and K3_PREFETCHED not in given:
    want[K3_PREFETCHED] = launches[K3_PREFETCHED]
  print(f'  {name} launches: {launches}')
  if launches != want:
    raise AssertionError(f'{name} launches {launches}, want {want}')


def time_host(fn) -> float:
  """Seconds of one call of ``fn`` on the host's clock."""
  start = time.perf_counter()
  fn()
  return time.perf_counter() - start


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


def profile_device(torch, fn, name, n=2, top=8, stats=None):
  """Device time by kernel over ``n`` calls of ``fn`` (torch.profiler), and
  the device's idle share of their wall time with the profiler on; returns
  {kernel or copy name: device ms a call}. ``stats``, a dict, receives the
  wall and busy ms, the idle share and the device ops of a call."""
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
  if stats is not None:
    stats.update(wall_ms=wall_ms, busy_ms=busy_ms,
                 idle_share=1 - busy_ms / wall_ms,
                 device_ops=sum(e.count for e in events) // n)
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
  walls = {}

  def stamp(name):  # the script's wall time up to the start of a phase
    walls[name] = round(time.perf_counter() - start, 1)
    print(f'[{walls[name]} s] {name}')

  build.load_library()
  print(f'== build: {time.perf_counter() - start:.1f} s')
  for text in build.build_report().splitlines():
    if any(s in text for s in ('entry function', 'registers', 'spill')):
      print(f'  ptxas: {text.strip()}')
  sass = check_tensor_cores()

  stamp('K2, K1f')
  results = [phase_composite(torch, device), phase_fused_trunk(torch, device)]
  stamp('render')
  launches = phase_render(torch, device, [r['name'] for r in results])
  for r in results:
    r['launches'] = launches[r['name']]
  stamp('K1b')
  results.append(phase_fused_trunk_bwd(torch, device))
  stamp('K3')
  results.append(phase_fused_mlp(torch, device))
  stamp('train')
  train_launches, train, trainer = phase_train(torch, device)
  for r in results:
    r['launches_render'] = launches[r['name']]
    r['launches_train'] = train_launches[r['name']]
    r['launches_per_train_step'] = train_launches[r['name']] / TRAIN_STEPS
  if train_launches['fused_mlp_fwd']:
    raise AssertionError('K3 ran on the training path')
  results[2]['launches'] = train_launches['fused_trunk_bwd']
  stamp('eval')
  evaluation = phase_eval(torch, device)
  results[3]['launches'] = evaluation['k3_launches']
  stamp('capture')
  capture_launches, capture = phase_capture(torch, device)
  for r in results:
    r['launches_capture'] = capture_launches[r['name']]
  stamp('10(a) bf16 kernels')
  bf16_results = phase_trunk_bf16(torch, device)
  for r in bf16_results:
    r['sass'] = {k: v for k, v in sass.items()
                 if BF16_TC_KERNELS[k] == r['name']}
  stamp('10(b)-(e) speed modes')
  speed_launches, speed = phase_speed_modes(torch, device, trainer)
  for r in bf16_results:
    r['launches'] = speed_launches['bf16'][r['name']]
    r['launches_render'] = launches[r['name']]
    r['launches_train'] = train_launches[r['name']]
    r['launches_capture'] = capture_launches[r['name']]
  results += bf16_results
  stamp('11 deformation')
  deformation_launches, deformation = phase_deformation(torch, device,
                                                        trainer)
  stamp('12 heads')
  heads = phase_trunk_heads(torch, device)
  for r in results:
    key = {'fused_trunk_fwd': 'fwd', 'fused_trunk_bwd': 'bwd',
           'fused_trunk_fwd_bf16': 'fwd_bf16',
           'fused_trunk_bwd_bf16': 'bwd_bf16'}.get(r['name'])
    if key:
      r['heads'] = heads[key]
  stamp('12 radiance')
  radiance_launches, radiance = phase_radiance(torch, device, trainer, train)
  for r in results:
    r['launches_radiance'] = {mode: counts[r['name']]
                              for mode, counts in radiance_launches.items()}
  stamp('13 variants')
  variants_launches, variants = phase_variants(torch, device, trainer)
  for r in results:
    r['launches_variants'] = {mode: counts[r['name']]
                              for mode, counts in variants_launches.items()}
  stamp('14 parallel')
  parallel_launches, parallel = phase_parallel(torch, device, trainer)
  for r in results:
    r['launches_parallel'] = {case: counts[r['name']]
                              for case, counts in parallel_launches.items()}
  stamp('15 CLIs')
  bench_launches, clis = phase_clis(torch, device)
  for r in results:
    r['launches_bench'] = {part: counts[r['name']]
                           for part, counts in bench_launches.items()}
    r['max_abs_err'] = max(r['max_abs_err'], clis['bench_shapes'][
        'max_abs_err'].get(r['name'], 0.0))
  for r in results:
    r['launches_speed_modes'] = {mode: counts[r['name']]
                                 for mode, counts in speed_launches.items()}
    r['launches_deformation'] = {
        mode: counts[r['name']]
        for mode, counts in deformation_launches.items()}
  stamp('end')
  print(json.dumps({'kernels': results}))
  print(f'training at batch {TRAIN_BATCH}, steady steps: ' + '; '.join(
      f'{name} path {t["rays_per_s"]} rays/s, {t["step_ms"]} ms a step, peak '
      f'{t["peak_gib"]} GiB, {t["host_syncs"]} host syncs a step'
      for name, t in train.items()))
  print('eval: ' + json.dumps(evaluation))
  print('capture: ' + json.dumps(capture))
  print('speed modes: ' + json.dumps(speed))
  print('deformation: ' + json.dumps(deformation))
  print('radiance: ' + json.dumps(radiance))
  print('variants: ' + json.dumps(variants))
  print('parallel: ' + json.dumps(parallel))
  print('bench: ' + json.dumps(clis))
  print('wall s at the start of each phase: ' + json.dumps(walls))
  print(f'card: {card_line()}')
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  if sys.argv[1:2] == ['--parallel-rank']:
    sys.exit(parallel_rank(sys.argv[2], int(sys.argv[3])))
  sys.exit(main())
