"""Counts what the bf16 trunk kernels' in-order sums do (``resum`` in
``csrc/trunk_mma.cuh``) on the full-width nerf_ds trunk with random
weights, on a CUDA card:

  python -m nerfds_torch.kernels.resum_stats [--n 65536] [--seed 3]

Builds ``csrc/fused_trunk_fwd_bf16.cu`` and ``fused_trunk_bwd_bf16.cu``
with ``-DTRUNK_SEQ_STATS`` into the build directory, runs K1f and K1b in
bf16 through their wrappers on that library, and prints for each: the sums
tested (those that a bf16 rounding or a relu mask decides), those summed
again in k order, those that then fell the other way, and the largest
|tensor-core sum - in-order sum| among them in units of 2^-24 M, against
the window of SEQ_WINDOW such units.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import re
import struct
import subprocess

import torch

from nerfds_torch import config as config_lib
from nerfds_torch.kernels import build, fused_trunk
from nerfds_torch.models.mlp import NerfMLP

SOURCES = ('fused_trunk_fwd_bf16.cu', 'fused_trunk_bwd_bf16.cu')
ENTRIES = {'fused_trunk_fwd_bf16': 'trunk_fwd_bf16_seq_stats',
           'fused_trunk_bwd_bf16': 'trunk_bwd_bf16_seq_stats'}


def stats_library() -> ctypes.CDLL:
  """The two bf16 entries and their counters, built once per source hash."""
  sources = [build.CSRC / s for s in SOURCES]
  out = build.BUILD_DIR / (
      f'libnerfds_resum_stats_{build._digest(sources)}.so')
  if not out.exists():
    build._compile(sources, out, defines=('TRUNK_SEQ_STATS',))
  lib = ctypes.CDLL(str(out))
  for name, counter in ENTRIES.items():
    getattr(lib, name).argtypes = build.SIGNATURES[name]
    getattr(lib, name).restype = ctypes.c_int
    getattr(lib, counter).argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
  return lib


@contextlib.contextmanager
def wrappers_on(lib):
  """The kernel wrappers launch from ``lib`` within the block."""
  saved = build.load_library
  build.load_library = lambda: lib
  try:
    yield
  finally:
    build.load_library = saved


def counters(lib, entry: str) -> dict:
  """The counters of ``entry`` since the last read (which resets them)."""
  raw = (ctypes.c_ulonglong * 4)()
  build.check(getattr(lib, ENTRIES[entry])(raw), ENTRIES[entry])
  largest = struct.unpack('<f', struct.pack('<I', raw[3] & 0xffffffff))[0]
  return dict(tested=raw[0], summed_again=raw[1], moved=raw[2],
              largest_units=largest)


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--n', type=int, default=65_536)
  parser.add_argument('--seed', type=int, default=3)
  args = parser.parse_args(argv)
  if not torch.cuda.is_available():
    raise SystemExit('resum_stats needs a CUDA card')
  device = torch.device('cuda')
  card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                         '--format=csv,noheader'], capture_output=True,
                        text=True).stdout.strip()
  window = int(re.search(r'constexpr int SEQ_WINDOW = (\d+);',
                         (build.CSRC / 'trunk_mma.cuh').read_text()).group(1))
  cfg = config_lib.nerf_ds()
  mlp = NerfMLP(in_dim=52, alpha_cond_dim=0, rgb_cond_dim=0,
                has_condition=True, trunk_depth=cfg.nerf_trunk_depth,
                trunk_width=cfg.nerf_trunk_width, skips=cfg.nerf_skips,
                predict_norm=True,
                generator=torch.Generator().manual_seed(args.seed)).to(device)
  spec = fused_trunk.TrunkSpec(
      depth=cfg.nerf_trunk_depth, width=cfg.nerf_trunk_width,
      skips=tuple(cfg.nerf_skips), in_dim=52, alpha_channels=1, norm_dim=3,
      has_bottleneck=True)
  weights = mlp.trunk_weights()
  gen = torch.Generator(device=device).manual_seed(args.n + args.seed)
  feat = torch.rand(args.n, spec.in_dim, generator=gen, device=device) * 2 - 1
  cots = tuple(torch.randn(args.n, c, generator=gen, device=device)
               for c in (1, spec.norm_dim, spec.width, spec.width,
                         spec.in_dim))
  lib = stats_library()
  print(card)
  bf16 = torch.bfloat16
  runs = {'fused_trunk_fwd_bf16': lambda: fused_trunk.trunk_sigma_grad(
              feat, weights, spec, compute_dtype=bf16),
          'fused_trunk_bwd_bf16': lambda: fused_trunk.trunk_sigma_grad_backward(
              feat, weights, spec, cots, compute_dtype=bf16)}
  with torch.no_grad(), wrappers_on(lib):
    for entry, run in runs.items():
      counters(lib, entry)
      run()
      torch.cuda.synchronize()
      c = counters(lib, entry)
      print(f'{entry} at N={args.n}: {c["tested"]} sums decided, '
            f'{c["summed_again"]} summed again '
            f'({c["summed_again"] / max(c["tested"], 1):.3%}), '
            f'{c["moved"]} of them fell the other way; largest '
            f'|tensor cores - in order| {c["largest_units"]:.3f} x 2^-24 M '
            f'(window {window})')
  return 0


if __name__ == '__main__':
  raise SystemExit(main())
