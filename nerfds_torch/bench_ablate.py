"""Cost attribution, counterpart of ``scripts/bench_ablate.py``: times the
training step across ablated configurations.

Each row disables one architectural component of the shipped NeRF-DS
config (or turns on one speed mode) so that its cost reads off as the
step-time delta from 'full'. The rows are the JAX script's ``ABLATIONS``,
applied on top of ``--path`` (``bench.model_config``); the step, batch and
timing are ``nerfds_torch.bench``'s, one chain of ``--iters`` steps a row.

  python -m nerfds_torch.bench_ablate [--batch N] [--iters N]
      [--only name ...] [--path kernel|plain] [--device cuda|cpu]

Under ``--path kernel`` the 'bf16' row runs K1f and K1b in their bf16
instantiations, and the top-k rows are refused with JAX's error row:
``norm_grad_topk`` is active only under 'vmap' or 'naive' ∇σ, so they
would time the full step under another name. ``--path plain`` runs the
whole table as JAX's does. Each row is its own study: a row that fails
prints its error and the table goes on, as in the JAX script. Every JSON
line carries ``"path"`` beside the JAX keys.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from nerfds_torch import bench
from nerfds_torch.device import resolve_device

ABLATIONS = {
    'full': {},
    'no_mask_mlp': dict(use_predicted_mask=False, use_mask_sharp_weights=False,
                        use_3d_mask=False),
    'no_norm': dict(predict_norm=False, use_predicted_norm=False,
                    norm_supervision_type='warped'),
    'no_warp': dict(use_warp=False, use_mask_in_warp=False,
                    hyper_use_warp_embed=False),
    'no_hyper': dict(hyper_slice_method='none', use_mask_in_hyper=False),
    'no_x_in_rgb': dict(use_x_in_rgb_condition=False),
    'topk32': dict(norm_grad_topk=32),
    'topk16': dict(norm_grad_topk=16),
    'topk12': dict(norm_grad_topk=12),
    'topk8': dict(norm_grad_topk=8),
    'remat': dict(remat_sigma=True),
    'remat_feat': dict(remat_feat=True),
    'bf16': dict(compute_dtype='bfloat16'),
}


def check_row(name: str, path: str) -> None:
  """Raises ValueError for a row that ``path`` cannot run as named."""
  cfg = bench.model_config(path=path, overrides=ABLATIONS[name])
  if cfg.norm_grad_topk and not cfg.norm_grad_topk_active:
    raise ValueError(
        f'{name}: norm_grad_topk is active only under sigma_gradient_mode '
        f"'vmap' or 'naive'; --path {path} runs "
        f"'{cfg.sigma_gradient_mode}'")


def main(argv: Optional[Sequence[str]] = None):
  """Prints the rows; returns ({name: ms a step}, {name: the row's
  ``bench.measure`` record})."""
  p = argparse.ArgumentParser(prog='python -m nerfds_torch.bench_ablate')
  p.add_argument('--batch', type=int, default=2048)
  p.add_argument('--warmup', type=int, default=3)
  p.add_argument('--iters', type=int, default=10)
  p.add_argument('--only', nargs='*', default=None)
  p.add_argument('--path', default='kernel', choices=bench.PATHS)
  p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
  args = p.parse_args(argv)
  device = resolve_device(args.device)

  names = args.only or list(ABLATIONS)
  results, runs = {}, {}
  for name in names:
    try:
      check_row(name, args.path)
      run = bench.measure(args.batch, False, args.path, device, args.warmup,
                          args.iters, 1, overrides=ABLATIONS[name])
      runs[name] = run
      results[name] = round(run['sec'] * 1e3, 2)
      print(json.dumps({'ablation': name, 'ms_per_step': results[name],
                        'rays_per_sec': round(args.batch / run['sec'], 0),
                        'path': args.path}), flush=True)
    except Exception as e:  # one row's failure is that row's result
      print(json.dumps({'ablation': name, 'error': repr(e)[:200],
                        'path': args.path}), flush=True)
  if 'full' in results:
    base = results['full']
    for name, ms in results.items():
      if name != 'full':
        print(f'# {name}: {base - ms:+.1f} ms vs full ({ms} ms)')
  return results, runs


if __name__ == '__main__':
  main()
