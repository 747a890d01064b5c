"""Large-batch training recipe, counterpart of
``scripts/batch_scaling_study.py``.

The reference trains at a global batch of 512 rays; scaling the batch with
cards needs a validated lr/batch rule. The study holds the TOTAL RAY
BUDGET fixed (steps x batch = const, so every run sees the same number of
rays and the same annealing trajectory in epoch terms) and compares:

  batch  512  the reference operating point, base lr (the control)
  batch 2048  linear-scaled (lr x4) and sqrt-scaled (lr x2)
  batch 8192  linear-scaled (lr x16) and sqrt-scaled (lr x4)

Every scaled run gets a linear lr warm-up over 5% of its steps; runs at a
batch of 4096 or more accumulate 1024-ray microbatches
(``train.accum_steps``, the same optimizer trajectory as the whole
batch). Paired seeds; the verdict is the paired delta of novel-time val
PSNR against the 512 control at the same seed.

  python -m nerfds_torch.batch_scaling_study --seeds 0,1

Writes ``--out`` (default ``artifacts/torch/batch_scaling.json``, apart
from the JAX package's ``artifacts/batch_scaling.json``). ``--path
kernel`` (default) trains through K1f, K1b and K2.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
from typing import Optional, Sequence

from nerfds_torch import bench


def lr_factor(rule: str, batch: int, base_batch: int = 512) -> float:
  k = batch / base_batch
  return {'linear': k, 'sqrt': k ** 0.5, 'none': 1.0}[rule]


def make_configs(batch, steps, rule, seed, path='kernel'):
  """(model config, train config) of one grid point: the JAX script's
  recipe, on ``path``."""
  from nerfds_torch import config as config_lib
  f = lr_factor(rule, batch)
  lr0, lr1 = 1e-3 * f, 1e-4 * f
  warmup = max(steps // 20, 1)
  if rule == 'none':
    lr_schedule = ('exponential', lr0, lr1, steps)
  else:
    lr_schedule = ('piecewise', (
        (warmup, ('linear', lr0 / 10.0, lr0, warmup)),
        (steps - warmup, ('exponential', lr0, lr1, steps - warmup)),
    ))
  # A whole batch of 8192 x 128 samples does not fit one device's memory
  # in the JAX package; 1024-ray microbatches do, with the same trajectory.
  accum = batch // 1024 if batch >= 4096 else 1
  train_cfg = dataclasses.replace(
      config_lib.nerf_ds_train_config(max_steps=steps, batch_size=batch),
      accum_steps=accum,
      lr_schedule=lr_schedule,
      warp_alpha_schedule=('linear', 0, 4, steps // 3),
      norm_input_alpha_schedule=(
          'piecewise', ((steps // 5, ('constant', 0.0)),
                        (0, ('linear', 0.0, 4.0, max(steps // 10, 1))))),
      sharp_mask_std_schedule=(
          'piecewise', ((steps // 2, ('exponential', 1.0, 0.1, steps // 2)),
                        (steps, ('constant', 0.1)))),
      x_for_rgb_alpha_schedule=(
          'piecewise', ((steps // 3, ('constant', 0.0)),
                        (steps // 3, ('linear', 0.0, 4.0, steps // 3)),
                        (steps, ('constant', 4.0)))),
      random_seed=seed, print_every=max(steps // 10, 1), save_every=10**9)
  return bench.model_config(path=path), train_cfg


def make_trainer(batch, steps, rule, seed, source, path='kernel',
                 device=None):
  from nerfds_torch.trainer import Trainer
  model_cfg, train_cfg = make_configs(batch, steps, rule, seed, path)
  return Trainer.from_experiment(model_cfg, train_cfg, source,
                                 exp_dir=None, use_mesh=False,
                                 sampling='auto', device=device)


def paired_summary(rows, grid, seeds):
  """Paired val-PSNR deltas of each scaled grid point against the 512
  control at the same seed."""
  by = {(r['batch'], r['rule'], r['seed']): r for r in rows}
  summary = {}
  for batch, rule in grid:
    if rule == 'none':
      continue
    d = [by[(batch, rule, s)]['val_psnr'] - by[(512, 'none', s)]['val_psnr']
         for s in seeds
         if (batch, rule, s) in by and (512, 'none', s) in by]
    if d:
      summary[f'{batch}:{rule}'] = {
          'delta_val_psnr_mean': round(sum(d) / len(d), 3),
          'per_seed': [round(x, 3) for x in d]}
  return summary


def main(argv: Optional[Sequence[str]] = None):
  """Prints the rows and the summary, writes ``--out``; returns both."""
  p = argparse.ArgumentParser(
      prog='python -m nerfds_torch.batch_scaling_study')
  p.add_argument('--ray_budget', type=int, default=5_120_000,
                 help='total rays per run (steps = budget / batch)')
  p.add_argument('--seeds', default='0,1')
  p.add_argument('--grid', default='512:none,2048:linear,2048:sqrt,'
                                   '8192:linear,8192:sqrt')
  p.add_argument('--out', default='artifacts/torch/batch_scaling.json')
  p.add_argument('--path', default='kernel', choices=bench.PATHS)
  p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
  args = p.parse_args(argv)

  from nerfds_torch.datasets.synthetic import SyntheticDataSource
  from nerfds_torch.device import resolve_device
  device = resolve_device(args.device)
  seeds = [int(s) for s in args.seeds.split(',')]
  grid = []
  for spec in args.grid.split(','):
    b, r = spec.split(':')
    grid.append((int(b), r))
  source = SyntheticDataSource(num_frames=16, image_size=48,
                               gt_samples=128)

  rows = []
  for batch, rule in grid:
    steps = max(args.ray_budget // batch, 1)
    trainer = None
    for seed in seeds:
      if trainer is None:
        trainer = make_trainer(batch, steps, rule, seed, source, args.path,
                               device)
      else:  # one Trainer a grid point; re-seed what lies outside the step
        trainer.train_cfg = dataclasses.replace(trainer.train_cfg,
                                                random_seed=seed)
      t0 = time.time()
      state = trainer.train(state=trainer.init_state(seed))
      wall = time.time() - t0
      val = trainer.eval_psnr(state)
      row = {'batch': batch, 'rule': rule, 'steps': steps, 'seed': seed,
             'lr0': 1e-3 * lr_factor(rule, batch),
             'wall_s': round(wall, 1),
             'rays_per_sec': round(batch * steps / wall, 1),
             'val_psnr': round(val['psnr'], 2),
             'val_ms_ssim': round(val['ms_ssim'], 4),
             'path': args.path}
      print(json.dumps(row), flush=True)
      rows.append(row)

  summary = paired_summary(rows, grid, seeds)
  print('PAIRED_SUMMARY ' + json.dumps(summary), flush=True)
  out = pathlib.Path(args.out)
  out.parent.mkdir(parents=True, exist_ok=True)
  out.write_text(
      json.dumps({'rows': rows, 'paired_vs_512': summary}, indent=2) + '\n')
  return rows, summary


if __name__ == '__main__':
  main()
