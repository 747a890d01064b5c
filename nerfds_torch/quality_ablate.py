"""Quality cost of the speed modes, counterpart of
``scripts/quality_ablate.py``: trains the full NeRF-DS architecture on the
synthetic dynamic scene and reports train and val PSNR per configuration.

The synthetic scene (``datasets/synthetic.py``) has analytic ground truth
and a per-frame deformation, so the val PSNR at novel times (interpolated
warp embeddings) measures what the speed modes endanger: the deformation
and normal structure.

Paired-seed protocol (the default): the f32 baseline's spread over seeds
on this scene is about 3 dB, larger than the effects under test, so raw
PSNRs say little. Every case is trained at each seed and compared with the
f32 baseline at the same seed; the verdict is the paired delta's mean and
spread over 3 or more seeds. One ``Trainer`` per case serves every seed.

  python -m nerfds_torch.quality_ablate --steps 5000 --batch 1024 \\
      --seeds 0,1,2 --cases topk16 --out /tmp/quality_gate.jsonl
  python -m nerfds_torch.quality_ablate --list

The cases, the recipe (``make_trainer``), the rows and the
``PAIRED_SUMMARY`` line are the JAX script's. ``--device`` (default
``cuda``) picks the card or the CPU; ``--sigma_gradient_mode`` (default
``vmap``, the preset's) is applied to every case and picks which
implementation computes ∇σ: on the card ``fused`` runs the trunk kernels.
``norm_grad_topk`` is active only in ``vmap``, so ``fused`` refuses the
top-k cases, which would run the exact path and compare f32 with f32.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional, Sequence

CASES = {
    'f32': {},
    'bf16_all': {'compute_dtype': 'bfloat16'},
    'bf16_trunk_rgb_mask': {'compute_dtype': 'bfloat16',
                            'bf16_zones': ('trunk', 'rgb', 'mask')},
    'bf16_warp_hyper': {'compute_dtype': 'bfloat16',
                        'bf16_zones': ('warp', 'hyper')},
    'bf16_trunk': {'compute_dtype': 'bfloat16', 'bf16_zones': ('trunk',)},
    'bf16_trunk_rgb': {'compute_dtype': 'bfloat16',
                       'bf16_zones': ('trunk', 'rgb')},
    'storage_bf16': {'storage_dtype': 'bfloat16'},
    'stop_target_norm': {'stop_target_norm_gradient': True},
    'topk16': {'norm_grad_topk': 16},
    'topk12': {'norm_grad_topk': 12},
    'topk8': {'norm_grad_topk': 8},
}


def make_trainer(model_overrides, steps, batch_size, device=None):
  """The JAX script's recipe: ``nerf_ds()`` with the case's overrides, its
  training config with every schedule compressed to ``steps``, on
  ``SyntheticDataSource(num_frames=16, image_size=48, gt_samples=128)``."""
  from nerfds_torch import config as config_lib
  from nerfds_torch.datasets.synthetic import SyntheticDataSource
  from nerfds_torch.trainer import Trainer

  model_cfg = dataclasses.replace(config_lib.nerf_ds(), **model_overrides)
  train_cfg = dataclasses.replace(
      config_lib.nerf_ds_train_config(max_steps=steps,
                                      batch_size=batch_size),
      lr_schedule=('exponential', 1e-3, 1e-4, steps),
      warp_alpha_schedule=('linear', 0, 4, steps // 3),
      norm_input_alpha_schedule=(
          'piecewise', ((steps // 5, ('constant', 0.0)),
                        (0, ('linear', 0.0, 4.0, steps // 10)))),
      sharp_mask_std_schedule=(
          'piecewise', ((steps // 2, ('exponential', 1.0, 0.1, steps // 2)),
                        (steps, ('constant', 0.1)))),
      x_for_rgb_alpha_schedule=(
          'piecewise', ((steps // 3, ('constant', 0.0)),
                        (steps // 3, ('linear', 0.0, 4.0, steps // 3)),
                        (steps, ('constant', 4.0)))),
      random_seed=0, print_every=max(steps // 10, 1), save_every=10**9)
  source = SyntheticDataSource(num_frames=16, image_size=48, gt_samples=128)
  return Trainer.from_experiment(model_cfg, train_cfg, source,
                                 exp_dir=None, use_mesh=False,
                                 sampling='auto', device=device)


def run_seed(trainer, name, steps, batch_size, seed):
  """One (case, seed) training run on a case-shared Trainer."""
  source = trainer.datasource
  # Re-seed everything outside the step: init, data order, noise.
  trainer.train_cfg = dataclasses.replace(trainer.train_cfg,
                                          random_seed=seed)
  t0 = time.time()
  state = trainer.train(state=trainer.init_state(seed))
  train_m = trainer.eval_psnr(state, item_ids=source.train_ids[:4])
  val_m = trainer.eval_psnr(state)  # val = held-out novel times
  wall = time.time() - t0
  row = {'case': name, 'steps': steps, 'batch': batch_size, 'seed': seed,
         'wall_s': round(wall, 1),
         'train_psnr': round(train_m['psnr'], 2),
         'train_ssim': round(train_m['ssim'], 4),
         'val_psnr': round(val_m['psnr'], 2),
         'val_ssim': round(val_m['ssim'], 4),
         'val_ms_ssim': round(val_m['ms_ssim'], 4)}
  print(json.dumps(row), flush=True)
  return row


def paired_summary(rows, base_case='f32'):
  """Per-case paired deltas vs the base case at the same seed."""
  by = {}
  for r in rows:
    by[(r['case'], r['seed'])] = r
  cases = sorted({r['case'] for r in rows} - {base_case})
  seeds = sorted({r['seed'] for r in rows})
  summary = {}
  for case in cases:
    deltas = {}
    for metric in ('val_psnr', 'val_ms_ssim'):
      d = [by[(case, s)][metric] - by[(base_case, s)][metric]
           for s in seeds if (case, s) in by and (base_case, s) in by]
      if d:
        deltas[f'delta_{metric}'] = {
            'mean': round(sum(d) / len(d), 3),
            'min': round(min(d), 3), 'max': round(max(d), 3),
            'per_seed': [round(x, 3) for x in d], 'n_seeds': len(d)}
    summary[case] = deltas
  return summary


def main(argv: Optional[Sequence[str]] = None):
  p = argparse.ArgumentParser(prog='python -m nerfds_torch.quality_ablate')
  p.add_argument('--steps', type=int, default=5000)
  p.add_argument('--batch', type=int, default=1024)
  p.add_argument('--seeds', default='0',
                 help='comma-separated seeds; paired deltas need >= 2')
  p.add_argument('--cases', default='topk16,topk12')
  p.add_argument('--no_paired', action='store_true',
                 help='skip the implicit f32 baseline runs')
  p.add_argument('--out', default=None, help='append rows as JSONL')
  p.add_argument('--list', action='store_true')
  p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                 help="'cuda' (default) or 'cpu' for the plain path")
  p.add_argument('--sigma_gradient_mode', default='vmap',
                 choices=['vmap', 'fused'],
                 help='the ∇σ implementation of every case')
  args = p.parse_args(argv)
  if args.list:
    print('\n'.join(CASES))
    return []
  seeds = [int(s) for s in args.seeds.split(',')]
  cases = [c for c in args.cases.split(',') if c]
  if not args.no_paired and 'f32' not in cases:
    cases = ['f32'] + cases
  topk = [c for c in cases if CASES[c].get('norm_grad_topk')]
  if args.sigma_gradient_mode == 'fused' and topk:
    p.error(f'{",".join(topk)}: norm_grad_topk is active only with '
            '--sigma_gradient_mode vmap')
  from nerfds_torch.device import resolve_device
  device = resolve_device(args.device)

  out_fp = open(args.out, 'a') if args.out else None
  rows = []
  for name in cases:
    overrides = {**CASES[name],
                 'sigma_gradient_mode': args.sigma_gradient_mode}
    trainer = make_trainer(overrides, args.steps, args.batch, device)
    for seed in seeds:
      row = run_seed(trainer, name, args.steps, args.batch, seed)
      rows.append(row)
      if out_fp:
        out_fp.write(json.dumps(row) + '\n')
        out_fp.flush()
  if not args.no_paired and len(cases) > 1:
    summary = paired_summary(rows)
    print('PAIRED_SUMMARY ' + json.dumps(summary), flush=True)
    if out_fp:
      out_fp.write(json.dumps({'paired_summary': summary}) + '\n')
  if out_fp:
    out_fp.close()
  return rows


if __name__ == '__main__':
  main()
