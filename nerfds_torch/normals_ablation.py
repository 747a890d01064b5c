"""Do normals earn their keep? Counterpart of
``scripts/normals_ablation.py``: the full NeRF-DS against a no-normals
ablation on a scene where view-dependent shading is hard without normals.

Scene: the specular synthetic scene with a SHARP Blinn-Phong highlight
(``--exponent`` 100 against the default 25) on the moving sphere, white
background (``--scene emissive``), or a non-emissive Blinn-Phong surface
lit by a camera-anchored light, whose highlight moves against the
object's motion (``--scene mechanism``). The ground truth is marched in
torch on ``--device``. Val views are held-out novel times.

Metric: masked val PSNR, over the moving object's pixels only, where the
highlight lives (a whole-image PSNR dilutes it with static background).

Cases (``CASES``, the JAX script's): 'full' (the shipped config),
'ref_radiance' (full + the reflection-vector rgb condition) and
'no_normals' (no predicted normal, no normal supervision, no normal
input to the rgb branch). One ``Trainer`` a case serves every seed; the
paired deltas against 'full' at the same seed close the run:

  python -m nerfds_torch.normals_ablation --steps 10000 --seeds 0,1,2

Writes one JSON line a (case, seed), a ``PAIRED_SUMMARY`` line and
``<out>/<tag>.json`` (``--out`` defaults to ``artifacts/torch``, beside
and apart from the JAX package's ``artifacts/`` files); ``--save_panels``
adds a GT | prediction PNG of the first val frame a run. ``--path
kernel`` (default) trains through K1f, K1b and K2.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
from typing import Optional, Sequence

import numpy as np
import torch

from nerfds_torch import bench

CASES = {
    'full': {},
    'ref_radiance': {'use_ref_radiance': True},
    'no_normals': {'predict_norm': False, 'use_predicted_norm': False},
}


def save_panel(trainer, state, src, item_id, path):
  """GT | prediction panel of one val frame."""
  from nerfds_torch import image_utils
  from nerfds_torch.evaluation.render import render_image
  from nerfds_torch.trainer import eval_extra_params
  item = src.load_item(item_id)
  rays = {k: item[k] for k in ('origins', 'directions', 'mask')}
  rays['metadata'] = {k: v[:1, :1].reshape(1, -1)
                      for k, v in item['metadata'].items()}
  model = trainer.model_with_params(state.params)
  extra = eval_extra_params(model.config, trainer.train_cfg, state.step)
  out = render_image(model, rays, extra, chunk=4096, keys=('rgb',),
                     generator=torch.Generator(
                         device=model.device).manual_seed(0))
  panel = np.concatenate([item['rgb'], np.asarray(out['rgb'])], axis=1)
  image_utils.save_image(path, panel)


def paired_summary(rows, seeds):
  """Per-case paired deltas of the val metrics against 'full' at the same
  seed."""
  by = {(r['case'], r['seed']): r for r in rows}
  summary = {}
  for name in sorted({r['case'] for r in rows} - {'full'}):
    for metric in ('val_masked_psnr', 'val_psnr', 'val_ms_ssim'):
      d = [by[(name, s)][metric] - by[('full', s)][metric]
           for s in seeds if (name, s) in by and ('full', s) in by]
      if d:
        summary.setdefault(name, {})[f'delta_{metric}'] = {
            'mean': round(sum(d) / len(d), 3),
            'per_seed': [round(x, 3) for x in d]}
  return summary


def main(argv: Optional[Sequence[str]] = None):
  """Prints and writes the rows; returns (rows, paired summary)."""
  p = argparse.ArgumentParser(prog='python -m nerfds_torch.normals_ablation')
  p.add_argument('--steps', type=int, default=10000)
  p.add_argument('--batch', type=int, default=2048)
  p.add_argument('--frames', type=int, default=16)
  p.add_argument('--image_size', type=int, default=64)
  p.add_argument('--exponent', type=float, default=100.0)
  p.add_argument('--seeds', default='0', help='comma-separated paired seeds')
  p.add_argument('--scene', default='emissive',
                 choices=['emissive', 'mechanism'],
                 help="'emissive': the highlight on the emissive scene; "
                      "'mechanism': a non-emissive Blinn-Phong surface lit "
                      'by a camera-anchored light')
  p.add_argument('--cases', default='full,ref_radiance,no_normals')
  p.add_argument('--tag', default='normals_ablation',
                 help='output file stem under --out')
  p.add_argument('--save_panels', action='store_true')
  p.add_argument('--out', default='artifacts/torch')
  p.add_argument('--path', default='kernel', choices=bench.PATHS)
  p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
  args = p.parse_args(argv)

  from nerfds_torch.convergence_run import train_config
  from nerfds_torch.datasets.synthetic import SyntheticDataSource
  from nerfds_torch.device import resolve_device
  from nerfds_torch.trainer import Trainer

  device = resolve_device(args.device)
  steps = args.steps
  scene = (dict(field_kind='shaded', light_mode='camera')
           if args.scene == 'mechanism' else dict(specular=True))
  src = SyntheticDataSource(num_frames=args.frames,
                            image_size=args.image_size, gt_samples=192,
                            white_background=True,
                            specular_exponent=args.exponent,
                            gt_backend='torch', device=device, **scene)
  seeds = [int(s) for s in args.seeds.split(',')]
  out_dir = pathlib.Path(args.out)
  out_dir.mkdir(parents=True, exist_ok=True)
  rows = []
  for name in args.cases.split(','):
    model_cfg = bench.model_config(
        path=args.path, overrides=dict(CASES[name],
                                       use_white_background=True))
    train_cfg = dataclasses.replace(
        train_config(steps, args.batch, seeds[0]),
        print_every=max(steps // 20, 1))
    trainer = Trainer.from_experiment(model_cfg, train_cfg, src,
                                      exp_dir=None, use_mesh=False,
                                      device=device)
    for seed in seeds:
      trainer.train_cfg = dataclasses.replace(trainer.train_cfg,
                                              random_seed=seed)
      t0 = time.time()
      state = trainer.train(state=trainer.init_state(seed))
      wall = time.time() - t0
      m_train = trainer.eval_psnr(state, item_ids=src.train_ids[:4],
                                  masked=True)
      m_val = trainer.eval_psnr(state, masked=True)
      row = {'case': name, 'scene': args.scene, 'steps': steps,
             'batch': args.batch, 'exponent': args.exponent, 'seed': seed,
             'wall_s': round(wall, 1),
             'train_psnr': round(m_train['psnr'], 3),
             'train_masked_psnr': round(m_train.get('masked_psnr',
                                                    float('nan')), 3),
             'val_psnr': round(m_val['psnr'], 3),
             'val_masked_psnr': round(m_val.get('masked_psnr',
                                                float('nan')), 3),
             'val_ms_ssim': round(m_val['ms_ssim'], 4),
             'path': args.path}
      print(json.dumps(row), flush=True)
      rows.append(row)
      if args.save_panels:
        save_panel(trainer, state, src, src.val_ids[0],
                   out_dir / f'{args.tag}_{name}_s{seed}.png')

  summary = paired_summary(rows, seeds)
  print('PAIRED_SUMMARY ' + json.dumps(summary), flush=True)
  (out_dir / f'{args.tag}.json').write_text(
      json.dumps({'rows': rows, 'paired_vs_full': summary}, indent=2) + '\n')
  return rows, summary


if __name__ == '__main__':
  main()
