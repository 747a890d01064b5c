"""Long-horizon convergence run, counterpart of
``scripts/convergence_run.py``: PSNR against wall-clock time on the
specular scene.

Trains the full NeRF-DS architecture (trunk 8x256 skip at 4, SE(3) 6x128,
hyper 6x64, mask 8x128, 64 + 64 samples) on the specular synthetic scene
with a white background, its schedules rescaled to ``--steps``, and
writes a JSONL curve of train and val PSNR and val MS-SSIM every
``--eval_every`` steps; at the end (unless ``--no_normals``) the normal
fidelity: the cosine between the observation-frame normal at each
foreground ray's median-weight sample and the moving sphere's analytic
normal there, on train views.

  python -m nerfds_torch.convergence_run --steps 20000 \\
      --out artifacts/torch/conv_full.jsonl
  python -m nerfds_torch.convergence_run --steps 20000 --no_normals \\
      --out artifacts/torch/conv_nonorm.jsonl     # the ablation

``--path kernel`` (default) trains through K1f, K1b and K2; ``--path
plain`` runs the preset's 'vmap' ∇σ and plain compositing.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Optional, Sequence

from nerfds_torch import bench


def train_config(steps: int, batch: int, seed: int):
  """``nerf_ds_train_config`` with nerf_ds.gin's schedules rescaled from
  250k steps to ``steps`` (the JAX script's proportions)."""
  from nerfds_torch import config as config_lib
  return dataclasses.replace(
      config_lib.nerf_ds_train_config(max_steps=steps, batch_size=batch),
      lr_schedule=('exponential', 1e-3, 1e-5, steps),
      warp_alpha_schedule=('linear', 0, 4, steps // 5),
      norm_input_alpha_schedule=(
          'piecewise', ((steps // 25, ('constant', 0.0)),
                        (0, ('linear', 0.0, 4.0, steps // 10)))),
      sharp_mask_std_schedule=(
          'piecewise', ((steps // 8, ('exponential', 1.0, 0.1, steps // 8)),
                        (steps, ('constant', 0.1)))),
      x_for_rgb_alpha_schedule=(
          'piecewise', ((steps // 5, ('constant', 0.0)),
                        (steps // 5, ('linear', 0.0, 4.0, steps // 5)),
                        (steps, ('constant', 4.0)))),
      random_seed=seed, print_every=max(steps // 50, 1),
      save_every=10 ** 9)


def main(argv: Optional[Sequence[str]] = None):
  """Writes and prints the rows; returns them."""
  p = argparse.ArgumentParser(prog='python -m nerfds_torch.convergence_run')
  p.add_argument('--steps', type=int, default=20000)
  p.add_argument('--batch', type=int, default=2048)
  p.add_argument('--eval_every', type=int, default=2000)
  p.add_argument('--frames', type=int, default=16)
  p.add_argument('--image_size', type=int, default=64)
  p.add_argument('--no_normals', action='store_true',
                 help='ablation: disable the normal branch entirely')
  p.add_argument('--seed', type=int, default=0)
  p.add_argument('--out', default='artifacts/torch/convergence.jsonl')
  p.add_argument('--path', default='kernel', choices=bench.PATHS)
  p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
  args = p.parse_args(argv)

  from nerfds_torch.datasets.synthetic import (SyntheticDataSource,
                                               _sphere_center)
  from nerfds_torch.device import resolve_device
  from nerfds_torch.trainer import Trainer, eval_extra_params

  device = resolve_device(args.device)
  steps = args.steps
  # White background (scene and model): with a black one, the opaque
  # all-black fog is a strong local minimum of full-schedule runs.
  src = SyntheticDataSource(num_frames=args.frames,
                            image_size=args.image_size,
                            gt_samples=192, specular=True,
                            white_background=True)
  over = {'use_white_background': True}
  if args.no_normals:
    over.update(predict_norm=False, use_predicted_norm=False)
  model_cfg = bench.model_config(path=args.path, overrides=over)
  train_cfg = train_config(steps, args.batch, args.seed)
  trainer = Trainer.from_experiment(model_cfg, train_cfg, src,
                                    exp_dir=None, use_mesh=False,
                                    device=device)

  out_path = Path(args.out)
  out_path.parent.mkdir(parents=True, exist_ok=True)
  out_path.write_text('')
  t_start = time.time()
  rows = []

  def emit(row):
    rows.append(row)
    with out_path.open('a') as f:
      f.write(json.dumps(row) + '\n')
    print(json.dumps(row), flush=True)

  emit({'meta': {'steps': steps, 'batch': args.batch,
                 'no_normals': args.no_normals, 'frames': args.frames,
                 'image_size': args.image_size, 'seed': args.seed,
                 'path': args.path}})

  store = trainer.build_store()
  state = trainer.init_state(args.seed)
  for start in range(0, steps, args.eval_every):
    n = min(args.eval_every, steps - start)
    state = trainer.train(num_steps=start + n, state=state, store=store)
    wall = time.time() - t_start
    m_train = trainer.eval_psnr(state, item_ids=src.train_ids[:3])
    m_val = trainer.eval_psnr(state)
    emit({'step': start + n, 'wall_s': round(wall, 1),
          'train_psnr': round(m_train['psnr'], 3),
          'val_psnr': round(m_val['psnr'], 3),
          'val_ms_ssim': round(m_val['ms_ssim'], 4)})

  if not args.no_normals:
    from nerfds_torch.evaluation.normals import (normal_fidelity,
                                                 sphere_analytic_normal,
                                                 sphere_surface_filter)
    extra = eval_extra_params(model_cfg, train_cfg, state.step)
    fid = normal_fidelity(trainer.model, state.params, src, extra,
                          sphere_analytic_normal(_sphere_center),
                          item_ids=src.train_ids[:4],
                          surface_filter=sphere_surface_filter(
                              _sphere_center))
    emit({'normal_cosine_train_views': round(fid['cosine'], 4),
          'normal_surface_cosine': round(fid['surface_cosine'], 4),
          'normal_pixels': fid['num_pixels'],
          'normal_surface_pixels': fid['surface_pixels'],
          'normal_frac_selected': round(fid['frac_selected'], 4),
          'note': 'median-weight sample association: observation-frame '
                  'norm_input vs analytic outward normal'})
  return rows


if __name__ == '__main__':
  main()
