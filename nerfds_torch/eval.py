"""Checkpoint-polling evaluator (L7), counterpart of ``scripts/eval.py``.

  python -m nerfds_torch.eval --exp_dir /tmp/exp --eval_once --save_images
  python -m nerfds_torch.eval --exp_dir /tmp/exp --device cpu --eval_once

Watches ``<exp_dir>/checkpoints`` (or, with ``--eval_once``, takes its
latest checkpoint once). For each checkpoint it evaluates the annealing
schedules at the checkpoint's step, renders strided subsets of the val and
train items, and writes PSNR, SSIM and MS-SSIM (and LPIPS when the
``lpips`` package imports) to ``<exp_dir>/metrics/<step>.json``;
``--save_images`` writes GT | pred | depth panels to
``<exp_dir>/renders/<step>/<split>/<item>.png``. Test cameras (the
source's camera-paths trajectory; none for the synthetic source) are
rendered with randomly drawn metadata and recorded without metrics.
``--device`` (default ``cuda``) replaces the JAX script's ``--platform``.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Optional, Sequence


def _panel_dir(exp_dir: Path, step: int, split: str) -> Path:
  out = exp_dir / 'renders' / str(step) / split
  out.mkdir(parents=True, exist_ok=True)
  return out


def main(argv: Optional[Sequence[str]] = None):
  parser = argparse.ArgumentParser(
      prog='python -m nerfds_torch.eval',
      description='Evaluates the checkpoints of a training run.')
  parser.add_argument('--exp_dir', required=True)
  parser.add_argument('--data_dir', default='')
  parser.add_argument('--datasource', default='nerfies',
                      choices=['nerfies', 'interp', 'synthetic'])
  parser.add_argument('--image_scale', type=int, default=1)
  parser.add_argument('--chunk', type=int, default=8192)
  parser.add_argument('--num_val_eval', type=int, default=5)
  parser.add_argument('--num_train_eval', type=int, default=5)
  parser.add_argument('--num_test_eval', type=int, default=5,
                      help='test-camera renders per checkpoint; 0 disables '
                           'the split')
  parser.add_argument('--eval_once', action='store_true')
  parser.add_argument('--save_images', action='store_true')
  parser.add_argument('--poll_secs', type=float, default=10.0)
  parser.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                      help="'cuda' (default) or 'cpu' for the plain path")
  args = parser.parse_args(argv)

  import numpy as np
  import torch
  from nerfds_torch import config as config_lib
  from nerfds_torch import datasets as datasets_lib
  from nerfds_torch import viz
  from nerfds_torch.camera import camera_to_rays
  from nerfds_torch.device import resolve_device
  from nerfds_torch.evaluation import metrics as metrics_lib
  from nerfds_torch.evaluation.render import render_image
  from nerfds_torch.trainer import Trainer, eval_extra_params
  from nerfds_torch.training.checkpoints import CheckpointManager
  from nerfds_torch.training.step import TrainState

  device = resolve_device(args.device)
  exp_dir = Path(args.exp_dir)
  model_cfg = config_lib.model_config_from_dict(
      json.loads((exp_dir / 'model_config.json').read_text()))
  train_cfg = config_lib.TrainConfig(
      **json.loads((exp_dir / 'train_config.json').read_text()))
  exp_json = exp_dir / 'experiment.json'
  if exp_json.exists():
    saved = json.loads(exp_json.read_text())
    if args.data_dir:
      saved['data_dir'] = args.data_dir
    exp_cfg = config_lib.ExperimentConfig(**saved)
  else:
    exp_cfg = config_lib.ExperimentConfig(
        data_dir=args.data_dir, image_scale=args.image_scale,
        datasource_type=args.datasource)
  datasource = datasets_lib.from_config(exp_cfg)
  trainer = Trainer.from_experiment(model_cfg, train_cfg, datasource,
                                    exp_dir=None, use_mesh=False,
                                    device=device)
  model = trainer.model
  ckpt = CheckpointManager(exp_dir / 'checkpoints')
  try:
    lpips = metrics_lib.LpipsMetric()
  except Exception:
    lpips = None

  metrics_dir = exp_dir / 'metrics'
  metrics_dir.mkdir(exist_ok=True)
  evaluated = set()
  # The restore template: the model's own parameters' names and devices.
  template = TrainState.create(dict(model.named_parameters()))

  def render(rays, extra_params):
    return render_image(
        model, rays, extra_params, chunk=args.chunk,
        keys=('rgb', 'med_depth'),
        generator=torch.Generator(device=device).manual_seed(0))

  while True:
    step = ckpt.latest_step()
    if step is None or step in evaluated:
      if args.eval_once:
        return None
      time.sleep(args.poll_secs)
      continue
    start = time.time()
    state, _ = ckpt.restore(template, step)
    model.load_state_dict(state.params)
    extra_params = eval_extra_params(model_cfg, train_cfg, state.step)
    report = {}
    for split, ids, count in (
        ('val', datasource.val_ids, args.num_val_eval),
        ('train', datasource.train_ids, args.num_train_eval)):
      if not ids:
        continue
      stride = max(1, len(ids) // max(count, 1))
      per_item = {}
      for item_id in ids[::stride][:count]:
        item = datasource.load_item(item_id)
        out = render({k: item[k] for k in ('origins', 'directions', 'mask',
                                           'metadata')}, extra_params)
        per_item[item_id] = metrics_lib.compute_all(out['rgb'], item['rgb'],
                                                    lpips, device=device)
        if args.save_images:
          viz.save_png(
              _panel_dir(exp_dir, step, split) / f'{item_id}.png',
              np.concatenate([item['rgb'], out['rgb'], viz.colorize_depth(
                  out['med_depth'], datasource.near, datasource.far)], 1))
      keys = next(iter(per_item.values())).keys()
      report[split] = {
          'mean': {k: float(np.mean([m[k] for m in per_item.values()]))
                   for k in keys},
          'per_item': per_item,
      }
    # Test cameras: novel trajectories without ground truth, rendered as
    # background (mask 0) with metadata drawn at random from the train ids.
    test_cameras = ([] if args.num_test_eval <= 0 else
                    datasource.load_test_cameras(count=args.num_test_eval))
    if test_cameras:
      meta_rng = np.random.RandomState(step)
      sampled_meta = {
          k: np.full((1, 1), meta_rng.choice(ids),
                     np.float32 if k == 'time' else np.int32)
          for k, ids in datasource.embeddings_dict.items() if ids}
      per_item = {}
      for cam_idx, camera in enumerate(test_cameras):
        item_id = f'{cam_idx:03d}'
        rays = camera_to_rays(camera)
        rays['mask'] = np.zeros(rays['origins'].shape[:-1] + (1,),
                                np.float32)
        rays['metadata'] = dict(sampled_meta)
        out = render(rays, extra_params)
        per_item[item_id] = {'finite': bool(np.isfinite(out['rgb']).all()),
                             'mean_rgb': float(out['rgb'].mean())}
        if args.save_images:
          viz.save_png(
              _panel_dir(exp_dir, step, 'test') / f'{item_id}.png',
              np.concatenate([out['rgb'], viz.colorize_depth(
                  out['med_depth'], datasource.near, datasource.far)], 1))
      report['test'] = {
          'metadata': {k: int(v.flat[0]) for k, v in sampled_meta.items()},
          'per_item': per_item}
    (metrics_dir / f'{step}.json').write_text(json.dumps(report, indent=2))
    print(f'step {step} ({time.time() - start:.1f} s): ' + json.dumps(
        {s: report[s].get('mean', report[s].get('metadata'))
         for s in report}), flush=True)
    evaluated.add(step)
    if args.eval_once:
      return report


if __name__ == '__main__':
  main()
