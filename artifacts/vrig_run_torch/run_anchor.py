"""The realistic vrig chain of the port at full width, the counterpart of
the JAX run recorded in ``artifacts/vrig_run/``: export, train, eval,
render and score, each through the port's CLI, on the kernel path of a
card.

  python artifacts/vrig_run_torch/run_anchor.py

1. ``export_synthetic --kind vrig`` with its defaults (100 frames a
   camera, 480x480, 192 samples) into ``data/vrig-torch``, unless a
   capture is already there.
2. ``train --preset nerf_ds --datasource nerfies --max_steps 20000
   --batch_size 1024 --scale_schedules`` at seed 0 with the JAX run's
   model config (``use_white_background=True``) and the kernel path
   (``sigma_gradient_mode=fused``, ``use_pallas_compositing=True``),
   counting the launches of K1f, K1b and K2. The experiment directory is
   this file's directory, as the JAX run's was ``artifacts/vrig_run/``.
   The train CLI resumes from the experiment's latest checkpoint, so a run
   cut short goes on from there when started again on a disk that kept it.
3. ``eval --eval_once --save_images``.
4. ``render --camera_path val --interval 4``: the 25 strided right-camera
   frames that the JAX run's table scored.
5. ``metrics_pipeline`` of those frames against the capture's ground
   truth and masks, written to ``metrics_val.csv``.

Writes ``anchor.json`` (the card's name and power limit, wall times,
steps/s, launches and metrics) and three panels beside the experiment's
files.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
sys.path.insert(0, str(ROOT))

DATA_DIR = ROOT / 'data' / 'vrig-torch'
STEPS, SEED, INTERVAL = 20000, 0, 4
TRAIN_ARGV = [
    '--preset', 'nerf_ds', '--datasource', 'nerfies',
    '--data_dir', os.path.relpath(DATA_DIR, ROOT),
    '--exp_dir', os.path.relpath(HERE, ROOT), '--max_steps', str(STEPS),
    '--batch_size', '1024', '--scale_schedules',
    # The JAX run's model config beside the preset
    # (artifacts/vrig_run/model_config.json), and the kernel path.
    '--set', 'model.use_white_background=True',
    '--set', 'model.sigma_gradient_mode=fused',
    '--set', 'model.use_pallas_compositing=True',
    '--set', f'train.random_seed={SEED}']


def card():
  """The card's name and power limit as nvidia-smi prints them."""
  return subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True,
      timeout=30).stdout.strip()


def timed(main, argv):
  """(result, seconds, launches) of a CLI's ``main(argv)``."""
  import torch
  from nerfds_torch import kernels
  kernels.reset_launch_counts()
  start = time.time()
  result = main(argv)
  torch.cuda.synchronize()
  return result, time.time() - start, dict(kernels.launch_counts)


def main():
  import torch
  from nerfds_torch import export_synthetic

  if not torch.cuda.is_available():
    raise SystemExit('no CUDA device')
  begin = time.time()
  os.chdir(ROOT)
  run = {'card': card(), 'device': torch.cuda.get_device_name(0),
         'torch': torch.__version__, 'cuda': torch.version.cuda,
         'train_argv': TRAIN_ARGV}
  print(f'card: {run["card"]}', flush=True)

  if not (DATA_DIR / 'dataset.json').exists():
    _, run['export_s'], _ = timed(export_synthetic.main, [
        '--out_dir', str(DATA_DIR), '--kind', 'vrig'])

  try:
    chain(run)
  finally:
    run['wall_s'] = time.time() - begin
    (HERE / 'anchor.json').write_text(json.dumps(run, indent=1))


def chain(run):
  """Steps 2-5, recorded into ``run``."""
  import numpy as np
  from nerfds_torch import eval as eval_cli
  from nerfds_torch import metrics_pipeline
  from nerfds_torch import render as render_cli
  from nerfds_torch import train as train_cli
  from nerfds_torch.training.checkpoints import CheckpointManager
  run['start_step'] = (CheckpointManager(HERE / 'checkpoints').latest_step()
                       or 0)
  (state, closing_val, _), run['train_s'], run['launches'] = timed(
      train_cli.main, TRAIN_ARGV)
  steps = int(state.step) - run['start_step']
  run.update(steps=steps, steps_per_s=steps / run['train_s'],
             closing_val=closing_val)
  print(f'trained {steps} steps in {run["train_s"]:.1f} s '
        f'({run["steps_per_s"]:.3f} steps/s); launches {run["launches"]}',
        flush=True)
  launches = run['launches']
  if not (launches['fused_trunk_fwd'] == launches['fused_trunk_bwd']
          == 2 * steps <= launches['composite_fwd']):
    raise SystemExit(f'launches {launches} in {steps} steps: want K1f and '
                     f'K1b 2 a step, K2 at least 2')

  report, run['eval_s'], run['eval_launches'] = timed(eval_cli.main, [
      '--exp_dir', str(HERE), '--eval_once', '--save_images'])
  render_out = HERE / f'renders_{STEPS}'
  (_, names), run['render_s'], run['render_launches'] = timed(
      render_cli.main, ['--exp_dir', str(HERE), '--camera_path', 'val',
                        '--interval', str(INTERVAL), '--out',
                        str(render_out)])
  means, run['metrics_s'], _ = timed(metrics_pipeline.main, [
      '--pred_dir', str(render_out / 'frames'), '--gt_dir',
      str(DATA_DIR / 'rgb' / '1x'), '--mask_dir',
      str(DATA_DIR / 'resized_mask' / '1x'), '--out_csv',
      str(HERE / 'metrics_val.csv')])
  if not all(np.isfinite(v) for v in means.values()):
    raise SystemExit(f'metrics not finite: {means}')
  run.update(frames=len(names), metrics=means,
             eval_val_mean=report['val']['mean'])
  print('ANCHOR ' + json.dumps({'steps': STEPS, 'seed': SEED,
                                'frames': len(names), **means}), flush=True)

  panels = HERE / 'panels'
  panels.mkdir(exist_ok=True)
  step_dir = HERE / 'renders' / str(STEPS)
  for src, dst in (
      (step_dir / 'val' / f'{names[0]}.png', f'eval_val_{names[0]}.png'),
      (step_dir / 'test' / '000.png', 'eval_test_000.png'),
      (render_out / 'debug_frame0.png', 'render_val_debug0.png')):
    shutil.copy2(src, panels / dst)


if __name__ == '__main__':
  main()
