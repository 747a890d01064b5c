"""Multi-scene experiment orchestration (L7), counterpart of
``scripts/run_scenes.py``: trains the benchmark scene list one scene after
another through ``python -m nerfds_torch.train``, each in a child process,
tolerating a scene that fails, then gathers each scene's
``final_metrics.json`` into ``<exp_root>/summary.csv``.

The NeRF-DS benchmark set: bell, cup, as, basin, sieve, press, bowl,
plate, 2cup, as ``<data_root>/<scene>_novel_view`` captures in the Nerfies
layout (``python -m nerfds_torch.export_synthetic`` writes one).

  python -m nerfds_torch.run_scenes --data_root /data/nerfds \\
      --exp_root /exp/nerfds --max_steps 250000

A scene whose training fails is one row of the study with empty metrics,
and the next scene runs: ``--device`` and ``--path`` pass to every child,
which refuses a missing card itself. This process makes no CUDA call, so
it holds no CUDA context while the children train.

``--path kernel`` refuses a preset whose ``norm_grad_topk`` it would turn
off (``nerf_ds_fast``): that speed mode is active only under 'vmap' or
'naive' ∇σ, so the run would train another configuration under the
preset's name. ``--path plain`` runs such a preset as it stands.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Optional, Sequence

DEFAULT_SCENES = ['bell', 'cup', 'as', 'basin', 'sieve', 'press', 'bowl',
                  'plate', '2cup']
# --path kernel: 'fused' ∇σ (K1f, K1b) and K2 compositing in every child.
KERNEL_PATH_SETS = ['--set', 'model.sigma_gradient_mode=fused',
                    '--set', 'model.use_pallas_compositing=True']
# The directory that holds this package, first on the children's path.
PACKAGE_ROOT = str(Path(__file__).resolve().parents[1])


def check_preset(preset: str, path: str) -> None:
  """Raises ValueError where ``path`` would turn off the preset's
  ``norm_grad_topk`` (as ``bench_ablate.check_row`` refuses a row)."""
  import dataclasses
  from nerfds_torch.train import preset_configs
  cfg = preset_configs(preset, 1, False)[0]
  if path == 'kernel':
    cfg = dataclasses.replace(cfg, sigma_gradient_mode='fused',
                              use_pallas_compositing=True)
  if cfg.norm_grad_topk and not cfg.norm_grad_topk_active:
    raise ValueError(
        f'--preset {preset}: norm_grad_topk is active only under '
        f"sigma_gradient_mode 'vmap' or 'naive'; --path {path} runs "
        f"'{cfg.sigma_gradient_mode}'")


def main(argv: Optional[Sequence[str]] = None):
  """Returns {scene: its final metrics, or {'error': ...}}."""
  parser = argparse.ArgumentParser(prog='python -m nerfds_torch.run_scenes')
  parser.add_argument('--data_root', required=True,
                      help='root containing <scene>_novel_view dirs')
  parser.add_argument('--exp_root', required=True)
  parser.add_argument('--scenes', nargs='*', default=DEFAULT_SCENES)
  parser.add_argument('--suffix', default='_novel_view')
  parser.add_argument('--preset', default='nerf_ds')
  parser.add_argument('--max_steps', type=int, default=250000)
  parser.add_argument('--batch_size', type=int, default=None)
  parser.add_argument('--path', default='kernel', choices=['kernel', 'plain'])
  parser.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
  parser.add_argument('--extra_args', nargs=argparse.REMAINDER, default=[])
  args = parser.parse_args(argv)
  check_preset(args.preset, args.path)

  env = dict(os.environ, PYTHONPATH=os.pathsep.join(
      p for p in (PACKAGE_ROOT, os.environ.get('PYTHONPATH')) if p))
  results = {}
  for scene in args.scenes:
    data_dir = Path(args.data_root) / f'{scene}{args.suffix}'
    exp_dir = Path(args.exp_root) / scene
    cmd = [sys.executable, '-m', 'nerfds_torch.train',
           '--preset', args.preset,
           '--data_dir', str(data_dir),
           '--exp_dir', str(exp_dir),
           '--max_steps', str(args.max_steps),
           '--device', args.device]
    if args.batch_size:
      cmd += ['--batch_size', str(args.batch_size)]
    if args.path == 'kernel':
      cmd += KERNEL_PATH_SETS
    cmd += args.extra_args
    print(f'=== {scene}: {" ".join(cmd)}', flush=True)
    try:
      subprocess.run(cmd, check=True, env=env)
      metrics_path = exp_dir / 'final_metrics.json'
      if metrics_path.exists():
        results[scene] = json.loads(metrics_path.read_text())
    except subprocess.CalledProcessError as e:
      # A failed scene is its row of the study; the next scene runs.
      print(f'scene {scene} FAILED: {e}', file=sys.stderr, flush=True)
      results[scene] = {'error': str(e)}

  out_csv = Path(args.exp_root) / 'summary.csv'
  out_csv.parent.mkdir(parents=True, exist_ok=True)
  keys = sorted({k for r in results.values() for k in r if k != 'error'})
  with open(out_csv, 'w', newline='') as f:
    writer = csv.writer(f)
    writer.writerow(['scene'] + keys)
    for scene, r in results.items():
      writer.writerow([scene] + [r.get(k, '') for k in keys])
  print(f'wrote {out_csv}')
  return results


if __name__ == '__main__':
  main()
