"""Training CLI (L7), counterpart of ``scripts/train.py``.

  python -m nerfds_torch.train --preset synthetic_smoke --exp_dir /tmp/exp
  python -m nerfds_torch.train --preset nerf_ds --datasource synthetic \\
      --exp_dir /tmp/exp/nerf_ds --max_steps 1000 --device cuda
  python -m nerfds_torch.train --preset nerf_ds --data_dir /data/vrig \\
      --exp_dir /tmp/exp/vrig --batch_size 1024 --max_steps 2000 \\
      --scale_schedules

Configs are the named preset, then a ``--config_json`` file of {model:
{...}, train: {...}} overrides, then ``--set model.x=...``/``train.x=...``
dotted overrides. Writes ``experiment.json`` (and, through the trainer,
``model_config.json``, ``train_config.json``, ``checkpoints/`` and
``summaries/``) into ``--exp_dir``; resumes from its latest checkpoint;
ends with ``eval_psnr`` on up to 10 strided val views, written to
``final_metrics.json``. ``main`` returns the final state, those metrics
and the ray store it trained on.

One model over N ranks, one process a device (``--device cpu``: gloo;
``cuda``: NCCL, each rank on ``cuda:{LOCAL_RANK}``):

  python -m torch.distributed.run --nproc_per_node N -m nerfds_torch.train \
      --preset nerf_ds --datasource synthetic --exp_dir /tmp/exp/dp

The global batch is ``--batch_size``, split over the ranks; rank 0 alone
prints and writes ``experiment.json``, ``final_metrics.json`` and the
trainer's files. ``--no_mesh`` trains on this process's device alone, as
in ``scripts/train.py``. ``--sampling host`` keeps the ray store in host
memory and samples it in a background thread. ``--device`` (default
``cuda``) replaces the JAX script's ``--platform``.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import time
from pathlib import Path
from typing import Optional, Sequence


def parse_value(v: str):
  """Literal-parses an override value; containers become tuples.

  Accepts Python literals (``()``, ``(4,)``, ``None``) as well as JSON
  (``[4]``, ``null``, ``3.5``), so the frozen configs stay hashable."""

  def tuplify(x):
    if isinstance(x, (list, tuple)):
      return tuple(tuplify(e) for e in x)
    return x

  for parse in (ast.literal_eval, json.loads):
    try:
      return tuplify(parse(v))
    except (ValueError, SyntaxError):
      continue
  return v


def apply_overrides(cfg, overrides, prefix):
  updates = {}
  for k, val in overrides.items():
    section, _, field = k.partition('.')
    if section == prefix and field:
      updates[field] = val
  if updates:
    cfg = dataclasses.replace(cfg, **updates)
  return cfg


def preset_configs(preset: str, max_steps: int, scale_schedules: bool):
  """(model config, train config, datasource type) of a named preset."""
  from nerfds_torch import config as config_lib
  base_train_cfg = config_lib.nerf_ds_train_config(
      max_steps=max_steps, scale_schedules=scale_schedules)
  if preset == 'nerf_ds':
    return config_lib.nerf_ds(), base_train_cfg, 'nerfies'
  if preset == 'nerf_ds_fast':
    return config_lib.nerf_ds_fast(), base_train_cfg, 'nerfies'
  if preset == 'hypernerf':
    return config_lib.hypernerf(), base_train_cfg, 'nerfies'
  if preset == 'vanilla':
    return config_lib.vanilla_nerf(), config_lib.TrainConfig(), 'nerfies'
  # synthetic_smoke: a tiny fast run on the procedural scene.
  model_cfg = dataclasses.replace(
      config_lib.nerf_ds(), num_coarse_samples=16, num_fine_samples=16,
      nerf_trunk_depth=4, nerf_trunk_width=64, se3_trunk_depth=3,
      se3_trunk_width=32, hyper_sheet_depth=2, hyper_sheet_width=16,
      mask_mlp_depth=2, mask_mlp_width=32, nerf_skips=(), se3_skips=(),
      hyper_sheet_skips=(), mask_skips=())
  train_cfg = dataclasses.replace(
      config_lib.nerf_ds_train_config(max_steps=1000, batch_size=512),
      lr_schedule=('exponential', 5e-3, 5e-4, 1000),
      warp_alpha_schedule=('linear', 0, 4, 200),
      sharp_mask_std_schedule=('constant', 0.3),
      norm_input_alpha_schedule=('constant', 4.0),
      x_for_rgb_alpha_schedule=('constant', 4.0))
  return model_cfg, train_cfg, 'synthetic'


def main(argv: Optional[Sequence[str]] = None):
  parser = argparse.ArgumentParser(
      prog='python -m nerfds_torch.train',
      description='Trains a NeRF-DS model with the PyTorch port.')
  parser.add_argument('--preset', default='nerf_ds',
                      choices=['nerf_ds', 'nerf_ds_fast', 'hypernerf',
                               'vanilla', 'synthetic_smoke'])
  parser.add_argument('--data_dir', default='')
  parser.add_argument('--exp_dir', required=True)
  parser.add_argument('--image_scale', type=int, default=1)
  parser.add_argument('--datasource', default=None,
                      choices=[None, 'nerfies', 'interp', 'synthetic'])
  parser.add_argument('--max_steps', type=int, default=None)
  parser.add_argument('--batch_size', type=int, default=None)
  parser.add_argument('--config_json', default=None,
                      help='JSON file with {model:..., train:...} overrides')
  parser.add_argument('--set', action='append', default=[],
                      metavar='model.field=value',
                      help='dotted overrides, e.g. model.num_fine_samples=64')
  parser.add_argument('--scale_schedules', action='store_true',
                      help='compress the 250k-step annealing horizons to '
                           '--max_steps (same trajectory, shorter run)')
  parser.add_argument('--no_mesh', action='store_true',
                      help='train on this process\'s device alone')
  parser.add_argument('--sampling', default='auto',
                      choices=['auto', 'fused', 'host'],
                      help="'fused': on-device minibatch gather; 'host': "
                           'background-thread sampler over a store in host '
                           'memory (stores larger than the device)')
  parser.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                      help="'cuda' (default) or 'cpu' for the plain path")
  args = parser.parse_args(argv)

  import torch.distributed

  from nerfds_torch.parallel import distributed
  joined = distributed.initialize(
      backend='gloo' if args.device == 'cpu' else None)
  try:
    return _train(args)
  finally:
    if joined:
      torch.distributed.destroy_process_group()


def _train(args):
  from nerfds_torch import config as config_lib
  from nerfds_torch import datasets as datasets_lib
  from nerfds_torch.device import resolve_device
  from nerfds_torch.parallel import distributed
  from nerfds_torch.trainer import Trainer

  device = resolve_device(args.device if args.device == 'cpu'
                          else f'cuda:{distributed.local_rank()}')
  main_process = distributed.is_main_process()
  say = print if main_process else (lambda *a, **k: None)
  model_cfg, train_cfg, datasource_type = preset_configs(
      args.preset, args.max_steps or 250000, args.scale_schedules)
  overrides = dict(kv.split('=', 1) for kv in args.set)
  overrides = {k: parse_value(v) for k, v in overrides.items()}
  if args.config_json:
    file_cfg = json.loads(Path(args.config_json).read_text())
    model_cfg = dataclasses.replace(model_cfg, **file_cfg.get('model', {}))
    train_cfg = dataclasses.replace(train_cfg, **file_cfg.get('train', {}))
  model_cfg = apply_overrides(model_cfg, overrides, 'model')
  train_cfg = apply_overrides(train_cfg, overrides, 'train')
  if args.max_steps:
    train_cfg = dataclasses.replace(train_cfg, max_steps=args.max_steps)
  if args.batch_size:
    train_cfg = dataclasses.replace(train_cfg, batch_size=args.batch_size)

  exp_cfg = config_lib.ExperimentConfig(
      data_dir=args.data_dir, image_scale=args.image_scale,
      datasource_type=args.datasource or datasource_type)
  datasource = datasets_lib.from_config(exp_cfg)
  exp_dir = Path(args.exp_dir)
  if main_process:
    exp_dir.mkdir(parents=True, exist_ok=True)
    (exp_dir / 'experiment.json').write_text(config_lib.to_json(exp_cfg))

  say(f'device: {device}, ranks: {distributed.process_count()}', flush=True)
  trainer = Trainer.from_experiment(model_cfg, train_cfg, datasource,
                                    exp_dir=exp_dir,
                                    use_mesh=not args.no_mesh,
                                    sampling=args.sampling, device=device)
  store = trainer.build_store()
  say(f'ray store of rank 0: {store.num_rays} rays, '
      f'{store.nbytes / 2**20:.1f} MiB '
      f'on {"the host" if args.sampling == "host" else device}', flush=True)

  def log_fn(step, data):
    stats = data['stats']
    level = 'fine' if 'fine' in stats else 'coarse'
    t = data['time']
    say(f"step {step} loss={stats[level]['loss/total']:.5f} "
        f"psnr={stats[level]['metric/psnr']:.2f} "
        f"steps/s={t['steps_per_sec']:.2f} rays/s={t['rays_per_sec']:.0f}",
        flush=True)

  start = time.time()
  state = trainer.train(log_fn=log_fn)
  say(f'trained to step {state.step} in {time.time() - start:.1f} s',
      flush=True)
  # Up to 10 strided val views: full-split metrics are the eval CLI's job.
  val_ids = datasource.val_ids or datasource.train_ids[:1]
  stride = max(1, len(val_ids) // 10)
  start = time.time()
  metrics = trainer.eval_psnr(state, item_ids=val_ids[::stride][:10])
  say(f'final val metrics ({time.time() - start:.1f} s):',
      json.dumps(metrics), flush=True)
  if main_process:
    (exp_dir / 'final_metrics.json').write_text(json.dumps(metrics))
  return state, metrics, store


if __name__ == '__main__':
  main()
