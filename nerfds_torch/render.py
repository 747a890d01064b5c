"""Video rendering CLI (L7), counterpart of ``scripts/render.py``.

  python -m nerfds_torch.render --exp_dir /tmp/exp --camera_path val
  python -m nerfds_torch.render --exp_dir /tmp/exp \\
      --camera_path camera-paths/orbit-novel --interval 4 --device cpu

Restores the latest checkpoint of an experiment, evaluates the annealing
schedules at its step, and renders a camera path frame by frame:
``--camera_path train`` or ``val`` takes the split's cameras and item ids
(val is the vrig right-camera protocol), any other value a directory of
the capture holding one camera JSON a frame, rendered with warp id = frame
index (the embedding lookup clamps ids past its table). Writes into
``--out`` (default ``<exp_dir>/renders_<step>``): ``frames/<id>.png`` (the
item id, or the frame's 5-digit index), which ``metrics_pipeline`` matches
to the capture's ``rgb/<scale>x`` ground truth; a 2×3 debug grid a frame
(rgb, depth, predicted normals, |Δx|, predicted mask, acc), the first as
``debug_frame0.png``; ``rgb.mp4`` and ``debug.mp4`` through
``viz.save_video`` (PNG frames where ``imageio`` or its codec is absent);
with ``--save_raw``, every output as ``raw_<i>.npy``. ``--device``
(default ``cuda``) replaces the JAX script's ``--platform``.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None):
  parser = argparse.ArgumentParser(
      prog='python -m nerfds_torch.render',
      description='Renders a camera path with a trained experiment.')
  parser.add_argument('--exp_dir', required=True)
  parser.add_argument('--data_dir', default='')
  parser.add_argument('--datasource', default='nerfies',
                      choices=['nerfies', 'interp', 'synthetic'])
  parser.add_argument('--image_scale', type=int, default=1)
  parser.add_argument('--chunk', type=int, default=8192)
  parser.add_argument('--interval', type=int, default=1,
                      help='render every Nth frame')
  parser.add_argument('--camera_path', default='vrig_camera',
                      help='subdirectory of the capture with one camera '
                           'JSON a frame, or "train"/"val" for the split\'s '
                           'cameras (frames named by item id)')
  parser.add_argument('--out', default=None)
  parser.add_argument('--save_raw', action='store_true')
  parser.add_argument('--fps', type=int, default=15)
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
                                    exp_dir=None, device=device)
  model = trainer.model
  state, step = CheckpointManager(exp_dir / 'checkpoints').restore(
      TrainState.create(dict(model.named_parameters())))
  model.load_state_dict(state.params)
  print(f'restored checkpoint at step {step}', flush=True)

  if args.camera_path in ('train', 'val'):
    ids = (datasource.train_ids if args.camera_path == 'train'
           else datasource.val_ids)[::args.interval]
    frame_names = list(ids)
    cameras = [datasource.load_camera(i) for i in ids]
    warp_ids = [datasource.get_warp_id(i) for i in ids]
    masks = [datasource.load_mask(i) for i in ids]
  else:
    cam_dir = Path(exp_cfg.data_dir) / args.camera_path
    cam_paths = sorted(cam_dir.glob('*.json'))[::args.interval]
    cameras = [datasource.load_camera(p) for p in cam_paths]
    warp_ids = list(range(len(cameras)))
    masks = [None] * len(cameras)
    frame_names = [f'{i:05d}' for i in range(len(cameras))]
  if not cameras:
    raise SystemExit(f'no cameras for --camera_path {args.camera_path!r}')

  # The schedules at the checkpoint's step: a mid-training checkpoint
  # renders with the posenc windows it was trained with.
  extra = eval_extra_params(model_cfg, train_cfg, state.step)
  out_dir = Path(args.out) if args.out else exp_dir / f'renders_{step}'
  frames_dir = out_dir / 'frames'
  frames_dir.mkdir(parents=True, exist_ok=True)

  frames, debug_frames = [], []
  start = time.time()
  for i, (camera, warp_id, mask) in enumerate(zip(cameras, warp_ids, masks)):
    rays = camera_to_rays(camera)
    rays = {'origins': rays['origins'], 'directions': rays['directions'],
            'metadata': {'warp': np.asarray([[warp_id]], np.int32)}}
    if mask is not None:
      rays['mask'] = mask
    out = render_image(
        model, rays, extra, chunk=args.chunk,
        generator=torch.Generator(device=device).manual_seed(0))
    if args.save_raw:
      np.save(out_dir / f'raw_{i:05d}.npy', out, allow_pickle=True)
    # save_png truncates to 8 bits, as the JAX script writes its frames, so
    # the two packages' offline metrics stay comparable.
    viz.save_png(frames_dir / f'{frame_names[i]}.png', out['rgb'])
    pred_mask = out.get('ray_predicted_mask',
                        np.zeros((*out['rgb'].shape[:2], 1), np.float32))
    debug = viz.image_grid([
        out['rgb'],
        viz.colorize_depth(out['med_depth'], datasource.near, datasource.far),
        viz.normals_to_rgb(out['ray_norm']),
        viz.colorize(np.linalg.norm(out['ray_delta_x'], axis=-1)),
        np.repeat(np.clip(pred_mask, 0, 1), 3, -1),
        np.repeat(np.clip(out['acc'], 0, 1)[..., None], 3, -1),
    ], cols=3)
    frames.append(out['rgb'])
    debug_frames.append(debug)
    if i == 0:
      viz.save_png(out_dir / 'debug_frame0.png', debug)
    print(f'rendered frame {i + 1}/{len(cameras)}', flush=True)
  print(f'rendered {len(frames)} frames in {time.time() - start:.1f} s',
        flush=True)

  viz.save_video(out_dir / 'rgb.mp4', frames, fps=args.fps)
  viz.save_video(out_dir / 'debug.mp4', debug_frames, fps=args.fps)
  print(f'wrote {out_dir}/rgb.mp4 + debug.mp4 ({len(frames)} frames)')
  return out_dir, frame_names


if __name__ == '__main__':
  main()
