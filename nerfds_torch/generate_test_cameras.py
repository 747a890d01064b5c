"""Test-camera generator, counterpart of ``scripts/generate_test_cameras.py``.

  python -m nerfds_torch.generate_test_cameras --data_dir /data/bell
  python -m nerfds_torch.generate_test_cameras --data_dir /data/bell \\
      --mode orbit --name orbit-gen --frames 60

Modes:
  split - copy each train/val camera JSON (by dataset.json's ids) into
          ``train_camera/`` and ``vrig_camera/``, where vrig evaluation
          tooling finds them by role;
  orbit - synthesize a smooth orbit ``camera-paths/<name>/NNNNNN.json``
          from the capture's own cameras (target, radius and height fitted
          to the train cameras), for captures that lack a trajectory;
  lerp  - interpolate a trajectory between the val (or train) cameras:
          positions lerped piecewise, each camera aimed at the fitted
          target.
"""
from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from nerfds_torch.datasets.nerfies import NerfiesDataSource
from nerfds_torch.gpath import GPath


def load_ids(data_dir: Path):
  info = json.loads((data_dir / 'dataset.json').read_text())
  return ([str(i) for i in info['train_ids']],
          [str(i) for i in info['val_ids']])


def mode_split(data_dir: Path):
  """Copies the train and val cameras into train_camera/ and vrig_camera/."""
  train_ids, val_ids = load_ids(data_dir)
  for ids, folder in ((train_ids, 'train_camera'), (val_ids, 'vrig_camera')):
    out = data_dir / folder
    out.mkdir(exist_ok=True)
    for item_id in ids:
      shutil.copy(data_dir / 'camera' / f'{item_id}.json',
                  out / f'{item_id}.json')
    print(f'{folder}: {len(ids)} cameras')


def _fit_scene(cameras):
  """Look-at target, orbit radius and height from existing cameras."""
  positions = np.stack([c.position for c in cameras])
  # Rough target: least-squares intersection of the optical axes.
  axes = np.stack([c.optical_axis for c in cameras])
  a_mats = np.eye(3)[None] - axes[:, :, None] * axes[:, None, :]
  target = np.linalg.lstsq(a_mats.sum(0),
                           np.einsum('nij,nj->i', a_mats, positions),
                           rcond=None)[0]
  rel = positions - target
  radius = float(np.median(np.linalg.norm(rel, axis=-1)))
  height = float(np.median(rel[:, 1]))
  return target.astype(np.float32), radius, height


def mode_orbit(data_dir: Path, name: str, frames: int, sweep_deg: float):
  ds = NerfiesDataSource(data_dir, image_scale=1)
  cams = [ds.load_camera(i) for i in ds.train_ids]
  target, radius, height = _fit_scene(cams)
  # The orbit is written in raw coordinates (the loader recentres it).
  center, scale = ds.scene_center, ds.scene_scale
  base = cams[len(cams) // 2]
  horiz = float(np.sqrt(max(radius ** 2 - height ** 2, 1e-6)))
  phase = np.arctan2(base.position[0] - target[0],
                     -(base.position[2] - target[2]))
  out = data_dir / 'camera-paths' / name
  out.mkdir(parents=True, exist_ok=True)
  half = np.radians(sweep_deg) / 2
  for k in range(frames):
    angle = phase + half * np.sin(2 * np.pi * k / frames)
    position = target + np.array([horiz * np.sin(angle), height,
                                  -horiz * np.cos(angle)], np.float32)
    cam = base.look_at(position, target, np.array([0.0, -1.0, 0.0]))
    cam.position = cam.position / scale + center
    cam.save_json(out / f'{k:06d}.json')
  print(f'camera-paths/{name}: {frames} orbit cameras '
        f'(target={np.round(target, 3).tolist()}, radius={radius:.3f})')


def mode_lerp(data_dir: Path, name: str, frames: int):
  ds = NerfiesDataSource(data_dir, image_scale=1)
  key_ids = ds.val_ids or ds.train_ids
  keys = [ds.load_camera(i) for i in key_ids]
  if len(keys) < 2:
    raise SystemExit('lerp mode needs >= 2 keyframe cameras')
  target, _, _ = _fit_scene([ds.load_camera(i) for i in ds.train_ids])
  center, scale = ds.scene_center, ds.scene_scale
  out = data_dir / 'camera-paths' / name
  out.mkdir(parents=True, exist_ok=True)
  positions = np.stack([c.position for c in keys])
  for k in range(frames):
    u = k * (len(keys) - 1) / max(frames - 1, 1)
    i = min(int(u), len(keys) - 2)
    w = u - i
    position = (1 - w) * positions[i] + w * positions[i + 1]
    cam = keys[i].look_at(position.astype(np.float32), target,
                          np.array([0.0, -1.0, 0.0]))
    cam.position = cam.position / scale + center
    cam.save_json(out / f'{k:06d}.json')
  print(f'camera-paths/{name}: {frames} lerp cameras over '
        f'{len(keys)} keyframes')


def main(argv: Optional[Sequence[str]] = None):
  p = argparse.ArgumentParser(
      prog='python -m nerfds_torch.generate_test_cameras',
      description='Writes test cameras for a capture directory.')
  p.add_argument('--data_dir', required=True)
  p.add_argument('--mode', default='split',
                 choices=['split', 'orbit', 'lerp'])
  p.add_argument('--name', default='orbit-gen',
                 help='trajectory name under camera-paths/')
  p.add_argument('--frames', type=int, default=60)
  p.add_argument('--sweep_deg', type=float, default=60.0,
                 help='orbit mode: total angular sweep')
  args = p.parse_args(argv)
  data_dir = GPath(args.data_dir)
  if args.mode == 'split':
    mode_split(data_dir)
  elif args.mode == 'orbit':
    mode_orbit(data_dir, args.name, args.frames, args.sweep_deg)
  else:
    mode_lerp(data_dir, args.name, args.frames)


if __name__ == '__main__':
  main()
