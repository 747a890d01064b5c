"""Export a procedural capture in the Nerfies/NeRF-DS directory layout,
counterpart of ``scripts/export_synthetic.py``.

  python -m nerfds_torch.export_synthetic --out_dir /tmp/data/vrig
  python -m nerfds_torch.export_synthetic --out_dir /tmp/vrig --frames 4 \\
      --image_size 32 --gt_samples 48 --camera_path_frames 5 --device cpu

Two scene kinds:
  vrig      - a two-camera rig at 480 px with radial/tangential
              distortion, raw world coordinates with a nonzero scene
              center and scale, masks, points.npy and a novel camera-paths
              trajectory. Train ids are the left camera, val ids the right
              (the vrig protocol).
  mechanism - the normals-mechanism scene: a non-emissive Blinn-Phong
              surface lit by a camera-anchored light, so the specular
              highlight moves against the object's motion.

The ground truth is ray-marched in torch on ``--device`` (default
``cuda``, which raises without a card; ``cpu`` marches on the host): the
same math as the numpy march, which is the reference.
``--device`` replaces the JAX script's ``--platform``.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None):
  p = argparse.ArgumentParser(
      prog='python -m nerfds_torch.export_synthetic',
      description='Writes a procedural capture in the Nerfies layout.')
  p.add_argument('--out_dir', required=True)
  p.add_argument('--kind', default='vrig', choices=['vrig', 'mechanism'])
  p.add_argument('--frames', type=int, default=100)
  p.add_argument('--image_size', type=int, default=480)
  p.add_argument('--gt_samples', type=int, default=192)
  p.add_argument('--specular_exponent', type=float, default=25.0)
  p.add_argument('--camera_path_frames', type=int, default=60)
  p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                 help="device of the ground-truth march ('cuda' default)")
  args = p.parse_args(argv)

  from nerfds_torch.datasets.synthetic import (VrigSyntheticDataSource,
                                               write_nerfies_dataset)

  scene = (dict(specular=True) if args.kind == 'vrig' else
           dict(field_kind='shaded', light_mode='camera'))
  src = VrigSyntheticDataSource(
      num_frames=args.frames, image_size=args.image_size,
      gt_samples=args.gt_samples, white_background=True,
      specular_exponent=args.specular_exponent, gt_backend='torch',
      device=args.device, **scene)

  start = time.time()
  out = write_nerfies_dataset(
      src, args.out_dir,
      scene_center=(0.12, -0.08, 0.25), scene_scale=0.85,
      camera_path_frames=args.camera_path_frames, progress=True)
  seconds = time.time() - start
  n = len(src.train_ids) + len(src.val_ids)
  print(f'exported {n} frames ({args.kind}, {args.image_size}px, '
        f'{src.device}) to {out} in {seconds:.1f}s ({seconds / n:.3f} s a '
        'frame)', flush=True)
  return out, seconds


if __name__ == '__main__':
  main()
