"""Offline quantitative metrics (L7), counterpart of
``scripts/metrics_pipeline.py``.

  python -m nerfds_torch.metrics_pipeline \\
      --pred_dir /tmp/exp/renders_24/frames --gt_dir /data/vrig/rgb/1x \\
      --mask_dir /data/vrig/resized_mask/1x --out_csv /tmp/metrics.csv

PSNR, SSIM and MS-SSIM (``evaluation.metrics.compute_all``, on
``--device``, default ``cuda``) of rendered frames against the ground
truth frame of the same name, and, where a
``<name>.png.png`` mask exists (stored with the static part = 1, inverted
at load), the MSE and PSNR over the moving part only, as the NeRF-DS paper
reports. Prints the means as JSON; ``--out_csv`` writes one row a frame
and a ``MEAN`` row. ``--use_lpips`` adds LPIPS where the ``lpips`` package
imports, and says so on stderr where it does not.
"""
from __future__ import annotations

import argparse
import csv
import json
import sys
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from nerfds_torch.device import resolve_device
from nerfds_torch.evaluation import metrics as metrics_lib
from nerfds_torch.image_utils import image_to_float32, load_image as _load


def load_image(path) -> np.ndarray:
  """A PNG as float32 [H, W, C] in [0, 1], at most 3 channels."""
  img = image_to_float32(_load(path))
  if img.ndim == 2:  # gray (the .png.png masks) decodes 2-D
    img = img[..., None]
  return img[..., :3]


def metrics_for_pair(pred, gt, lpips_metric=None, mask=None, device=None):
  out = metrics_lib.compute_all(pred, gt, lpips_metric, device=device)
  if mask is not None and mask.any():
    mask3 = np.repeat(mask[..., :1], 3, axis=-1) > 0.5
    mse = float(np.mean((pred[mask3] - gt[mask3]) ** 2))
    out['masked_mse'] = mse
    out['masked_psnr'] = float(-10.0 * np.log10(max(mse, 1e-12)))
  return out


def evaluate_dir(pred_dir: Path, gt_dir: Path, mask_dir: Path = None,
                 lpips_metric=None, device=None):
  """Frame-matched metrics over two directories of images: one row a
  prediction whose ground truth has its name and shape. The image metrics
  run on ``device`` (``cuda`` unless the caller passes another)."""
  device = resolve_device(device)
  rows = []
  for pred_path in sorted(Path(pred_dir).glob('*.png')):
    gt_path = Path(gt_dir) / pred_path.name
    if not gt_path.exists():
      continue
    pred = load_image(pred_path)
    gt = load_image(gt_path)
    if pred.shape != gt.shape:
      continue
    mask = None
    if mask_dir is not None:
      mask_path = Path(mask_dir) / f'{pred_path.stem}.png.png'
      if mask_path.exists():
        mask = 1.0 - load_image(mask_path)[..., :1]
    row = metrics_for_pair(pred, gt, lpips_metric, mask, device)
    row['frame'] = pred_path.stem
    rows.append(row)
  return rows


def main(argv: Optional[Sequence[str]] = None):
  parser = argparse.ArgumentParser(
      prog='python -m nerfds_torch.metrics_pipeline',
      description='Scores rendered frames against the ground truth.')
  parser.add_argument('--pred_dir', required=True,
                      help='directory of rendered frames (PNG)')
  parser.add_argument('--gt_dir', required=True)
  parser.add_argument('--mask_dir', default=None)
  parser.add_argument('--out_csv', default=None)
  parser.add_argument('--use_lpips', action='store_true')
  parser.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                      help="'cuda' (default) or 'cpu'")
  args = parser.parse_args(argv)

  lpips_metric = None
  if args.use_lpips:
    try:
      lpips_metric = metrics_lib.LpipsMetric()
    except Exception as e:
      print(f'LPIPS unavailable ({e!r}); skipping', file=sys.stderr)

  rows = evaluate_dir(Path(args.pred_dir), Path(args.gt_dir),
                      Path(args.mask_dir) if args.mask_dir else None,
                      lpips_metric, args.device)
  if not rows:
    print('no matched frames', file=sys.stderr)
    sys.exit(1)

  keys = [k for k in rows[0] if k != 'frame']
  means = {k: float(np.mean([r[k] for r in rows])) for k in keys}
  print(json.dumps(means, indent=2))

  if args.out_csv:
    with open(args.out_csv, 'w', newline='') as f:
      writer = csv.DictWriter(f, fieldnames=['frame'] + keys)
      writer.writeheader()
      writer.writerows(rows)
      writer.writerow({'frame': 'MEAN', **means})
    print(f'wrote {args.out_csv}')
  return means


if __name__ == '__main__':
  main()
