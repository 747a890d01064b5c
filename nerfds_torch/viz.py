"""Visualisation helpers (L5), a copy of ``nerfds_tpu/viz.py`` (numpy
only): the turbo colormap as its polynomial approximation, so colorize
works headless, and ``save_png``, a PNG writer that needs nothing beyond
numpy and zlib.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

# Polynomial approximation of the Turbo colormap (Google AI blog, 2019).
_TURBO_R = np.array([0.13572138, 4.61539260, -42.66032258, 132.13108234,
                     -152.94239396, 59.28637943])
_TURBO_G = np.array([0.09140261, 2.19418839, 4.84296658, -14.18503333,
                     4.27729857, 2.82956604])
_TURBO_B = np.array([0.10667330, 12.64194608, -60.58204836, 110.36276771,
                     -89.90310912, 27.34824973])


def turbo(x: np.ndarray) -> np.ndarray:
  """Turbo colormap: x in [0, 1] -> rgb [..., 3] in [0, 1]."""
  x = np.clip(np.asarray(x, np.float32), 0.0, 1.0)
  powers = np.stack([np.ones_like(x), x, x ** 2, x ** 3, x ** 4, x ** 5],
                    axis=-1)
  r = powers @ _TURBO_R
  g = powers @ _TURBO_G
  b = powers @ _TURBO_B
  return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0)


def colorize(array: np.ndarray, cmin: Optional[float] = None,
             cmax: Optional[float] = None, cmap: str = 'turbo',
             invert: bool = False) -> np.ndarray:
  """Normalise a scalar map and apply a colormap (viz.colorize analog)."""
  array = np.asarray(array, np.float32)
  if cmin is None:
    cmin = float(np.nanmin(array))
  if cmax is None:
    cmax = float(np.nanmax(array))
  scale = max(cmax - cmin, 1e-8)
  x = (array - cmin) / scale
  if invert:
    x = 1.0 - x
  if cmap == 'turbo':
    return turbo(x)
  import matplotlib.cm as cm  # optional path
  return np.asarray(cm.get_cmap(cmap)(np.clip(x, 0, 1)))[..., :3]


def colorize_depth(depth: np.ndarray, near: float, far: float) -> np.ndarray:
  return colorize(depth, cmin=near, cmax=far, invert=True)


def normals_to_rgb(normals: np.ndarray) -> np.ndarray:
  """[-1,1] normal vectors -> display colors."""
  return np.clip(0.5 * (np.asarray(normals) + 1.0), 0.0, 1.0)


def image_grid(images, cols: int) -> np.ndarray:
  """Tile equally-sized [H, W, 3] images into a grid."""
  images = [np.asarray(im) for im in images]
  h, w = images[0].shape[:2]
  rows = (len(images) + cols - 1) // cols
  grid = np.zeros((rows * h, cols * w, 3), images[0].dtype)
  for i, im in enumerate(images):
    r, c = divmod(i, cols)
    grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = im[..., :3]
  return grid


def save_video(path, frames, fps: int = 15):
  """mp4 via imageio (the reference uses mediapy; gated fallback to PNGs)."""
  frames = [np.asarray(np.clip(f, 0, 1) * 255, np.uint8) for f in frames]
  try:
    import imageio.v2 as imageio
    imageio.mimwrite(str(path), frames, fps=fps, codec='libx264', quality=8)
  except Exception:  # pragma: no cover - codec availability varies
    out_dir = Path(str(path) + '.frames')
    out_dir.mkdir(parents=True, exist_ok=True)
    for i, f in enumerate(frames):
      save_png(out_dir / f'{i:05d}.png', f)


def save_png(path, image) -> None:
  """Writes an [H, W, 3] (or [H, W]) image as an 8-bit PNG: floats are
  taken as [0, 1] and clipped, uint8 as they are."""
  img = np.asarray(image)
  if img.dtype != np.uint8:
    img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
  if img.ndim == 2:
    img = img[..., None]
  h, w, c = img.shape
  color_type = {1: 0, 3: 2, 4: 6}[c]
  raw = b''.join(b'\x00' + img[y].tobytes() for y in range(h))

  def chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack('>I', len(data)) + tag + data
            + struct.pack('>I', zlib.crc32(tag + data) & 0xffffffff))

  Path(path).write_bytes(
      b'\x89PNG\r\n\x1a\n'
      + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, color_type, 0, 0, 0))
      + chunk(b'IDAT', zlib.compress(raw)) + chunk(b'IEND', b''))
