"""Image utilities (L2), counterpart of ``nerfds_tpu/image_utils.py``, in
numpy only.

The JAX package decodes and resizes with OpenCV. The port needs neither
OpenCV nor Pillow: :func:`decode_png` is its own PNG reader, built on
``zlib`` and numpy, and the only decoder it uses; ``viz.save_png`` is the
only writer. The reader takes 8-bit gray, gray + alpha, RGB and RGBA, and
16-bit samples of the same kinds (depth maps are 16-bit gray), with every
row filter (None, Sub, Up, Average, Paeth). Palette, interlaced and
sub-byte files raise ``ValueError``. Paths are local: a ``gs://`` path
raises ``ValueError`` (``gpath.GPath``).
"""
from __future__ import annotations

import math
import struct
import zlib
from pathlib import Path
from typing import Union

import numpy as np

from nerfds_torch import viz
from nerfds_torch.gpath import GPath

UINT8_MAX = 255
UINT16_MAX = 65535

PathLike = Union[str, Path]

_PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
# Channels of each PNG colour type the reader takes (3, palette, is not).
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def image_to_uint8(image: np.ndarray) -> np.ndarray:
  """Float [0,1] -> uint8 (clipped); uint8 passes through."""
  if image.dtype == np.uint8:
    return image
  if not np.issubdtype(image.dtype, np.floating):
    raise ValueError(f'Input image should be floating: {image.dtype}')
  return (np.clip(image, 0.0, 1.0) * UINT8_MAX).astype(np.uint8)


def image_to_uint16(image: np.ndarray) -> np.ndarray:
  if image.dtype == np.uint16:
    return image
  if not np.issubdtype(image.dtype, np.floating):
    raise ValueError(f'Input image should be floating: {image.dtype}')
  return (np.clip(image, 0.0, 1.0) * UINT16_MAX).astype(np.uint16)


def image_to_float32(image: np.ndarray) -> np.ndarray:
  """Integer images -> float [0,1]; float passes through."""
  if np.issubdtype(image.dtype, np.floating):
    return image.astype(np.float32)
  if image.dtype == np.uint8:
    return image.astype(np.float32) / UINT8_MAX
  if image.dtype == np.uint16:
    return image.astype(np.float32) / UINT16_MAX
  raise ValueError(f'Unsupported dtype {image.dtype}')


def downsample_image(image: np.ndarray, scale: int) -> np.ndarray:
  """Integer-factor area downsample: the mean of each ``scale`` x ``scale``
  block (what OpenCV's INTER_AREA computes at an integer factor), rounded
  to the nearest integer for integer images. Rows and columns past a
  multiple of ``scale`` are dropped."""
  if scale == 1:
    return image
  height, width = image.shape[:2]
  h, w = height // scale, width // scale
  blocks = image[:h * scale, :w * scale].reshape(
      h, scale, w, scale, *image.shape[2:])
  mean = blocks.astype(np.float64).mean(axis=(1, 3))
  if np.issubdtype(image.dtype, np.integer):
    return np.rint(mean).astype(image.dtype)
  return mean.astype(image.dtype)


def _unfilter(data: bytes, height: int, width: int, bpp: int) -> np.ndarray:
  """Undoes the PNG row filters: the filtered scanlines (a filter byte, then
  ``width * bpp`` bytes a row) -> [height, width, bpp] uint8.

  Sub, Average and Paeth depend on the byte to the left and Up, Average
  and Paeth on the byte above, so pixel (y, x) needs (y, x-1), (y-1, x) and
  (y-1, x-1). Every pixel on one anti-diagonal x + y = d depends only on
  the two diagonals before it. The image is held skewed, one diagonal a
  row (``skew[d + 2, y + 1]`` is pixel (y, d - y); zero rows and a zero
  column stand for the bytes outside the image), so the loop runs over the
  height + width - 1 diagonals and each step is a few vector operations on
  slices.
  """
  rows = np.frombuffer(data, np.uint8)
  if rows.size != height * (width * bpp + 1):
    raise ValueError(f'PNG data holds {rows.size} bytes, want '
                     f'{height * (width * bpp + 1)}')
  rows = rows.reshape(height, width * bpp + 1)
  filters = rows[:, 0]
  if filters.max(initial=0) > 4:
    raise ValueError(f'PNG row filter {int(filters.max())} is not 0-4')
  raw = rows[:, 1:].reshape(height, width, bpp)
  if not filters.any():
    return raw.copy()
  num_diag = height + width - 1
  y = np.arange(height)
  x = np.arange(num_diag)[:, None] - y          # [diagonal, y]
  inside = (x >= 0) & (x < width)
  skew_raw = np.zeros((num_diag, height, bpp), np.int32)
  skew_raw[inside] = raw[np.broadcast_to(y, x.shape)[inside], x[inside]]
  inside = inside[..., None].astype(np.int32)
  skew = np.zeros((num_diag + 2, height + 1, bpp), np.int32)
  kinds = [k for k in (1, 2, 3, 4) if (filters == k).any()]
  rows_of = [(filters == k)[:, None] for k in kinds]
  one_kind = len(kinds) == 1 and filters.all()
  for d in range(num_diag):
    a = skew[d + 1, 1:]                         # left
    b = skew[d + 1, :-1]                        # up
    c = skew[d, :-1]                            # up-left
    pred = (_predict(kinds[0], a, b, c) if one_kind else
            np.select(rows_of, [_predict(k, a, b, c) for k in kinds]))
    skew[d + 2, 1:] = ((skew_raw[d] + pred) & 0xff) * inside[d]
  yy, xx = np.meshgrid(y, np.arange(width), indexing='ij')
  return skew[yy + xx + 2, yy + 1].astype(np.uint8)


def _predict(kind: int, a: np.ndarray, b: np.ndarray, c: np.ndarray
             ) -> np.ndarray:
  """The predictor of PNG row filter ``kind`` (1-4) from the bytes to the
  left (a), above (b) and above-left (c)."""
  if kind == 1:
    return a
  if kind == 2:
    return b
  if kind == 3:
    return (a + b) >> 1
  pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
  return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def decode_png(data: bytes) -> np.ndarray:
  """PNG bytes -> [H, W] (one channel) or [H, W, C] array in the file's
  channel order (gray, gray + alpha, RGB or RGBA), uint8 or uint16."""
  if data[:8] != _PNG_SIGNATURE:
    raise ValueError('not a PNG file')
  pos, header, idat = 8, None, []
  while pos + 8 <= len(data):
    length, tag = struct.unpack('>I4s', data[pos:pos + 8])
    body = data[pos + 8:pos + 8 + length]
    if tag == b'IHDR':
      header = struct.unpack('>IIBBBBB', body)
    elif tag == b'IDAT':
      idat.append(body)
    elif tag == b'IEND':
      break
    pos += 12 + length
  if header is None or not idat:
    raise ValueError('PNG file without IHDR or IDAT')
  width, height, depth, color_type, _, _, interlace = header
  if color_type not in _PNG_CHANNELS:
    raise ValueError(f'PNG colour type {color_type} (palette) is not '
                     'supported')
  if depth not in (8, 16):
    raise ValueError(f'PNG bit depth {depth} is not supported')
  if interlace:
    raise ValueError('interlaced PNG files are not supported')
  channels = _PNG_CHANNELS[color_type]
  pixels = _unfilter(zlib.decompress(b''.join(idat)), height, width,
                     channels * depth // 8)
  if depth == 16:
    pixels = pixels.view('>u2').astype(np.uint16)
  image = pixels.reshape(height, width, channels)
  return image[..., 0] if channels == 1 else image


def load_image(path: PathLike) -> np.ndarray:
  """A PNG file as uint8 or uint16: [H, W] gray, else [H, W, C] in the
  file's order (RGB, RGBA)."""
  return decode_png(GPath(path).read_bytes())


def save_image(path: PathLike, image: np.ndarray) -> None:
  viz.save_png(GPath(path), image_to_uint8(image))


def save_depth(path: PathLike, depth: np.ndarray,
               scale: float = 1000.0) -> None:
  """Depth (meters) -> uint16 millimeter PNG."""
  mm = np.clip(depth * scale, 0, UINT16_MAX).astype(np.uint16)
  viz.save_png(GPath(path), mm)


def load_depth(path: PathLike, scale: float = 1000.0) -> np.ndarray:
  mm = load_image(path)
  if mm.ndim == 3:
    mm = mm[..., 0]
  return mm.astype(np.float32) / scale


def checkerboard(h: int, w: int, size: int = 8,
                 low: float = 0.4, high: float = 0.6) -> np.ndarray:
  """Alpha-compositing background checkerboard."""
  yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
  board = (((yy // size) + (xx // size)) % 2).astype(np.float32)
  return low + board * (high - low)


def composite_alpha(rgb: np.ndarray, alpha: np.ndarray,
                    background: np.ndarray = None) -> np.ndarray:
  if background is None:
    background = checkerboard(*rgb.shape[:2])[..., None]
  return rgb * alpha + background * (1.0 - alpha)


def tile_images(images, cols: int = None, pad: int = 0) -> np.ndarray:
  """Tile a list of equally-sized [H, W, C] images into a grid."""
  images = [np.asarray(im) for im in images]
  n = len(images)
  if cols is None:
    cols = int(math.ceil(math.sqrt(n)))
  rows = int(math.ceil(n / cols))
  h, w = images[0].shape[:2]
  c = images[0].shape[2] if images[0].ndim == 3 else 1
  grid = np.zeros((rows * (h + pad), cols * (w + pad), c),
                  images[0].dtype)
  for i, im in enumerate(images):
    if im.ndim == 2:
      im = im[..., None]
    r, q = divmod(i, cols)
    grid[r * (h + pad):r * (h + pad) + h,
         q * (w + pad):q * (w + pad) + w] = im
  return grid
