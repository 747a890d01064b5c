"""Nerfies/HyperNeRF/NeRF-DS capture directories (L2), counterpart of
``nerfds_tpu/datasets/nerfies.py``:

  data_dir/
    rgb/{scale}x/{item_id}.png
    camera/{item_id}.json
    resized_mask/{scale}x/{item_id}.png.png   (NeRF-DS; doubled extension)
    camera-paths/{trajectory}/*.json          (test cameras)
    points.npy                                (background points)
    scene.json    {center, scale, near, far}
    dataset.json  {train_ids, val_ids}
    metadata.json {item_id: {warp_id, appearance_id, camera_id[, time_id]}}

Masks are inverted at load so the moving part is 1. Cameras are recentred
by the scene center, then rescaled by the scene scale, and scaled by
``1 / image_scale``. Images are decoded by the port's own PNG reader
(``image_utils.decode_png``); paths are local.
"""
from __future__ import annotations

import json
from pathlib import PurePath
from typing import List, Optional, Tuple

import numpy as np

from nerfds_torch.camera import Camera
from nerfds_torch.datasets.core import DataSource
from nerfds_torch.gpath import GPath
from nerfds_torch.image_utils import load_image

# Fixed-point RGB -> gray weights (R, G, B, out of 2^14) of OpenCV's
# cvtColor, for colour masks. Masks are written gray; for a colour mask
# OpenCV's PNG reader, which the JAX loader uses, may differ by one level.
_GRAY_WEIGHTS = np.array([4899, 9617, 1868], np.int64)


def load_scene_info(data_dir) -> Tuple[np.ndarray, float, float, float]:
  scene_json = json.loads((GPath(data_dir) / 'scene.json').read_text())
  return (np.array(scene_json['center']), scene_json['scale'],
          scene_json['near'], scene_json['far'])


def _as_uint8(image: np.ndarray) -> np.ndarray:
  return (image >> 8).astype(np.uint8) if image.dtype == np.uint16 else image


def _load_image(path) -> np.ndarray:
  """An RGB image in [0, 1], float32: gray is repeated, alpha dropped."""
  image = _as_uint8(load_image(path))
  if image.ndim == 2:
    image = image[..., None]
  if image.shape[-1] < 3:
    image = np.repeat(image[..., :1], 3, axis=-1)
  return np.ascontiguousarray(image[..., :3]).astype(np.float32) / 255.0


def _load_grayscale_image(path) -> np.ndarray:
  """A gray image in [0, 1], float32 [H, W]."""
  image = _as_uint8(load_image(path))
  if image.ndim == 3 and image.shape[-1] >= 3:
    image = ((image[..., :3].astype(np.int64) @ _GRAY_WEIGHTS + (1 << 13))
             >> 14).astype(np.uint8)
  elif image.ndim == 3:
    image = image[..., 0]
  return image.astype(np.float32) / 255.0


def load_camera(camera_path, scale_factor: float = 1.0,
                scene_center=None, scene_scale=None) -> Camera:
  """Loads a camera, scales it, recentres it on ``scene_center`` and then
  rescales its position by ``scene_scale``."""
  camera = Camera.from_json(GPath(camera_path))
  if scale_factor != 1.0:
    camera = camera.scale(scale_factor)
  if scene_center is not None:
    camera.position = camera.position - scene_center
  if scene_scale is not None:
    camera.position = camera.position * scene_scale
  return camera


class NerfiesDataSource(DataSource):
  """Casual volumetric capture directories (Nerfies/HyperNeRF/NeRF-DS)."""

  def __init__(self, data_dir, image_scale: int = 1,
               test_camera_trajectory: str = 'orbit-mild', **kwargs):
    self.data_dir = GPath(data_dir)
    dataset_json = json.loads((self.data_dir / 'dataset.json').read_text())
    train_ids = [str(i) for i in dataset_json['train_ids']]
    val_ids = [str(i) for i in dataset_json['val_ids']]
    super().__init__(train_ids=train_ids, val_ids=val_ids, **kwargs)
    self.scene_center, self.scene_scale, self._near, self._far = (
        load_scene_info(self.data_dir))
    self.image_scale = image_scale
    self.test_camera_trajectory = test_camera_trajectory
    self.rgb_dir = self.data_dir / 'rgb' / f'{image_scale}x'
    self.mask_dir = self.data_dir / 'resized_mask' / f'{image_scale}x'
    self.camera_dir = self.data_dir / 'camera'
    metadata_path = self.data_dir / 'metadata.json'
    self.metadata_dict = {}
    if metadata_path.exists():
      self.metadata_dict = json.loads(metadata_path.read_text())

  @property
  def near(self) -> float:
    return self._near

  @property
  def far(self) -> float:
    return self._far

  @property
  def has_masks(self) -> bool:
    return self.mask_dir.exists()

  def load_rgb(self, item_id: str) -> np.ndarray:
    return _load_image(self.rgb_dir / f'{item_id}.png')

  def load_mask(self, item_id: str) -> Optional[np.ndarray]:
    # NeRF-DS convention: doubled '.png.png' extension, inverted polarity
    # (moving part = 1).
    path = self.mask_dir / f'{item_id}.png.png'
    if not path.exists():
      return None
    mask = _load_grayscale_image(path)[:, :, np.newaxis]
    return 1.0 - mask

  def load_camera(self, item_id, scale_factor: float = 1.0) -> Camera:
    """The camera of an item id, or of a camera JSON given as a path."""
    if isinstance(item_id, PurePath):
      camera_path = item_id
    else:
      camera_path = self.camera_dir / f'{item_id}.json'
    return load_camera(camera_path,
                       scale_factor=scale_factor / self.image_scale,
                       scene_center=self.scene_center,
                       scene_scale=self.scene_scale)

  def load_test_cameras(self, count: Optional[int] = None) -> List[Camera]:
    camera_dir = (self.data_dir / 'camera-paths'
                  / self.test_camera_trajectory)
    if not camera_dir.exists():
      return []
    camera_paths = sorted(camera_dir.glob('*.json'))
    if count is not None:
      stride = max(1, len(camera_paths) // count)
      camera_paths = camera_paths[::stride]
    return [self.load_camera(p) for p in camera_paths]

  def load_points(self, shuffle: bool = False) -> Optional[np.ndarray]:
    points_path = self.data_dir / 'points.npy'
    if not points_path.exists():
      return None
    points = np.load(points_path)
    points = ((points - self.scene_center) * self.scene_scale
              ).astype(np.float32)
    if shuffle:
      points = points[self.rng.permutation(len(points))]
    return points

  def get_appearance_id(self, item_id) -> int:
    return self.metadata_dict[item_id]['appearance_id']

  def get_camera_id(self, item_id) -> int:
    return self.metadata_dict[item_id]['camera_id']

  def get_warp_id(self, item_id) -> int:
    return self.metadata_dict[item_id]['warp_id']

  def get_time_id(self, item_id) -> int:
    if 'time_id' in self.metadata_dict[item_id]:
      return self.metadata_dict[item_id]['time_id']
    return self.metadata_dict[item_id]['warp_id']
