"""Data layer core (L2), counterpart of ``nerfds_tpu/datasets/core.py``.

* :class:`RayStore`: flattened ray columns (origins, directions, rgb, mask,
  metadata ids), numpy on the host after ``DataSource.build_ray_store``,
  tensors on the device after :meth:`RayStore.to`;
* :func:`sample_batch`: a uniform random minibatch gathered on the
  store's device with a ``torch.Generator`` there, so a training step does
  no per-step host work;
* :class:`DataSource`: the per-item API, and `build_ray_store` over items.

Masks are inverted at load by the concrete sources (moving part = 1) and
metadata is broadcast per pixel, as in the JAX package. Not ported yet
(ROADMAP.md, queue 1): ``HostRayIterator``, the host-side sampler for
stores larger than the device, and the per-process share of
``build_ray_store(process_local=True)``.
"""
from __future__ import annotations

import abc
import concurrent.futures
import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from nerfds_torch.camera import Camera, camera_to_rays


def _tree_map(fn, d: Dict[str, Any]) -> Dict[str, Any]:
  return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
          for k, v in d.items()}


@dataclasses.dataclass
class RayStore:
  """Flattened ray columns, each [N, C]: numpy arrays or tensors."""
  origins: Any
  directions: Any
  rgb: Any
  mask: Any                       # [N, 1]; zeros if the source has no masks
  metadata: Dict[str, Any]        # each [N, 1] (int32) or [N, 3] (interp)

  @property
  def num_rays(self) -> int:
    return self.origins.shape[0]

  @property
  def nbytes(self) -> int:
    def leaves(d):
      for v in d.values():
        yield from leaves(v) if isinstance(v, dict) else (v,)

    return sum(int(x.nbytes) for x in leaves(self.as_dict()))

  def as_dict(self) -> Dict[str, Any]:
    return {
        'origins': self.origins,
        'directions': self.directions,
        'rgb': self.rgb,
        'mask': self.mask,
        'metadata': self.metadata,
    }

  @classmethod
  def from_dict(cls, d: Dict[str, Any]) -> 'RayStore':
    return cls(origins=d['origins'], directions=d['directions'],
               rgb=d['rgb'], mask=d['mask'], metadata=d['metadata'])

  def to(self, device) -> 'RayStore':
    """The store as tensors on ``device`` (integer ids stay integers)."""
    return RayStore.from_dict(_tree_map(
        lambda x: torch.as_tensor(np.ascontiguousarray(x)).to(device),
        self.as_dict()))

  def take(self, idx) -> 'RayStore':
    return RayStore.from_dict(_tree_map(lambda x: x[idx], self.as_dict()))


def sample_batch(store: RayStore, generator: Optional[torch.Generator],
                 batch_size: int) -> Dict[str, Any]:
  """A uniform random ray batch, gathered on the store's device.

  At these scales (millions of rays, batch 512) i.i.d. uniform sampling
  stands in for the reference's epoch permutation."""
  idx = torch.randint(0, store.num_rays, (batch_size,), generator=generator,
                      device=store.origins.device)
  return _tree_map(lambda x: x.index_select(0, idx), store.as_dict())


class DataSource(abc.ABC):
  """Abstract data source: concrete sources load items; this base builds
  ray stores from them."""

  def __init__(self, train_ids: Sequence[str], val_ids: Sequence[str],
               use_appearance_id: bool = False, use_camera_id: bool = False,
               use_warp_id: bool = True, use_time: bool = False,
               random_seed: int = 0, **_):
    self.train_ids = list(train_ids)
    self.val_ids = list(val_ids)
    self.use_appearance_id = use_appearance_id
    self.use_camera_id = use_camera_id
    self.use_warp_id = use_warp_id
    self.use_time = use_time
    self.rng = np.random.RandomState(random_seed)

  @property
  def all_ids(self) -> List[str]:
    return sorted(self.train_ids + self.val_ids)

  # -- per-item API ---------------------------------------------------------

  @abc.abstractmethod
  def load_rgb(self, item_id: str) -> np.ndarray:
    ...

  @abc.abstractmethod
  def load_camera(self, item_id: str) -> Camera:
    ...

  def load_mask(self, item_id: str) -> Optional[np.ndarray]:
    return None

  @property
  @abc.abstractmethod
  def near(self) -> float:
    ...

  @property
  @abc.abstractmethod
  def far(self) -> float:
    ...

  def get_appearance_id(self, item_id) -> int:
    raise NotImplementedError

  def get_camera_id(self, item_id) -> int:
    raise NotImplementedError

  def get_warp_id(self, item_id) -> int:
    raise NotImplementedError

  def get_time_id(self, item_id) -> int:
    raise NotImplementedError

  def load_points(self, shuffle: bool = False) -> Optional[np.ndarray]:
    """Background (static) 3D points for the background loss, if any."""
    return None

  def load_test_cameras(self, count: Optional[int] = None) -> List[Camera]:
    """Novel-trajectory test cameras; sources without a camera-paths
    directory have none."""
    return []

  @property
  def embeddings_dict(self) -> Dict[str, List[int]]:
    """Metadata key -> ids over the train items."""
    out = {}
    if self.use_warp_id:
      out['warp'] = [self.get_warp_id(i) for i in self.train_ids]
    if self.use_appearance_id:
      out['appearance'] = [self.get_appearance_id(i) for i in self.train_ids]
    if self.use_camera_id:
      out['camera'] = [self.get_camera_id(i) for i in self.train_ids]
    if self.use_time:
      out['time'] = [self.get_time_id(i) for i in self.train_ids]
    return out

  def get_item_metadata(self, item_id: str) -> Dict[str, np.ndarray]:
    meta = {}
    if self.use_warp_id:
      meta['warp'] = np.asarray([self.get_warp_id(item_id)], np.int32)
    if self.use_appearance_id:
      meta['appearance'] = np.asarray([self.get_appearance_id(item_id)],
                                      np.int32)
    if self.use_camera_id:
      meta['camera'] = np.asarray([self.get_camera_id(item_id)], np.int32)
    if self.use_time:
      meta['time'] = np.asarray([self.get_time_id(item_id)], np.float32)
    return meta

  # -- bulk building --------------------------------------------------------

  def load_item(self, item_id: str) -> Dict[str, Any]:
    """One frame: image, rays, mask and metadata, image-shaped [H, W, ·]."""
    rgb = self.load_rgb(item_id)
    camera = self.load_camera(item_id)
    rays = camera_to_rays(camera)
    mask = self.load_mask(item_id)
    if mask is None:
      mask = np.zeros((*rgb.shape[:2], 1), np.float32)
    meta = self.get_item_metadata(item_id)
    h, w = rgb.shape[:2]
    metadata = {k: np.broadcast_to(v, (h, w, v.shape[-1]))
                for k, v in meta.items()}
    return {
        'origins': rays['origins'],
        'directions': rays['directions'],
        'rgb': rgb[..., :3].astype(np.float32),
        'mask': mask.astype(np.float32),
        'metadata': metadata,
    }

  def build_ray_store(self, item_ids: Sequence[str],
                      max_threads: Optional[int] = None) -> RayStore:
    """Loads the items in parallel and flattens them to numpy ray columns."""
    with concurrent.futures.ThreadPoolExecutor(max_threads) as ex:
      items = list(ex.map(self.load_item, item_ids))

    def flatten(key, sub=None):
      arrs = [(it[key] if sub is None else it[key][sub]) for it in items]
      return np.concatenate(
          [a.reshape(-1, a.shape[-1]) for a in arrs], axis=0)

    metadata = {k: flatten('metadata', k) for k in items[0]['metadata']}
    return RayStore(
        origins=flatten('origins'),
        directions=flatten('directions'),
        rgb=flatten('rgb'),
        mask=flatten('mask'),
        metadata=metadata,
    )

  def camera_rays_for_item(self, item_id: str) -> Dict[str, Any]:
    """Full-image ray dict for rendering one held-out view."""
    return self.load_item(item_id)
