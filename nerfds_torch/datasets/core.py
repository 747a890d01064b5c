"""Data layer core (L2), counterpart of ``nerfds_tpu/datasets/core.py``.

* :class:`RayStore`: flattened ray columns (origins, directions, rgb, mask,
  metadata ids), numpy on the host after ``DataSource.build_ray_store``,
  tensors on the device after :meth:`RayStore.to` (or, one rank of a data
  mesh, :meth:`RayStore.to_mesh`);
* :func:`sample_batch`: a uniform random minibatch gathered on the
  store's device with a ``torch.Generator`` there, so a training step does
  no per-step host work;
* :class:`HostRayIterator`: for stores larger than the device, a worker
  thread samples numpy batches in host memory and puts them on the device
  ahead of the step;
* :class:`DataSource`: the per-item API, and `build_ray_store` over items
  (with ``process_local=True``, this process's share of them).

Masks are inverted at load by the concrete sources (moving part = 1) and
metadata is broadcast per pixel, as in the JAX package.
"""
from __future__ import annotations

import abc
import concurrent.futures
import dataclasses
import queue as queue_lib
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from nerfds_torch.camera import Camera, camera_to_rays
from nerfds_torch.parallel import distributed
from nerfds_torch.parallel import mesh as mesh_lib
from nerfds_torch.parallel.mesh import tree_map as _tree_map


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

  def to_mesh(self, mesh: mesh_lib.DataMesh) -> 'RayStore':
    """This process's store on its rank's device, as :meth:`to`, with every
    rank's rows trimmed to the smallest count any rank holds (batches are
    uniform random draws, so the dropped remainder is harmless). Under
    more than one rank this store holds this process's items only
    (``DataSource.build_ray_store(process_local=True)``). Raises
    ValueError where a rank holds no ray."""
    counts = mesh_lib.all_gather_rows(torch.tensor(
        [self.num_rays], dtype=torch.int64, device=mesh.device), mesh)
    counts = counts.tolist()
    if min(counts) == 0:
      raise ValueError(f'rank {counts.index(0)} of {mesh.world_size} holds '
                       f'no ray (rays by rank: {counts})')
    rows = min(counts)
    return RayStore.from_dict(_tree_map(lambda x: x[:rows],
                                        self.as_dict())).to(mesh.device)

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


class HostRayIterator:
  """The host-side sampler, for stores larger than the device: a worker
  thread draws ``np.random.RandomState(seed).randint(0, N, batch_size)``
  (the JAX package's indices), gathers those rows of the numpy ``store``
  and puts them on ``device`` (default: the CPU), up to ``prefetch``
  batches ahead of use.

  On CUDA the rows go through pinned host buffers, copied with
  ``non_blocking`` on a side stream; the consumer's stream waits on the
  copy's event, and each batch is recorded on that stream so that the
  caching allocator does not reuse its memory before the step is done
  with it. A failure in the worker is raised by the next ``next()``.
  ``close()`` stops the worker and joins it.
  """

  def __init__(self, store: RayStore, batch_size: int, seed: int = 0,
               prefetch: int = 3, device=None):
    self._store = store
    self._batch_size = batch_size
    self._rng = np.random.RandomState(seed)
    self._device = torch.device('cpu' if device is None else device)
    self._stream = (torch.cuda.Stream(self._device)
                    if self._device.type == 'cuda' else None)
    self._queue: queue_lib.Queue = queue_lib.Queue(maxsize=prefetch)
    self._stop = threading.Event()
    self._thread = threading.Thread(target=self._worker, daemon=True)
    self._thread.start()

  def _put(self, item) -> None:
    while not self._stop.is_set():
      try:
        self._queue.put(item, timeout=0.5)
        return
      except queue_lib.Full:
        continue

  def _to_device(self, rows):
    if self._stream is None:
      return _tree_map(torch.from_numpy, rows), None
    with torch.cuda.stream(self._stream):
      batch = _tree_map(
          lambda x: torch.from_numpy(x).pin_memory().to(self._device,
                                                        non_blocking=True),
          rows)
      event = torch.cuda.Event()
      event.record(self._stream)
    return batch, event

  def _worker(self):
    try:
      while not self._stop.is_set():
        idx = self._rng.randint(0, self._store.num_rays, self._batch_size)
        rows = _tree_map(lambda x: np.ascontiguousarray(x[idx]),
                         self._store.as_dict())
        self._put(self._to_device(rows))
    except Exception as e:  # handed to the consumer, which raises it
      self._put(e)

  def __iter__(self):
    return self

  def __next__(self) -> Dict[str, Any]:
    while True:
      try:
        item = self._queue.get(timeout=0.5)
        break
      except queue_lib.Empty:
        if not self._thread.is_alive():
          raise RuntimeError('HostRayIterator: the sampler is closed')
    if isinstance(item, Exception):
      raise item
    batch, event = item
    if event is not None:
      stream = torch.cuda.current_stream(self._device)
      stream.wait_event(event)
      _tree_map(lambda t: t.record_stream(stream), batch)
    return batch

  def close(self) -> None:
    self._stop.set()
    # Drain, so that a worker blocked on a full queue sees the stop flag,
    # then join it: no thread outlives the iterator.
    while self._thread.is_alive():
      try:
        while True:
          self._queue.get_nowait()
      except queue_lib.Empty:
        pass
      self._thread.join(timeout=0.5)


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
                      max_threads: Optional[int] = None,
                      process_local: bool = False) -> RayStore:
    """Loads the items in parallel and flattens them to numpy ray columns.

    ``process_local=True`` under more than one process: this process
    loads only its contiguous share of ``item_ids``
    (``distributed.local_shard_slice``); :meth:`RayStore.to_mesh` places
    it. The rays' global order then depends on the process count, which
    uniform random batches do not see. One process: a no-op."""
    if process_local and distributed.process_count() > 1:
      start, stop = distributed.local_shard_slice(len(item_ids))
      if start == stop:
        raise ValueError(
            f'process {distributed.process_index()} of '
            f'{distributed.process_count()} gets none of the '
            f'{len(item_ids)} items')
      item_ids = item_ids[start:stop]
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
