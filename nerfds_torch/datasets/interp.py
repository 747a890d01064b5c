"""Interpolation-benchmark datasource (L2), counterpart of
``nerfds_tpu/datasets/interp.py``: the train/val split is by stride over
time. Every ``interval``-th frame trains, the frames in between validate,
and a validation frame's metadata is the (left, right, progression)
triple that lerps the GLO embeddings (``models/embeddings.py``).
"""
from __future__ import annotations

import json
from typing import Dict

import numpy as np

from nerfds_torch.datasets.nerfies import NerfiesDataSource
from nerfds_torch.gpath import GPath


class InterpDataSource(NerfiesDataSource):
  """Strided interpolation split on top of a Nerfies directory."""

  def __init__(self, data_dir, interval: int = 4, **kwargs):
    # The split comes from the full sorted id list of the base dataset.
    dataset_json = json.loads(
        (GPath(data_dir) / 'dataset.json').read_text())
    all_ids = sorted(str(i) for i in dataset_json.get(
        'ids', dataset_json['train_ids'] + dataset_json['val_ids']))
    if len(all_ids) <= interval:
      raise ValueError(
          f'Not enough frames ({len(all_ids)}) for interval {interval}.')
    train_ids = all_ids[::interval]
    val_ids = [i for i in all_ids if i not in set(train_ids)
               and all_ids.index(i) < (len(all_ids) // interval) * interval]
    super().__init__(data_dir, **kwargs)
    self.train_ids = train_ids
    self.val_ids = val_ids
    self.all_sorted_ids = all_ids
    self.interval = interval
    self._train_index = {i: k for k, i in enumerate(train_ids)}

  def get_warp_id(self, item_id) -> int:
    # Train ids embed by their train position.
    return self._train_index[item_id]

  def get_time_id(self, item_id) -> int:
    return self.all_sorted_ids.index(item_id)

  def get_val_metadata(self, item_id) -> Dict[str, np.ndarray]:
    """The (left, right, progression) triple of a validation frame."""
    pos = self.all_sorted_ids.index(item_id)
    left_pos = (pos // self.interval) * self.interval
    right_pos = left_pos + self.interval
    left = left_pos // self.interval
    right = min(right_pos // self.interval, len(self.train_ids) - 1)
    progression = (pos - left_pos) / self.interval
    triple = np.asarray([[float(left), float(right), progression]],
                        np.float32)
    return {'warp': triple, 'appearance': triple, 'time': triple}

  def get_item_metadata(self, item_id: str):
    if item_id in self._train_index:
      return super().get_item_metadata(item_id)
    meta = self.get_val_metadata(item_id)
    return {k: v[0] for k, v in meta.items()
            if k in super().get_item_metadata(self.train_ids[0])}
