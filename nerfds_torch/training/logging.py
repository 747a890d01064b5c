"""Metric logging (L4), counterpart of ``nerfds_tpu/training/logging.py``.

``MetricWriter`` always appends every scalar to ``metrics.jsonl`` (one
record a call, keys flattened with ``/``), and mirrors scalars,
histograms, images and text to TensorBoard when
``torch.utils.tensorboard`` imports, as the JAX package does with
``flax.metrics.tensorboard``.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch


def _numpy(x) -> np.ndarray:
  if isinstance(x, torch.Tensor):
    return x.detach().cpu().numpy()
  return np.asarray(x)


def _flatten_scalars(tree: Any, prefix: str = '') -> Dict[str, float]:
  out = {}
  if isinstance(tree, dict):
    for k, v in tree.items():
      out.update(_flatten_scalars(v, f'{prefix}{k}/'))
    return out
  arr = _numpy(tree)
  if arr.size == 1:
    out[prefix[:-1]] = float(arr)
  return out


class MetricWriter:
  """Scalar/histogram/image/text writer: TensorBoard (optional) and JSONL
  (always)."""

  def __init__(self, log_dir, use_tensorboard: bool = True):
    self._dir = Path(log_dir)
    self._dir.mkdir(parents=True, exist_ok=True)
    self._jsonl = open(self._dir / 'metrics.jsonl', 'a')
    self._tb = None
    if use_tensorboard:
      try:
        from torch.utils.tensorboard import SummaryWriter
        self._tb = SummaryWriter(str(self._dir))
      except Exception:
        self._tb = None

  def write_scalars(self, step: int, scalars: Dict[str, Any]) -> None:
    flat = _flatten_scalars(scalars)
    record = {'step': int(step), 'time': time.time(), **flat}
    self._jsonl.write(json.dumps(record) + '\n')
    self._jsonl.flush()
    if self._tb is not None:
      for k, v in flat.items():
        self._tb.add_scalar(k, v, step)

  def write_histogram(self, step: int, tag: str, values) -> None:
    if self._tb is not None:
      self._tb.add_histogram(tag, _numpy(values), step)

  def write_image(self, step: int, tag: str, image) -> None:
    """image: [H, W, C]."""
    if self._tb is not None:
      self._tb.add_image(tag, _numpy(image), step, dataformats='HWC')

  def write_text(self, step: int, tag: str, text: str) -> None:
    if self._tb is not None:
      self._tb.add_text(tag, text, step)

  def flush(self) -> None:
    self._jsonl.flush()
    if self._tb is not None:
      self._tb.flush()

  def close(self) -> None:
    self._jsonl.close()
    if self._tb is not None:
      self._tb.close()
