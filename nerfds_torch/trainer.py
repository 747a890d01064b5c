"""Experiment orchestration (L7), counterpart of ``nerfds_tpu/trainer.py``.

Datasource -> ray store on the device -> the fused train step (the
minibatch gathered on the device) -> stats on logging steps. The store is
built once per ``Trainer`` and kept. Not ported yet, and raising
``NotImplementedError`` (ROADMAP.md, queue 1): ``use_mesh=True`` (data
parallelism), ``sampling='host'`` (``HostRayIterator``), ``exp_dir``
(checkpoints and the metric writer) and ``eval_psnr``.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch

from nerfds_torch import config as config_lib
from nerfds_torch.datasets.core import DataSource, RayStore
from nerfds_torch.models.nerfds import NerfDSModel
from nerfds_torch.training.step import TrainState, make_fused_train_step


class TimeTracker:
  """Wall-clock meters."""

  def __init__(self):
    self._sums: Dict[str, float] = {}
    self._counts: Dict[str, int] = {}
    self._marks: Dict[str, float] = {}

  def tic(self, *keys):
    now = time.time()
    for k in keys:
      self._marks[k] = now

  def toc(self, *keys):
    now = time.time()
    for k in keys:
      self._sums[k] = self._sums.get(k, 0.0) + now - self._marks.pop(k)
      self._counts[k] = self._counts.get(k, 0) + 1

  def summary(self) -> Dict[str, float]:
    out = {k: self._sums[k] / max(self._counts[k], 1) for k in self._sums}
    if 'total' in out and out['total'] > 0:
      out['steps_per_sec'] = 1.0 / out['total']
    return out

  def reset(self):
    self._sums.clear()
    self._counts.clear()


def _stats_to_host(stats: Dict[str, Any]) -> Dict[str, Any]:
  """Scalar stats as floats; per-sample arrays ('hist/*') left out."""
  out = {}
  for k, v in stats.items():
    if isinstance(v, dict):
      out[k] = _stats_to_host(v)
    elif k.startswith('hist/'):
      continue
    else:
      out[k] = float(v)
  return out


@dataclasses.dataclass
class Trainer:
  """Builds and runs a training experiment on ``model``'s device.

  sampling: 'auto' and 'fused' gather the minibatch on the device inside
  the step; 'host' is not ported yet.
  """
  model: NerfDSModel
  train_cfg: config_lib.TrainConfig
  datasource: DataSource
  exp_dir: Optional[Path] = None
  use_mesh: bool = False
  sampling: str = 'auto'

  def __post_init__(self):
    if self.use_mesh:
      raise NotImplementedError(
          'use_mesh=True: data-parallel training is not ported yet; see '
          'ROADMAP.md, queue 1 item 10')
    if self.sampling == 'auto':
      self.sampling = 'fused'
    if self.sampling != 'fused':
      raise NotImplementedError(
          f'sampling={self.sampling!r}: only the on-device gather is ported '
          '(HostRayIterator waits); see ROADMAP.md, queue 1')
    if self.exp_dir is not None:
      raise NotImplementedError(
          'exp_dir: checkpoints and the metric writer are not ported yet; '
          'see ROADMAP.md, queue 1 item 6')
    self._store: Optional[RayStore] = None

  # -- setup ----------------------------------------------------------------

  @classmethod
  def from_experiment(cls, model_cfg: config_lib.ModelConfig,
                      train_cfg: config_lib.TrainConfig,
                      datasource: DataSource, exp_dir=None,
                      use_mesh: bool = False, sampling: str = 'auto',
                      device=None) -> 'Trainer':
    """The model on ``device`` (``cuda`` unless the caller passes another),
    its embedding counts from the datasource's train items."""
    embeddings = datasource.embeddings_dict
    num_warp = max(embeddings.get('warp', [0])) + 1
    num_appearance = max(embeddings.get('appearance', [0])) + 1
    model = NerfDSModel(
        config=model_cfg, num_warp_embeds=num_warp,
        num_hyper_embeds=num_warp, num_nerf_embeds=num_appearance,
        near=datasource.near, far=datasource.far,
        generator=torch.Generator().manual_seed(train_cfg.random_seed),
        device=device)
    return cls(model=model, train_cfg=train_cfg, datasource=datasource,
               exp_dir=Path(exp_dir) if exp_dir else None,
               use_mesh=use_mesh, sampling=sampling)

  def build_store(self) -> RayStore:
    """The train items' rays on the model's device, built once."""
    if self._store is None:
      self._store = self.datasource.build_ray_store(
          self.datasource.train_ids).to(self.model.device)
    return self._store

  def init_state(self, seed: int = 0) -> TrainState:
    """Fresh parameters, initialised from ``seed``, and zero moments."""
    m = self.model
    fresh = NerfDSModel(
        m.config, num_warp_embeds=m.num_warp_embeds,
        num_hyper_embeds=m.num_hyper_embeds,
        num_nerf_embeds=m.num_nerf_embeds, near=m.near, far=m.far,
        generator=torch.Generator().manual_seed(seed), device=m.device)
    return TrainState.create(dict(fresh.named_parameters()))

  # -- the loop -------------------------------------------------------------

  def train(self, num_steps: Optional[int] = None,
            state: Optional[TrainState] = None,
            log_fn: Optional[Callable[[int, Dict[str, Any]], None]] = None,
            store: Optional[RayStore] = None) -> TrainState:
    """Runs steps up to ``num_steps``; ``log_fn(step, {'stats', 'time'})``
    every ``print_every`` steps and at the last. Step k draws its random
    numbers from a generator seeded with (``random_seed``, k)."""
    cfg = self.train_cfg
    num_steps = num_steps if num_steps is not None else cfg.max_steps
    if store is None:
      store = self.build_store()
    if state is None:
      state = self.init_state(cfg.random_seed)
    step_fn = make_fused_train_step(self.model, cfg, store)

    generator = torch.Generator(device=self.model.device)
    base_seed = (cfg.random_seed + 17) << 32
    tracker = TimeTracker()
    for step in range(state.step, num_steps):
      tracker.tic('total')
      generator.manual_seed(base_seed + step)
      state, stats = step_fn(state, generator)
      if (step + 1) % cfg.print_every == 0 or step + 1 == num_steps:
        stats_host = _stats_to_host(stats)
        tracker.toc('total')
        if log_fn is not None:
          log_fn(step + 1, {'stats': stats_host, 'time': tracker.summary()})
        tracker.reset()
      else:
        tracker.toc('total')
    return state

  def eval_psnr(self, *args, **kwargs):
    raise NotImplementedError(
        'eval_psnr needs evaluation/metrics.py, not ported yet; see '
        'ROADMAP.md, queue 1 item 7')
