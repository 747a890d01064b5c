"""Experiment orchestration (L7), counterpart of ``nerfds_tpu/trainer.py``.

Datasource -> ray store on the device -> the fused train step (the
minibatch gathered on the device) -> stats, checkpoints and summaries in
the experiment directory -> held-out evaluation (``eval_psnr``). The store
is built once per ``Trainer`` and kept.

With an ``exp_dir`` the trainer writes ``model_config.json`` and
``train_config.json`` there, restores the latest checkpoint of
``checkpoints/`` when ``train()`` starts, saves one every ``save_every``
steps and at the end, and writes the logged stats to ``summaries/``
(``metrics.jsonl``, and TensorBoard when it imports). Not ported yet, and
raising ``NotImplementedError`` (ROADMAP.md, queue 1): ``use_mesh=True``
(data parallelism) and ``sampling='host'`` (``HostRayIterator``).
"""
from __future__ import annotations

import copy
import dataclasses
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from nerfds_torch import config as config_lib
from nerfds_torch.datasets.core import DataSource, RayStore
from nerfds_torch.evaluation import metrics as metrics_lib
from nerfds_torch.evaluation.render import render_image
from nerfds_torch.models.nerfds import NerfDSModel, default_extra_params
from nerfds_torch.training import checkpoints as ckpt_lib
from nerfds_torch.training.logging import MetricWriter
from nerfds_torch.training.step import (TrainState, build_schedules,
                                        eval_schedules, make_fused_train_step)


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


def _stats_to_host(stats: Dict[str, Any]
                   ) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
  """(scalar stats as floats, the per-sample 'hist/*' arrays as numpy under
  '<level>/<name>')."""
  scalars, hists = {}, {}
  for k, v in stats.items():
    if isinstance(v, dict):
      scalars[k], sub = _stats_to_host(v)
      hists.update({f'{k}/{name}': h for name, h in sub.items()})
    elif k.startswith('hist/'):
      hists[k[5:]] = v.detach().cpu().numpy()
    else:
      scalars[k] = float(v)
  return scalars, hists


def eval_extra_params(model_cfg: config_lib.ModelConfig,
                      train_cfg: config_lib.TrainConfig,
                      step: int) -> Dict[str, float]:
  """The render scalars at ``step``: the annealing schedules evaluated
  there over ``default_extra_params``, so that a checkpoint renders with
  the posenc windows it was trained with."""
  scalars = eval_schedules(build_schedules(train_cfg), step)
  extra = dict(default_extra_params(model_cfg))
  for k in ('nerf_alpha', 'warp_alpha', 'hyper_alpha', 'hyper_sheet_alpha',
            'norm_input_alpha'):
    extra[k] = scalars[k]
  return extra


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
    self.ckpt = self.metrics_writer = None
    if self.exp_dir is not None:
      self.exp_dir = Path(self.exp_dir)
      self.exp_dir.mkdir(parents=True, exist_ok=True)
      (self.exp_dir / 'model_config.json').write_text(
          config_lib.to_json(self.model.config))
      (self.exp_dir / 'train_config.json').write_text(
          config_lib.to_json(self.train_cfg))
      self.ckpt = ckpt_lib.CheckpointManager(self.exp_dir / 'checkpoints')
      self.metrics_writer = MetricWriter(self.exp_dir / 'summaries')
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
    numbers from a generator seeded with (``random_seed``, k), so a run
    resumed from a checkpoint takes the steps an unbroken run would."""
    cfg = self.train_cfg
    num_steps = num_steps if num_steps is not None else cfg.max_steps
    if store is None:
      store = self.build_store()
    if state is None:
      state = self.init_state(cfg.random_seed)
    if self.ckpt is not None:
      state, _ = self.ckpt.restore(state)
    step_fn = make_fused_train_step(self.model, cfg, store)

    generator = torch.Generator(device=self.model.device)
    base_seed = (cfg.random_seed + 17) << 32
    tracker = TimeTracker()
    for step in range(state.step, num_steps):
      tracker.tic('total')
      generator.manual_seed(base_seed + step)
      state, stats = step_fn(state, generator)
      if (step + 1) % cfg.print_every == 0 or step + 1 == num_steps:
        stats_host, hists = _stats_to_host(stats)
        tracker.toc('total')
        if log_fn is not None:
          log_fn(step + 1, {'stats': stats_host, 'time': tracker.summary()})
        if self.metrics_writer is not None:
          self._write_summaries(step + 1, state, stats_host, hists,
                                tracker.summary())
        tracker.reset()
      else:
        tracker.toc('total')
      if self.ckpt is not None and (step + 1) % cfg.save_every == 0:
        self.ckpt.save(step + 1, state)
    if self.ckpt is not None and num_steps % cfg.save_every != 0:
      self.ckpt.save(num_steps, state)
    return state

  def _write_summaries(self, step: int, state: TrainState,
                       stats: Dict[str, Any], hists: Dict[str, np.ndarray],
                       times: Dict[str, float]) -> None:
    """Scalars to JSONL (and TensorBoard), the step's 'hist/*' samples and
    the GLO embedding tables as histograms."""
    writer = self.metrics_writer
    writer.write_scalars(step, {'train': stats, 'time': times})
    for tag, values in hists.items():
      writer.write_histogram(step, tag, values)
    for embed_key in ('warp_embed', 'hyper_embed', 'mask_embed'):
      table = state.params.get(f'{embed_key}.embedding')
      if table is not None:
        writer.write_histogram(step, embed_key.replace('_embed', '_embedding'),
                               table)

  # -- evaluation -----------------------------------------------------------

  def model_with_params(self, params: Dict[str, torch.Tensor]
                        ) -> NerfDSModel:
    """A copy of the trainer's model holding ``params``; the trainer's own
    model keeps its parameters."""
    model = copy.deepcopy(self.model)
    model.load_state_dict(params)
    return model

  def eval_psnr(self, state: TrainState, item_ids=None, chunk: int = 8192,
                masked: bool = False) -> Dict[str, float]:
    """Renders held-out views with ``state``'s parameters and returns the
    mean of the reference's metric set over them.

    The schedules are evaluated at ``state.step``. masked=True adds
    'masked_psnr': PSNR over the foreground (moving-object) pixels only,
    where the NeRF-DS phenomenon lives."""
    if item_ids is None:
      item_ids = self.datasource.val_ids or self.datasource.train_ids[:1]
    model = self.model_with_params(state.params)
    extra = eval_extra_params(model.config, self.train_cfg, state.step)
    results = []
    for item_id in item_ids:
      item = self.datasource.load_item(item_id)
      rays = {k: item[k] for k in ('origins', 'directions', 'mask',
                                   'metadata')}
      out = render_image(
          model, rays, extra, chunk=chunk, keys=('rgb',),
          generator=torch.Generator(device=model.device).manual_seed(0))
      m = metrics_lib.compute_all(out['rgb'], item['rgb'])
      if masked:
        fg = np.asarray(item['mask'])[..., 0] > 0.5
        if fg.any():
          err = (np.asarray(out['rgb']) - item['rgb'])[fg]
          mse = float(np.mean(err ** 2))
          m['masked_psnr'] = -10.0 * float(np.log10(max(mse, 1e-12)))
      results.append(m)
    keys = results[0].keys()
    return {k: float(np.mean([r[k] for r in results if k in r]))
            for k in keys}
