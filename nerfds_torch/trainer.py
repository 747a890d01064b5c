"""Experiment orchestration (L7), counterpart of ``nerfds_tpu/trainer.py``.

Datasource -> ray store on the device -> the fused train step (the
minibatch gathered on the device) -> stats, checkpoints and summaries in
the experiment directory -> held-out evaluation (``eval_psnr``). The store
is built once per ``Trainer`` and kept, and so are the background loss's
static points (``load_points(shuffle=True)``), where the config asks for
that loss and the source has them.

With an ``exp_dir`` the trainer writes ``model_config.json`` and
``train_config.json`` there, restores the latest checkpoint of
``checkpoints/`` when ``train()`` starts, saves one every ``save_every``
steps and at the end, and writes the logged stats to ``summaries/``
(``metrics.jsonl``, and TensorBoard when it imports).

With ``use_mesh`` (the default) the trainer is one rank of a data-parallel
job (``parallel.create_mesh``; at one process, a mesh of one rank whose
step is the step without a mesh, bit for bit): each rank loads its share
of the train items, trains on ``batch_size / world`` rays a step, and the
step averages the gradients over the ranks. Rank 0 alone writes the
experiment directory; every rank restores from the same checkpoint.
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
from nerfds_torch import tracing
from nerfds_torch.datasets.core import DataSource, HostRayIterator, RayStore
from nerfds_torch.evaluation import metrics as metrics_lib
from nerfds_torch.evaluation.render import render_image
from nerfds_torch.models.nerfds import NerfDSModel, default_extra_params
from nerfds_torch.parallel import distributed
from nerfds_torch.parallel import mesh as mesh_lib
from nerfds_torch.training import checkpoints as ckpt_lib
from nerfds_torch.training.logging import MetricWriter
from nerfds_torch.training.step import (TrainState, background_batch_size,
                                        build_schedules, eval_schedules,
                                        local_batch_size,
                                        make_drawing_train_step,
                                        make_fused_train_step)


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


def rank_seed(seed: int, rank: int):
  """A numpy seed for ``rank``'s draws: ``seed`` itself on rank 0, so that
  rank 0 draws what one process draws."""
  return seed if rank == 0 else [seed, rank]


@dataclasses.dataclass
class Trainer:
  """Builds and runs a training experiment on ``model``'s device.

  sampling: 'auto' and 'fused' gather the minibatch on the device inside
  the step; 'host' keeps the store in host memory and feeds the step
  batches that a ``HostRayIterator`` puts on the device ahead of use (for
  stores larger than the device). use_mesh: see the module docstring.
  """
  model: NerfDSModel
  train_cfg: config_lib.TrainConfig
  datasource: DataSource
  exp_dir: Optional[Path] = None
  use_mesh: bool = True
  sampling: str = 'auto'

  def __post_init__(self):
    if self.sampling == 'auto':
      self.sampling = 'fused'
    if self.sampling not in ('fused', 'host'):
      raise ValueError(f'sampling={self.sampling!r}: one of auto, fused, '
                       'host')
    self.mesh = (mesh_lib.create_mesh(self.model.device) if self.use_mesh
                 else None)
    self.ckpt = self.metrics_writer = None
    if self.exp_dir is not None:
      self.exp_dir = Path(self.exp_dir)
      if distributed.is_main_process():
        self.exp_dir.mkdir(parents=True, exist_ok=True)
        (self.exp_dir / 'model_config.json').write_text(
            config_lib.to_json(self.model.config))
        (self.exp_dir / 'train_config.json').write_text(
            config_lib.to_json(self.train_cfg))
        self.metrics_writer = MetricWriter(self.exp_dir / 'summaries')
      distributed.barrier()
      self.ckpt = ckpt_lib.CheckpointManager(self.exp_dir / 'checkpoints')
    self._store: Optional[RayStore] = None
    self._background_points: Optional[torch.Tensor] = None

  # -- setup ----------------------------------------------------------------

  @classmethod
  def from_experiment(cls, model_cfg: config_lib.ModelConfig,
                      train_cfg: config_lib.TrainConfig,
                      datasource: DataSource, exp_dir=None,
                      use_mesh: bool = True, sampling: str = 'auto',
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
    """The train items' rays, built once: this process's share of them
    (``process_local=True``), on the model's device (under the mesh,
    trimmed to the rows every rank holds), or in host memory for
    ``sampling='host'``."""
    if self._store is None:
      store = self.datasource.build_ray_store(self.datasource.train_ids,
                                              process_local=True)
      if self.sampling == 'host':
        self._store = store
      elif self.mesh is not None:
        self._store = store.to_mesh(self.mesh)
      else:
        self._store = store.to(self.model.device)
    return self._store

  def background_points(self) -> Optional[torch.Tensor]:
    """The source's static points on the model's device, loaded once when
    ``use_background_loss`` is set; None otherwise or where the source has
    none (training then runs without that loss)."""
    if (self._background_points is None
        and self.train_cfg.use_background_loss):
      pts = self.datasource.load_points(shuffle=True)
      if pts is not None:
        self._background_points = torch.as_tensor(
            np.asarray(pts, np.float32), device=self.model.device)
    return self._background_points

  def init_state(self, seed: int = 0) -> TrainState:
    """Fresh parameters, initialised from ``seed``, and zero moments. Under
    the mesh every rank takes rank 0's parameters (the CPU generator
    already makes them equal)."""
    m = self.model
    fresh = NerfDSModel(
        m.config, num_warp_embeds=m.num_warp_embeds,
        num_hyper_embeds=m.num_hyper_embeds,
        num_nerf_embeds=m.num_nerf_embeds, near=m.near, far=m.far,
        generator=torch.Generator().manual_seed(seed), device=m.device)
    return TrainState.create(mesh_lib.broadcast(
        {k: v.detach() for k, v in fresh.named_parameters()}, self.mesh))

  # -- the loop -------------------------------------------------------------

  def train(self, num_steps: Optional[int] = None,
            state: Optional[TrainState] = None,
            log_fn: Optional[Callable[[int, Dict[str, Any]], None]] = None,
            store: Optional[RayStore] = None) -> TrainState:
    """Runs steps up to ``num_steps``; ``log_fn(step, {'stats', 'time'})``
    every ``print_every`` steps and at the last. Step k draws its random
    numbers from a generator seeded with (``random_seed``, k), so a run
    resumed from a checkpoint takes the steps an unbroken run would.
    Under the mesh, rank r > 0 seeds with r as well, and rank 0 draws what
    one process draws."""
    cfg = self.train_cfg
    num_steps = num_steps if num_steps is not None else cfg.max_steps
    if store is None:
      store = self.build_store()
    if state is None:
      state = self.init_state(cfg.random_seed)
    if self.ckpt is not None:
      state, _ = self.ckpt.restore(state)
    rank = self.mesh.rank if self.mesh is not None else 0
    host_iter = None
    try:
      if self.sampling == 'host':
        host_iter = HostRayIterator(
            store, local_batch_size(cfg, self.mesh),
            seed=rank_seed(cfg.random_seed, rank), device=self.model.device)
        step_fn = self._host_step(host_iter, rank)
      else:
        step_fn = make_fused_train_step(self.model, cfg, store,
                                        self.background_points(), self.mesh)
      return self._run(step_fn, state, num_steps, rank, log_fn)
    finally:
      if host_iter is not None:
        host_iter.close()

  def _host_step(self, host_iter: HostRayIterator, rank: int):
    """step(state, generator) on the iterator's batches, with the
    background points drawn on the host from ``RandomState(random_seed +
    31)``, as the JAX package's host path draws them."""
    cfg = self.train_cfg
    points = None
    if cfg.use_background_loss:
      points = self.datasource.load_points(shuffle=True)
    if points is not None:
      points = np.asarray(points, np.float32)
      n_bg = background_batch_size(cfg, points.shape[0], self.mesh)
      bg_rng = np.random.RandomState(rank_seed(cfg.random_seed + 31, rank))

    def draw(generator: torch.Generator):
      batch = next(host_iter)
      if points is not None:
        idx = bg_rng.randint(0, points.shape[0], n_bg)
        batch['background_points'] = torch.as_tensor(
            points[idx], device=self.model.device)
      return batch

    return make_drawing_train_step(self.model, cfg, draw, self.mesh)

  def _run(self, step_fn, state: TrainState, num_steps: int, rank: int,
           log_fn) -> TrainState:
    """The loop. At each print point the stats come to the host, which
    waits for the card there; the logged rate (``time/steps_per_sec``,
    ``time/rays_per_sec``) is the steps since the previous print point
    over the wall seconds between the two (from the loop's start for the
    first)."""
    cfg = self.train_cfg
    generator = torch.Generator(device=self.model.device)
    base_seed = ((cfg.random_seed + 17) << 32) | (rank << 56)
    since, last = state.step, time.perf_counter()
    for step in range(state.step, num_steps):
      generator.manual_seed(base_seed + step)
      state, stats = step_fn(state, generator)
      if (step + 1) % cfg.print_every == 0 or step + 1 == num_steps:
        with tracing.span('nerfds.trainer.log', unit=step):
          stats_host, hists = _stats_to_host(stats)
          now = time.perf_counter()
          steps_per_sec = (step + 1 - since) / (now - last)
          times = {'steps_per_sec': steps_per_sec,
                   'rays_per_sec': steps_per_sec * cfg.batch_size}
          since, last = step + 1, now
          if log_fn is not None:
            log_fn(step + 1, {'stats': stats_host, 'time': times})
          if self.metrics_writer is not None:
            self._write_summaries(step + 1, state, stats_host, hists, times)
      if self.ckpt is not None and (step + 1) % cfg.save_every == 0:
        with tracing.span('nerfds.trainer.checkpoint', unit=step):
          self._save(step + 1, state)
    if self.ckpt is not None and num_steps % cfg.save_every != 0:
      with tracing.span('nerfds.trainer.checkpoint', unit=num_steps - 1):
        self._save(num_steps, state)
    return state

  def _save(self, step: int, state: TrainState) -> None:
    """Rank 0 writes the checkpoint; every rank waits for it."""
    if distributed.is_main_process():
      self.ckpt.save(step, state)
    distributed.barrier()

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
          model, rays, extra, chunk=chunk, keys=('rgb',), mesh=self.mesh,
          generator=torch.Generator(device=model.device).manual_seed(0))
      m = metrics_lib.compute_all(out['rgb'], item['rgb'],
                                  device=model.device)
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
