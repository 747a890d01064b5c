"""Training traffic: the program's fused training step
(``make_fused_train_step``) at the mix's batch, gathering every minibatch
on the device from a device-resident ``RayStore``, as ``Trainer`` runs it.

Set-up builds the one object the window drives: the model, the state
(parameters made from the seed, a fresh Adam state, the step counter at
the mix's ``start_step``) and the step over a seeded capture of the mix's
size. It runs the first ``check_steps`` steps through the window's own
call, which also builds and warms every kernel and shape, and keeps what
they produced for the check. The window then runs steps until
``--seconds`` have passed, the last one to its end; a traced run instead
profiles ``trace_steps`` steps. Afterwards the plain reference follows the
first steps from the same parameters and draws, and the two are compared.

Mix keys: ``batch_size``, ``frames`` and ``image_size`` of the capture,
``num_embeds``, ``near``, ``far``, ``start_step``, ``check_steps``,
``trace_steps``.
"""
from __future__ import annotations

import math
import time
from typing import Dict

from h100_bench import compare, harness, inputs
from h100_bench.reference import model as ref_model
from h100_bench.reference import train as ref_train


def step_seed(seed: int, step: int) -> int:
  return inputs.derive(seed, 'step', step)


def readings(losses, first_grads, first_params, new_params, params,
             lr: float) -> Dict:
  """What the check compares of a run of the first steps."""
  return {'losses': losses,
          'grad_norms': compare.leaf_norms(first_grads),
          'step_norms': compare.leaf_norms(
              {k: new_params[k] - params[k] for k in params}),
          'adam': compare.adam_gap(params, first_params, first_grads, lr)}


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool, device,
        t0: float, control: bool = False,
        witness: bool = False) -> harness.Outcome:
  """One run; ``control`` also reads the control (the reference in TF32),
  ``witness`` the reference in float64 (for a look at the gaps)."""
  import torch

  from nerfds_torch import config as config_lib
  from nerfds_torch.datasets.core import RayStore
  from nerfds_torch.models.nerfds import NerfDSModel
  from nerfds_torch.training.step import TrainState, make_fused_train_step

  mix = cell.traffic
  model_cfg = cell.config['model']
  train_cfg = dict(cell.config['train'], batch_size=mix['batch_size'])
  ref_model.check_config(model_cfg)
  ref_train.check_train_config(train_cfg)
  n_embeds, near, far = mix['num_embeds'], mix['near'], mix['far']

  model = NerfDSModel(config_lib.model_config_from_dict(model_cfg),
                      num_warp_embeds=n_embeds, num_hyper_embeds=n_embeds,
                      near=near, far=far, device=device)
  params = inputs.params(model_cfg, n_embeds, seed, device)
  program_shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
  if program_shapes != {k: tuple(v.shape) for k, v in params.items()}:
    raise RuntimeError('the program\'s parameters are not the reference\'s: '
                       f'{sorted(set(program_shapes) ^ set(params))}')
  store = inputs.ray_store(mix['frames'], mix['image_size'], seed, device)
  step_fn = make_fused_train_step(
      model, config_lib.TrainConfig(**train_cfg),
      RayStore.from_dict({**{k: store[k] for k in
                             ('origins', 'directions', 'rgb', 'mask')},
                          'metadata': {'warp': store['warp']}}))
  state = TrainState.create(params)
  state.step = mix['start_step']
  generator = torch.Generator(device=device)

  def step(state):
    generator.manual_seed(step_seed(seed, state.step))
    return step_fn(state, generator)

  # The first steps: set-up's warm-up, and what the check compares.
  losses, first_moments, first_params = [], None, None
  for _ in range(mix['check_steps']):
    state, stats = step(state)
    losses.append(float(stats['fine']['loss/total']
                        + stats['coarse']['loss/total']))
    if first_moments is None:
      first_moments, first_params = state.opt_state.mu, state.params
  checked_params = state.params
  harness.synchronize(torch, device)
  setup_s = time.perf_counter() - t0

  batch = mix['batch_size']
  window_losses = []
  end_to_end, view = {'setup_s': setup_s}, None
  if trace:
    def body():
      nonlocal state
      from torch.profiler import record_function
      for _ in range(mix['trace_steps']):
        with record_function('h100_bench.unit'):
          state, stats = step(state)
        window_losses.append(stats['coarse']['loss/total'])

    window = harness.profiled(torch, device, body)
    levels = ref_model.levels(model_cfg)
    points = [model_cfg['num_coarse_samples'],
              model_cfg['num_coarse_samples'] + model_cfg['num_fine_samples']]
    view = harness.View(
        kind='train', trace=window, units=mix['trace_steps'],
        rays=batch * mix['trace_steps'], model_cfg=model_cfg,
        trunk_rows=[batch * p for p in points[:len(levels)]]
        if ref_model.is_nerf_ds(model_cfg) else [])
  else:
    timer = harness.StepTimer(torch, device)
    timer.mark()
    start = time.perf_counter()
    while True:
      state, stats = step(state)
      timer.mark()
      window_losses.append(stats['coarse']['loss/total'])
      if time.perf_counter() - start >= seconds:
        break
    harness.synchronize(torch, device)
    elapsed = time.perf_counter() - start
    end_to_end['train_rays_per_s'] = batch * len(window_losses) / elapsed
    end_to_end['train_step_ms_p95'] = harness.percentile(
        timer.durations_ms(), 95)
  failed = sum(not math.isfinite(x)
               for x in torch.stack(window_losses).tolist())
  peak = harness.memory_peak(torch, device)

  lr = ref_train.scalars_at(train_cfg, mix['start_step'])['learning_rate']
  program = readings(
      losses, {k: m.double() / (1 - ref_train.ADAM_B1)
               for k, m in first_moments.items()}, first_params,
      checked_params, params, lr)
  del model, state, stats, step_fn, first_moments, first_params
  del checked_params
  if device.type == 'cuda':
    torch.cuda.empty_cache()

  def follow(tf32=False, dtype=torch.float32):
    start = {k: v.to(dtype) for k, v in params.items()}
    out = ref_train.follow(
        start, model_cfg, train_cfg,
        {k: v.to(dtype) if v.is_floating_point() else v
         for k, v in store.items()},
        [step_seed(seed, mix['start_step'] + i)
         for i in range(mix['check_steps'])],
        mix['start_step'], near, far, tf32=tf32)
    return readings(out['losses'], out['grads'], out['first_params'],
                    out['params'], start, lr)

  reference = follow()
  lowered = follow(tf32=True) if control else None
  float64 = follow(dtype=torch.float64) if witness else None
  return harness.Outcome(
      attempted=len(window_losses), failed=failed, end_to_end=end_to_end,
      checks=compare.train_checks(program, reference, cell.limits),
      memory_peak_bytes=peak, view=view,
      control=(compare.train_checks(lowered, reference, cell.limits)
               if control else None),
      readings={'program': program, 'reference': reference,
                'control': lowered, 'float64': float64})
