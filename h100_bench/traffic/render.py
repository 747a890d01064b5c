"""Render traffic: whole frames through the program's ``render_image``,
one call a frame as the render CLI (``nerfds_torch.render``) makes it: its
default chunk function and outputs, at the mix's chunk, the frames'
cameras following a seeded orbit of the object. Like every user render,
it takes no density gradient (``make_render_fn``'s default), so K1 does
not run.

Set-up makes the model with the seed's parameters and renders one chunk,
which builds and warms every kernel and the one chunk shape. The window
renders frames until ``--seconds`` have passed; it closes when the frame
in flight has returned its outputs on the host. A traced run profiles
``trace_frames`` frames instead. Afterwards the plain reference renders a
seeded sample of ``sample_rays`` rays of every frame, with the same draws,
and the two are compared.

Mix keys: ``chunk``, ``image_size``, ``num_embeds``, ``near``, ``far``,
``step`` (the training step whose annealing the render uses),
``sample_rays``, ``trace_frames``.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List

from h100_bench import compare, harness, inputs
from h100_bench.reference import model as ref_model
from h100_bench.reference import train as ref_train


def frame_seed(seed: int, index: int) -> int:
  return inputs.derive(seed, 'frame', index)


def frame_rays(index: int, mix: Dict, seed: int, device):
  import torch
  frame = inputs.orbit_frame(index, mix['image_size'], mix['num_embeds'],
                             seed, device)
  return {'origins': frame['origins'], 'directions': frame['directions'],
          'metadata': {'warp': torch.tensor([[frame['warp']]],
                                            dtype=torch.int32,
                                            device=device)}}


def sample_rows(seed: int, index: int, num_rays: int, count: int):
  """A seeded sample of ``count`` distinct rays of frame ``index``: one
  ray drawn from each of ``count`` equal runs of the frame's rays."""
  import torch
  g = torch.Generator().manual_seed(inputs.derive(seed, 'sample', index))
  run = num_rays // count
  return torch.arange(count) * run + torch.randint(0, run, (count,),
                                                   generator=g)


def reference_rows(params, model_cfg: Dict, mix: Dict, scalars, seed: int,
                   index: int, rows, device, tf32: bool = False) -> Dict:
  """The plain reference's outputs at ``rows`` of frame ``index``, with
  the uniforms the program's generator gave those rows: each chunk draws
  its coarse then its importance uniforms for every one of its rays."""
  import torch
  chunk = mix['chunk']
  frame = inputs.orbit_frame(index, mix['image_size'], mix['num_embeds'],
                             seed, device)
  g = torch.Generator(device=device).manual_seed(frame_seed(seed, index))
  ordered, perm = torch.sort(rows.to(device))
  coarse, fine = [], []
  for c in range(int(ordered[-1]) // chunk + 1):
    u_coarse, u_fine = (torch.rand((chunk, n), generator=g, device=device)
                        for n in (model_cfg['num_coarse_samples'],
                                  model_cfg['num_fine_samples']))
    mine = ordered[ordered // chunk == c] - c * chunk
    coarse.append(u_coarse[mine])
    fine.append(u_fine[mine])
  uniforms = iter([torch.cat(coarse), torch.cat(fine)])
  n = ordered.shape[0]
  with torch.no_grad(), ref_model.precision(tf32):
    out = ref_model.render(
        params, model_cfg, frame['origins'][ordered],
        frame['directions'][ordered],
        torch.full((n,), frame['warp'], device=device),
        torch.zeros(n, 1, device=device), scalars,
        lambda shape: next(uniforms), mix['near'], mix['far'],
        with_grad=False, sigma_gradient=False
    )[ref_model.levels(model_cfg)[-1]]
  back = torch.argsort(perm)
  return {k: out[k][back] for k in compare.RENDER_KEYS if k in out}


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool, device,
        t0: float, control: bool = False) -> harness.Outcome:
  """One run; ``control`` also reads the control (the reference in TF32)."""
  import numpy as np
  import torch

  from nerfds_torch import config as config_lib
  from nerfds_torch.evaluation.render import render_image
  from nerfds_torch.models.nerfds import NerfDSModel
  from nerfds_torch.trainer import eval_extra_params

  mix = cell.traffic
  model_cfg, train_cfg = cell.config['model'], cell.config['train']
  ref_model.check_config(model_cfg)
  n_embeds = mix['num_embeds']
  program_cfg = config_lib.model_config_from_dict(model_cfg)
  model = NerfDSModel(program_cfg, num_warp_embeds=n_embeds,
                      num_hyper_embeds=n_embeds, near=mix['near'],
                      far=mix['far'], device=device)
  params = inputs.params(model_cfg, n_embeds, seed, device)
  model.load_state_dict(params)
  extra = eval_extra_params(program_cfg, config_lib.TrainConfig(**train_cfg),
                            mix['step'])
  num_rays = mix['image_size'] ** 2

  def render(index: int):
    return render_image(
        model, frame_rays(index, mix, seed, device), extra,
        generator=torch.Generator(device=device).manual_seed(
            frame_seed(seed, index)),
        chunk=mix['chunk'])

  # Warm-up: one chunk of the first frame's rays.
  warm = frame_rays(0, mix, seed, device)
  render_image(model, {k: (v[:mix['chunk']] if k != 'metadata' else v)
                       for k, v in warm.items()}, extra,
               generator=torch.Generator(device=device).manual_seed(0),
               chunk=mix['chunk'])
  harness.synchronize(torch, device)
  setup_s = time.perf_counter() - t0

  samples: List[Dict] = []

  def keep(index: int, out) -> None:
    rows = sample_rows(seed, index, num_rays, mix['sample_rays'])
    samples.append({k: torch.from_numpy(
        np.ascontiguousarray(out[k][rows.numpy()]))
        for k in compare.RENDER_KEYS if k in out})
    samples[-1]['rows'] = rows

  end_to_end, view = {'setup_s': setup_s}, None
  if trace:
    def body():
      from torch.profiler import record_function
      for index in range(mix['trace_frames']):
        with record_function('h100_bench.unit'):
          out = render(index)
        keep(index, out)

    window = harness.profiled(torch, device, body)
    view = harness.View(
        kind='render', trace=window,
        units=mix['trace_frames'] * math.ceil(num_rays / mix['chunk']),
        rays=mix['trace_frames'] * num_rays, model_cfg=model_cfg,
        trunk_rows=[])
  else:
    start = time.perf_counter()
    while True:
      out = render(len(samples))
      keep(len(samples), out)
      if time.perf_counter() - start >= seconds:
        break
    elapsed = time.perf_counter() - start
    end_to_end['render_rays_per_s'] = len(samples) * num_rays / elapsed
  failed = sum(not bool(torch.isfinite(s['rgb']).all()) for s in samples)
  peak = harness.memory_peak(torch, device)

  del model
  if device.type == 'cuda':
    torch.cuda.empty_cache()
  scalars = dict(ref_train.scalars_at(train_cfg, mix['step']),
                 mask_ratio=1.0, sharp_weights_std=1.0)
  program, reference, lowered = {}, {}, {}
  for index, s in enumerate(samples):
    for tf32, into in ((False, reference), (True, lowered))[:1 + control]:
      got = reference_rows(params, model_cfg, mix, scalars, seed, index,
                           s['rows'], device, tf32=tf32)
      for k, v in got.items():
        into.setdefault(k, []).append(v.cpu())
    for k in reference:
      program.setdefault(k, []).append(s[k])
  program, reference, lowered = ({k: torch.cat(v) for k, v in d.items()}
                                 for d in (program, reference, lowered))
  return harness.Outcome(
      attempted=len(samples), failed=failed, end_to_end=end_to_end,
      checks=compare.render_checks(program, reference, cell.limits),
      memory_peak_bytes=peak, view=view,
      control=(compare.render_checks(lowered, reference, cell.limits)
               if control else None))
