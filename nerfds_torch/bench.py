"""Training-step throughput of the full NeRF-DS model, counterpart of the
root ``bench.py``.

Measures rays/s/chip (forward + backward, 64 + 64 samples a ray, the full
``nerf_ds()`` architecture) of the explicit training step
(``training.step.make_train_step``) on one fixed batch, and the speed-up
over the *reference execution pattern*: the same math with 'naive' ∇σ (a
fresh warp at every use) and materialised concat->Dense inputs, on the
same device. Prints ONE JSON line, with ``bench.py``'s keys and
``"path"``:

  python -m nerfds_torch.bench [--quick] [--batch N] [--no-baseline]
      [--path kernel|plain] [--device cuda|cpu]

``--path kernel`` (the default) runs 'fused' ∇σ and kernel compositing,
so the step launches K1f, K1b and K2 twice each (the coarse and fine
levels); ``--path plain`` runs ``nerf_ds()`` as the preset stands ('vmap'
∇σ, plain compositing), op for op what the JAX bench runs. The baseline
runs neither K1 nor K2, whatever the path. A baseline that fails raises:
``--no-baseline`` is the only way to leave it out.

The bench is one process on one card: it refuses to run inside an
initialised process group, where each rank would time the whole batch;
``python -m nerfds_torch.bench_scaling`` measures ranks that share it.

Each measured run also writes one line to standard error: its chains' ms
a step and, on the card, the peak memory allocated.

What a chain measures: ``iters`` dependent steps timed by the host's
clock and ended by one ``torch.cuda.synchronize()``, with no sync inside
the chain. The step itself makes the host wait for the card two or three
times (PERF.md §5 counts them), so a chain is the step as ``Trainer``
runs it, not a fully asynchronous stream of launches. The median of
``chains`` chains rejects a chain that a stall of the host lands in.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nerfds_torch import config as config_lib
from nerfds_torch import kernels
from nerfds_torch.device import resolve_device
from nerfds_torch.models.nerfds import NerfDSModel
from nerfds_torch.parallel import mesh as mesh_lib
from nerfds_torch.training.step import TrainState, make_train_step

METRIC = 'train_rays_per_sec_per_chip_fwd_bwd_128spr'
BASELINE = 'reference op pattern, same framework/hardware'
PATHS = ('kernel', 'plain')
# --path kernel: the trunk kernels (K1f, K1b) for ∇σ and K2 for compositing.
KERNEL_PATH = dict(sigma_gradient_mode='fused', use_pallas_compositing=True)
# The reference execution pattern (bench.py:27-32), plain compositing.
REFERENCE_PATTERN = dict(sigma_gradient_mode='naive', concat_dense_inputs=True)
NUM_EMBEDS = 64


def model_config(naive: bool = False, path: str = 'kernel',
                 overrides: Optional[Dict] = None) -> config_lib.ModelConfig:
  """``nerf_ds()`` as the bench runs it: the reference pattern where
  ``naive``, else the path's flags; then ``overrides``."""
  if path not in PATHS:
    raise ValueError(f'path={path!r}: one of {PATHS}')
  cfg = config_lib.nerf_ds()
  if naive:
    cfg = dataclasses.replace(cfg, **REFERENCE_PATTERN)
  elif path == 'kernel':
    cfg = dataclasses.replace(cfg, **KERNEL_PATH)
  return dataclasses.replace(cfg, **(overrides or {}))


def random_batch(batch_size: int, device) -> Dict:
  """``bench.py``'s batch: ``RandomState(0)``'s draws in its order."""
  rng = np.random.RandomState(0)
  directions = rng.randn(batch_size, 3).astype(np.float32)
  directions /= np.linalg.norm(directions, axis=-1, keepdims=True)
  batch = {
      'origins': rng.randn(batch_size, 3).astype(np.float32) * 0.1,
      'directions': directions,
      'rgb': rng.rand(batch_size, 3).astype(np.float32),
      'metadata': {'warp': rng.randint(0, NUM_EMBEDS, (batch_size, 1)
                                       ).astype(np.int32)},
      'mask': rng.rand(batch_size, 1).astype(np.float32),
  }
  return mesh_lib.tree_map(lambda x: torch.as_tensor(x, device=device), batch)


def build(batch_size: int, naive: bool = False, path: str = 'kernel',
          device=None, overrides: Optional[Dict] = None,
          mesh: Optional[mesh_lib.DataMesh] = None):
  """(state, step_fn, batch) of ``bench.py``'s ``build``: the model of
  :func:`model_config` with 64 warp and hyper embeddings, near 0.2 and far
  2.0, parameters from ``torch.Generator().manual_seed(0)``, and
  ``nerf_ds_train_config(batch_size)``'s explicit step. Under ``mesh``
  the batch is this rank's rows of the global ``batch_size``."""
  device = resolve_device(device)
  model = NerfDSModel(model_config(naive, path, overrides),
                      num_warp_embeds=NUM_EMBEDS,
                      num_hyper_embeds=NUM_EMBEDS, near=0.2, far=2.0,
                      generator=torch.Generator().manual_seed(0),
                      device=device)
  train_cfg = config_lib.nerf_ds_train_config(batch_size=batch_size)
  state = TrainState.create(mesh_lib.broadcast(
      {k: v.detach() for k, v in model.named_parameters()}, mesh))
  batch = random_batch(batch_size, device)
  if mesh is not None:
    batch = mesh_lib.shard_batch(batch, mesh)
  return state, make_train_step(model, train_cfg, mesh), batch


def time_steps(state, step_fn, batch, warmup: int, iters: int,
               chains: int = 5) -> Tuple[float, List[float]]:
  """(the median chain's seconds a step, every chain's, in order) over
  ``chains`` chains of ``iters`` dependent steps after ``warmup`` steps.
  Step i draws from a generator seeded ``i`` (warm-up) or ``100 + c *
  iters + i`` (chain c), as ``bench.py`` folds its key. Raises if the
  last step's loss is not finite."""
  device = batch['origins'].device
  generator = torch.Generator(device=device)

  def step(state, seed):
    generator.manual_seed(seed)
    return step_fn(state, batch, generator)

  def sync():
    if device.type == 'cuda':
      torch.cuda.synchronize(device)

  for i in range(warmup):
    state, stats = step(state, i)
  sync()
  times = []
  for c in range(chains):
    start = time.perf_counter()
    for i in range(iters):
      state, stats = step(state, 100 + c * iters + i)
    sync()
    times.append((time.perf_counter() - start) / iters)
  loss = float(stats['coarse']['loss/total'])
  if not np.isfinite(loss):
    raise FloatingPointError(f'the last step\'s loss is {loss}')
  return sorted(times)[len(times) // 2], times


def measure(batch_size: int, naive: bool, path: str, device, warmup: int,
            iters: int, chains: int, overrides: Optional[Dict] = None,
            mesh: Optional[mesh_lib.DataMesh] = None) -> Dict:
  """One measured run: :func:`build` then :func:`time_steps`. Returns the
  median seconds a step ('sec'), each chain's ('chains'), the steps run,
  the kernel launches they made and, on the card, the peak GiB allocated
  from the build on."""
  device = resolve_device(device)
  cuda = device.type == 'cuda'
  if cuda:
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
  before = dict(kernels.launch_counts)
  state, step_fn, batch = build(batch_size, naive, path, device, overrides,
                                mesh)
  sec, times = time_steps(state, step_fn, batch, warmup, iters, chains)
  return dict(sec=sec, chains=times, steps=warmup + chains * iters,
              launches={k: n - before[k]
                        for k, n in kernels.launch_counts.items()},
              peak_gib=(torch.cuda.max_memory_allocated(device) / 2**30
                        if cuda else None))


def describe(name: str, run: Dict) -> str:
  peak = ('' if run['peak_gib'] is None
          else f', peak {run["peak_gib"]:.2f} GiB allocated')
  return (f'bench: {name}: {run["steps"]} steps, chains of '
          f'{", ".join(f"{1e3 * s:.2f}" for s in run["chains"])} ms a step'
          f'{peak}')


def main(argv: Optional[Sequence[str]] = None):
  """Prints the JSON line; returns it and each run's :func:`measure`
  record ('path' and, unless left out, 'baseline')."""
  parser = argparse.ArgumentParser(prog='python -m nerfds_torch.bench')
  parser.add_argument('--quick', action='store_true')
  parser.add_argument('--batch', type=int, default=2048)
  parser.add_argument('--no-baseline', action='store_true')
  parser.add_argument('--path', default='kernel', choices=PATHS,
                      help="'kernel' (default): 'fused' ∇σ and K2 "
                           "compositing; 'plain': the preset as it stands")
  parser.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                      help="'cuda' (default) or 'cpu' for the plain versions")
  args = parser.parse_args(argv)
  if torch.distributed.is_available() and torch.distributed.is_initialized():
    # Each rank would time the whole batch on its own card; bench_scaling
    # measures ranks that share the batch.
    raise RuntimeError('nerfds_torch.bench runs as one process; '
                       'python -m nerfds_torch.bench_scaling measures ranks')
  device = resolve_device(args.device)
  warmup, iters, chains = (2, 4, 3) if args.quick else (4, 8, 5)

  runs = {'path': measure(args.batch, False, args.path, device, warmup,
                          iters, chains)}
  print(describe(f'{args.path} path', runs['path']), file=sys.stderr,
        flush=True)
  rays_per_sec_per_chip = args.batch / runs['path']['sec']

  vs_baseline = None
  if not args.no_baseline:
    # Reference execution pattern at the same batch size.
    runs['baseline'] = measure(args.batch, True, args.path, device,
                               max(1, warmup // 2), max(4, iters // 2),
                               chains)
    print(describe('baseline', runs['baseline']), file=sys.stderr,
          flush=True)
    ref_rays = args.batch / runs['baseline']['sec']
    vs_baseline = rays_per_sec_per_chip / ref_rays

  result = {
      'metric': METRIC,
      'value': round(rays_per_sec_per_chip, 2),
      # A CPU run never reports under the card's unit.
      'unit': 'rays/s/chip' if device.type == 'cuda' else 'rays/s on the cpu',
      'vs_baseline': round(vs_baseline, 3) if vs_baseline else None,
      'baseline': BASELINE,
      'path': args.path,
  }
  print(json.dumps(result), flush=True)
  return result, runs


if __name__ == '__main__':
  main()
