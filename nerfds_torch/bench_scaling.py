"""Weak-scaling benchmark over ranks, counterpart of
``scripts/bench_scaling.py``.

Measures training-step throughput (the full NeRF-DS architecture, forward
+ backward, 64 + 64 samples a ray) on 1, 2, 4, ... ranks at a CONSTANT
per-rank ray batch, and reports rays/s/chip and the scaling efficiency
against the 1-rank run. The step, batch and timing are
``nerfds_torch.bench``'s (one chain of ``--iters`` steps a count); under
``--path kernel`` every rank runs K1f, K1b and K2 twice a step.

One process a device under ``torch.distributed.run``. For each count n
(``--device_counts``, or the powers of two up to the world size; counts
above the world size are left out), ranks 0..n-1 form a group
(``torch.distributed.new_group``) and step with a ``DataMesh`` over it,
whose one collective a step averages the gradients within the group; the
other ranks wait at a barrier. Only rank 0 prints:

  python -m torch.distributed.run --nproc_per_node 4 \\
      -m nerfds_torch.bench_scaling                      # NCCL, cuda:LOCAL_RANK
  python -m torch.distributed.run --nproc_per_node 2 \\
      -m nerfds_torch.bench_scaling --device cpu --tiny --per_chip_batch 64

``--backend gloo`` with ``--device cuda`` lets ranks share cards (rank r
on ``cuda:(r mod the card count)``; NCCL refuses two ranks on one card):
that runs the program but gives no scaling figure. One process without
torchrun measures one rank. Prints one JSON line a count and a summary
line.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from nerfds_torch import bench
from nerfds_torch.device import resolve_device
from nerfds_torch.parallel import distributed
from nerfds_torch.parallel import mesh as mesh_lib

# --tiny: the JAX script's shrunken model (plumbing, not speed).
TINY = dict(num_coarse_samples=8, num_fine_samples=8, nerf_trunk_depth=2,
            nerf_trunk_width=32, se3_trunk_depth=2, se3_trunk_width=16,
            hyper_sheet_depth=2, hyper_sheet_width=16, mask_mlp_depth=2,
            mask_mlp_width=16, nerf_skips=(), se3_skips=(),
            hyper_sheet_skips=(), mask_skips=())


def rank_device(device_type: str, backend: str) -> torch.device:
  """This rank's device: the CPU, ``cuda:LOCAL_RANK`` under NCCL, or
  ``cuda:(LOCAL_RANK mod the card count)`` under gloo."""
  if device_type == 'cpu':
    return resolve_device('cpu')
  local = distributed.local_rank()
  if backend == 'gloo':
    resolve_device('cuda')
    local %= torch.cuda.device_count()
  device = resolve_device(f'cuda:{local}')
  torch.cuda.set_device(device)
  return device


def main(argv: Optional[Sequence[str]] = None):
  """Rank 0 prints the rows; returns (rows, summary) on rank 0, None on
  the others."""
  parser = argparse.ArgumentParser(prog='python -m nerfds_torch.bench_scaling')
  parser.add_argument('--per_chip_batch', type=int, default=2048)
  parser.add_argument('--tiny', action='store_true',
                      help='tiny model (plumbing validation)')
  parser.add_argument('--warmup', type=int, default=3)
  parser.add_argument('--iters', type=int, default=10)
  parser.add_argument('--device_counts', type=int, nargs='*', default=None)
  parser.add_argument('--path', default='kernel', choices=bench.PATHS)
  parser.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
  parser.add_argument('--backend', default=None, choices=['nccl', 'gloo'],
                      help="default 'nccl' on cuda, 'gloo' on the cpu")
  args = parser.parse_args(argv)
  backend = args.backend or ('gloo' if args.device == 'cpu' else 'nccl')
  if args.device == 'cpu' and backend != 'gloo':
    parser.error('--device cpu takes --backend gloo')
  device = rank_device(args.device, backend)
  joined = distributed.initialize(backend=backend)
  try:
    return _run(args, device)
  finally:
    if joined:
      dist.destroy_process_group()


def _run(args, device):
  world = distributed.process_count()
  rank = distributed.process_index()
  counts = args.device_counts or [1, 2, 4, 8, 16, 32, 64]
  counts = [n for n in counts if n <= world]
  base_per_chip = None
  rows = []
  for n in counts:
    # Every rank takes part in new_group, members or not.
    group = dist.new_group(list(range(n))) if 1 < n else None
    row = None
    if rank < n:
      mesh = mesh_lib.create_mesh(device, group=group) if group else None
      batch_size = args.per_chip_batch * n
      run = bench.measure(batch_size, False, args.path, device, args.warmup,
                          args.iters, 1,
                          overrides=TINY if args.tiny else None, mesh=mesh)
      per_chip = batch_size / run['sec'] / n
      if base_per_chip is None:
        base_per_chip = per_chip
      row = {'devices': n, 'ms_per_step': round(run['sec'] * 1e3, 2),
             'rays_per_sec_per_chip': round(per_chip, 1),
             'scaling_efficiency': round(per_chip / base_per_chip, 4),
             'path': args.path}
    distributed.barrier()
    if rank == 0:
      rows.append(row)
      print(json.dumps(row), flush=True)
  if rank != 0:
    return None
  summary = {
      'metric': 'weak_scaling_efficiency',
      'value': rows[-1]['scaling_efficiency'],
      'unit': (f'x vs 1 device @ {args.per_chip_batch} rays/chip'
               + ('' if device.type == 'cuda' else ' on the cpu')),
      'devices': rows[-1]['devices'],
      'path': args.path,
  }
  print(json.dumps(summary), flush=True)
  return rows, summary


if __name__ == '__main__':
  main()
