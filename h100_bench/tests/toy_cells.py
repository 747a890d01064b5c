"""The benchmark's cells at toy widths, for tests on the CPU: every width,
sample count and size of the mix cut down, the flags as the cell states
them."""
from __future__ import annotations

import copy

import torch

from h100_bench import harness

TOY_MODEL = dict(
    nerf_trunk_depth=4, nerf_trunk_width=32, nerf_skips=[2],
    nerf_rgb_branch_width=16, mask_mlp_depth=3, mask_mlp_width=16,
    mask_skips=[2], se3_trunk_depth=3, se3_trunk_width=16, se3_skips=[2],
    hyper_sheet_depth=3, hyper_sheet_width=8, hyper_sheet_skips=[2],
    num_coarse_samples=8, num_fine_samples=8)
TOY_MIX = dict(batch_size=64, frames=4, image_size=16, num_embeds=4,
               trace_steps=2, chunk=64, sample_rays=32, trace_frames=1)
CPU = torch.device('cpu')


def bench():
  return harness.load_json(harness.ROOT / 'BENCHMARK.json')


def toy_cell(name: str) -> harness.Cell:
  cell = harness.find_cell(bench(), name)
  cell.config = copy.deepcopy(cell.config)
  cell.config['model'].update(TOY_MODEL)
  cell.traffic = {**cell.traffic, **{k: v for k, v in TOY_MIX.items()
                                     if k in cell.traffic}}
  return cell


def run(name: str, seed: int = 7, trace: bool = False, seconds: float = 0.2,
        **options) -> harness.Outcome:
  import time
  torch.set_num_threads(1)
  cell = toy_cell(name)
  kind = harness.traffic_module(cell.traffic['kind'])
  return kind.run(cell, seed, seconds, trace, CPU, time.perf_counter(),
                  **options)
