"""The readings that a cell's correctness limits are set from, on the card:

  python -m h100_bench.calibrate --workload <cell> --seeds 1,2,3 \
      [--control] [--witness] [--fault <name>] [--seconds 2] \
      [--out readings.jsonl]

For each seed, in one process, a run of the cell as the benchmark makes
it (a window of ``--seconds``), and its compared numbers: the program's
against the reference (the lower reading), with ``--control`` also the
reference in TF32 against the reference (the control's, the upper
reading), and with ``--fault`` the program with that fault of
``faults.py`` planted; with ``--witness`` (training) a look at where
the gaps come from, against the reference in float64 too. One JSON
line a seed goes to ``--out``, and a summary of each number's least and
largest to standard output. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from h100_bench import faults, harness


def look(readings, against: str = 'reference') -> dict:
  """Where the training numbers' gaps come from: each step's loss gap,
  and the three leaves with the widest gaps of the first gradient and of
  the change, with their norms in ``against``."""
  from h100_bench import compare
  ref = readings[against]
  out = {'leaves': len(ref['grad_norms']),
         'dead_leaves': len(ref['grad_norms'])
         - len(compare.live_leaves(ref['grad_norms']))}
  for side in ('program', 'control', 'reference'):
    got = readings.get(side)
    if not got or side == against:
      continue
    out[side] = {'loss_gaps': [abs(p - r) / abs(r) for p, r in
                               zip(got['losses'], ref['losses'])]}
    for key in ('grad_norms', 'step_norms'):
      gaps = {k: abs(got[key][k] - ref[key][k]) / max(ref[key][k], 1e-30)
              for k in ref[key]}
      worst = sorted(gaps, key=gaps.get, reverse=True)[:3]
      out[side][key] = [[k, gaps[k], ref[key][k]] for k in worst]
  return out


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(prog='python -m h100_bench.calibrate')
  parser.add_argument('--workload', required=True)
  parser.add_argument('--seeds', required=True,
                      help='comma-separated whole numbers')
  parser.add_argument('--control', action='store_true')
  parser.add_argument('--witness', action='store_true',
                      help='training: also the reference in float64, and '
                           'every gap against it')
  parser.add_argument('--fault', choices=faults.TRAIN_FAULTS
                      + faults.RENDER_FAULTS)
  parser.add_argument('--seconds', type=float, default=2.0)
  parser.add_argument('--out')
  args = parser.parse_args(argv)

  import torch
  if not torch.cuda.is_available():
    print('calibrate reads the card: no CUDA device', file=sys.stderr)
    return 3
  device = torch.device('cuda', 0)
  cell = harness.find_cell(harness.load_json(harness.ROOT / 'BENCHMARK.json'),
                           args.workload)
  kind = harness.traffic_module(cell.traffic['kind'])
  rows = []
  for seed in (int(s) for s in args.seeds.split(',')):
    planted = (faults.plant(args.fault) if args.fault
               else contextlib.nullcontext())
    start = time.perf_counter()
    with planted:
      extra = {'witness': True} if args.witness else {}
      outcome = kind.run(cell, seed, args.seconds, False, device, start,
                         control=args.control, **extra)
    row = {'workload': args.workload, 'seed': seed, 'fault': args.fault,
           'program': {c.name: c.value for c in outcome.checks},
           'control': ({c.name: c.value for c in outcome.control}
                       if outcome.control else None),
           'end_to_end': outcome.end_to_end, 'attempted': outcome.attempted,
           'seconds': time.perf_counter() - start}
    if outcome.readings:
      row['look'] = look(outcome.readings)
      if outcome.readings.get('float64'):
        row['look_float64'] = look(outcome.readings, 'float64')
    rows.append(row)
    print(json.dumps(row), flush=True)
    if args.out:
      with open(args.out, 'a') as f:
        f.write(json.dumps(row) + '\n')
    del outcome
    torch.cuda.empty_cache()
  for part in ('program', 'control'):
    values = [r[part] for r in rows if r[part]]
    for name in (values[0] if values else {}):
      got = [v[name] for v in values]
      print(f'{part} {name}: least {min(got)!r}, largest {max(got)!r} '
            f'over {len(got)} seeds', flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
