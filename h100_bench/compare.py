"""The numbers that decide ``correct``: what the timed path produced
against what the plain reference works out from the same inputs.

Training (the first steps of the object the window then drives):
  * ``loss``: the relative gap of the first step's loss;
  * ``grad``: the worst leaf's gap between the norms of the first gradient,
    the program's as Adam got it (its first moment after one step over
    1 − b1) and the reference's;
  * ``step``: the median leaf's gap between the norms of the parameters'
    change over the steps;
  * ``adam``: the worst leaf's gap between the program's change in its
    first step and the change that the reference's Adam makes from the
    program's own first gradient (the program's state, read to judge it:
    ``grad`` holds that gradient to the reference's). Adam's first update
    is about ``lr · sign(g)`` whatever the gradient's size, so this reads
    rounding alone where the update is sound, and a wrong moment, learning
    rate or bias correction on any one leaf reads about 1.
  A leaf's gap is measured against the reference's norm of that leaf or
  of the median leaf, whichever is larger. Leaves whose reference gradient
  is under a thousandth of the median leaf's move under Adam by rounding
  alone and are left out of ``step``. The later steps' losses and the
  worst leaf's change follow float32 rounding amplified by Adam's first
  steps, in the reference as much as in the program (PERF.md, PR 17), so
  they are looked at but not compared.

Rendering (a sample of the rays of every frame the window rendered): the
widest gap of rgb, of acc, of the depth and of the predicted-normal map.
"""
from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional

import torch

from h100_bench.harness import Check
from h100_bench.reference import train as ref_train

DEAD_LEAF = 1e-3


def leaf_norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
  return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
          tree.items()}


def nan_max(values: Iterable[float]) -> float:
  """The largest of ``values``, or NaN where any is NaN."""
  values = list(values)
  return float('nan') if any(v != v for v in values) else max(values)


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              keys: Optional[Iterable[str]] = None) -> List[float]:
  keys = list(reference) if keys is None else list(keys)
  median = statistics.median(reference[k] for k in keys)
  return [abs(program[k] - reference[k]) / max(reference[k], median)
          for k in keys]


def nan_median(values: List[float]) -> float:
  return (float('nan') if any(v != v for v in values)
          else statistics.median(values))


def live_leaves(ref_grads: Dict[str, float]) -> List[str]:
  median = statistics.median(ref_grads.values())
  return [k for k, g in ref_grads.items() if g >= DEAD_LEAF * median]


def adam_gap(before: Dict[str, torch.Tensor], after: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], lr: float) -> float:
  """The worst leaf's gap between the change ``before`` → ``after`` of a
  first step and the change that the reference's Adam makes from
  ``grads`` with a fresh state, each against the larger of that leaf's
  and the median leaf's norm of the reference's change."""
  b = {k: v.double() for k, v in before.items()}
  zeros = {k: torch.zeros_like(v) for k, v in b.items()}
  want = ref_train.adam(b, {k: grads[k].double() for k in b}, zeros, zeros,
                        1, lr)[0]
  want_norms = leaf_norms({k: want[k] - b[k] for k in b})
  got_norms = {k: float(torch.linalg.vector_norm(
      after[k].double() - want[k])) for k in b}
  median = statistics.median(want_norms.values())
  return nan_max(got_norms[k] / max(want_norms[k], median, 1e-300)
                 for k in b)


def train_checks(program: Dict, reference: Dict, limits: Dict) -> List[Check]:
  """``program`` and ``reference`` each hold 'losses' (one a step),
  'grad_norms' (leaf -> norm of the first gradient), 'step_norms'
  (leaf -> norm of the change over the steps) and 'adam' (that side's
  :func:`adam_gap`)."""
  loss = abs(program['losses'][0] - reference['losses'][0]) / abs(
      reference['losses'][0])
  grad = nan_max(leaf_gaps(program['grad_norms'], reference['grad_norms']))
  step = nan_median(leaf_gaps(program['step_norms'], reference['step_norms'],
                              live_leaves(reference['grad_norms'])))
  return [Check('loss', loss, limits['loss']),
          Check('grad', grad, limits['grad']),
          Check('step', step, limits['step']),
          Check('adam', program['adam'], limits['adam'])]


RENDER_KEYS = ('rgb', 'acc', 'depth', 'ray_norm')
CHECK_NAMES = {'rgb': 'rgb', 'acc': 'acc', 'depth': 'depth',
               'ray_norm': 'normal'}


def render_checks(program: Dict[str, torch.Tensor],
                  reference: Dict[str, torch.Tensor],
                  limits: Dict) -> List[Check]:
  """The widest absolute gap of each of :data:`RENDER_KEYS` present."""
  out = []
  for key in RENDER_KEYS:
    if key in reference:
      gap = float((program[key].double() - reference[key].double()).abs()
                  .max())
      name = CHECK_NAMES[key]
      out.append(Check(name, gap, limits[name]))
  return out
