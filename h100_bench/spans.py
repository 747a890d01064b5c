"""What the readers of the program's spans share.

The program marks its phases with ``nerfds_torch.tracing`` spans while a
profiler records; the traced window's spans are its last stretch, read by
:func:`records` after the window. Each train step's spans share the step's
unit, and each render chunk's the chunk's. A program without spans (one
older than them) gives no records, and the readers then give None.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

UNIT_SPAN = {'train': 'nerfds.train.step', 'render': 'nerfds.render.chunk'}


def records() -> Optional[List]:
  """The program's span records of the traced window (each with ``name``,
  ``unit``, ``device_ms`` and ``host_ms``), or None where the program has
  no spans."""
  try:
    from nerfds_torch import tracing
  except ImportError:
    return None
  return tracing.records()


def per_unit(view, kind: str, names: Iterable[str],
             host: bool = False) -> Optional[float]:
  """The mean over the window's units (steps or chunks) of the ms that the
  spans named ``names`` took in each unit: their device intervals summed,
  or with ``host`` their host durations. None off the cell's kind, where
  the window ran nothing on a card, where the records' units are not the
  window's, or where a unit lacks the spans or their times."""
  if view.kind != kind or view.trace.busy_s <= 0:
    return None
  recs = records()
  if not recs:
    return None
  units = [r.unit for r in recs if r.name == UNIT_SPAN[kind]]
  if len(units) != view.units or len(set(units)) != len(units):
    return None
  total = dict.fromkeys(units)
  names = set(names)
  for r in recs:
    if r.name in names and r.unit in total:
      ms = r.host_ms if host else r.device_ms
      if ms is None:
        return None
      total[r.unit] = (total[r.unit] or 0.0) + ms
  if any(v is None for v in total.values()):
    return None
  return sum(total.values()) / len(total)


def overlap_us(a: List[Tuple[float, float]],
               b: List[Tuple[float, float]]) -> float:
  """The length of the intersection of two sets of disjoint intervals,
  each sorted."""
  out, i, j = 0.0, 0, 0
  while i < len(a) and j < len(b):
    lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
    out += max(0.0, hi - lo)
    if a[i][1] < b[j][1]:
      i += 1
    else:
      j += 1
  return out


def idle_within_ms(trace, names: Iterable[str]) -> Optional[float]:
  """The ms of the window in which the device was idle (no kernel, copy
  or memset) while the host was inside a span named ``names``, by the
  spans' ``user_annotation`` events in the profiler's own trace; None
  where the trace has none of them."""
  names = set(names)
  spans = [(s, e, n) for s, e, n, cat in trace.host
           if cat == 'user_annotation' and n in names]
  if not spans:
    return None
  lo, hi = trace.window
  edges = [lo] + [t for interval in trace.busy() for t in interval] + [hi]
  idle = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
  inside = []
  for start, end, _ in sorted(spans):
    start, end = max(start, lo), min(end, hi)
    if end <= start:
      continue
    if inside and start <= inside[-1][1]:
      inside[-1] = (inside[-1][0], max(inside[-1][1], end))
    else:
      inside.append((start, end))
  return overlap_us(idle, inside) / 1e3
