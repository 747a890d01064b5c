"""Reads a ``torch.profiler`` window of a run: device activity, the host's
waits on the card, each kernel's device time, and the breakdown of where
the device time and the idle gaps went.

The harness marks the traced window with a ``record_function`` named
:data:`WINDOW` and each unit of work in it (a training step, a rendered
frame) with :data:`UNIT`; everything is read from the profiler's Chrome
trace, whose device events share the host's clock.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

WINDOW = 'h100_bench.window'
UNIT = 'h100_bench.unit'
DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATEGORIES = ('cpu_op', 'user_annotation', 'cuda_runtime',
                   'cuda_driver')
# Runtime calls after which the host has waited for the card. A copy to
# the host (``.item()``, ``.cpu()``) is a cudaMemcpyAsync followed by a
# cudaStreamSynchronize, and counts once, by its synchronize.
SYNC_CALLS = ('cudaStreamSynchronize', 'cudaDeviceSynchronize',
              'cudaEventSynchronize', 'cudaMemcpy')

Span = Tuple[float, float, str]   # start, end (µs), name


def _union(spans: List[Span], lo: float, hi: float) -> List[Tuple[float,
                                                                  float]]:
  merged: List[List[float]] = []
  for start, end, _ in sorted(spans):
    start, end = max(start, lo), min(end, hi)
    if end <= start:
      continue
    if merged and start <= merged[-1][1]:
      merged[-1][1] = max(merged[-1][1], end)
    else:
      merged.append([start, end])
  return [(a, b) for a, b in merged]


@dataclasses.dataclass
class Trace:
  """The events of one traced window, in µs on one clock."""
  device: List[Span]
  host: List[Tuple[float, float, str, str]]   # start, end, name, category
  window: Tuple[float, float]
  units: List[Tuple[float, float]]

  @classmethod
  def from_events(cls, events: List[Dict]) -> 'Trace':
    device, host, windows, units = [], [], [], []
    for e in events:
      if e.get('ph') != 'X' or 'dur' not in e:
        continue
      cat = str(e.get('cat', '')).lower()
      start = float(e['ts'])
      span = (start, start + float(e['dur']), str(e.get('name', '')))
      if cat in DEVICE_CATEGORIES:
        device.append(span)
      elif cat in HOST_CATEGORIES:
        host.append((*span, cat))
        if cat == 'user_annotation' and span[2] == WINDOW:
          windows.append(span[:2])
        elif cat == 'user_annotation' and span[2] == UNIT:
          units.append(span[:2])
    if len(windows) != 1:
      raise ValueError(f'{len(windows)} traced windows marked {WINDOW!r}')
    return cls(device=device, host=host, window=windows[0],
               units=sorted(units))

  @classmethod
  def from_profiler(cls, prof) -> 'Trace':
    """Exports ``prof``'s Chrome trace to a temporary file, reads it and
    deletes it."""
    fd, path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
      prof.export_chrome_trace(path)
      with open(path) as f:
        data = json.load(f)
    finally:
      os.remove(path)
    events = data['traceEvents'] if isinstance(data, dict) else data
    return cls.from_events(events)

  # -- readings -----------------------------------------------------------------

  @property
  def window_s(self) -> float:
    return (self.window[1] - self.window[0]) / 1e6

  def busy(self) -> List[Tuple[float, float]]:
    return _union(self.device, *self.window)

  @property
  def busy_s(self) -> float:
    """Seconds of the window in which some kernel, copy or memset ran."""
    return sum(b - a for a, b in self.busy()) / 1e6

  def device_s(self, match) -> float:
    """Device seconds of the window's events whose name ``match`` takes."""
    lo, hi = self.window
    return sum(min(e, hi) - max(s, lo) for s, e, name in self.device
               if match(name) and min(e, hi) > max(s, lo)) / 1e6

  def host_waits(self) -> int:
    """Runtime calls inside the units that made the host wait for the
    card (:data:`SYNC_CALLS`)."""
    count = 0
    for start, end, name, cat in self.host:
      if cat == 'cuda_runtime' and name in SYNC_CALLS and any(
          a <= start and end <= b for a, b in self.units):
        count += 1
    return count

  def top_device_ops(self, n: int = 10) -> List[List]:
    """The ``n`` device operations (by name) that took most time."""
    lo, hi = self.window
    total: Dict[str, float] = {}
    for s, e, name in self.device:
      if min(e, hi) > max(s, lo):
        total[name] = total.get(name, 0.0) + (min(e, hi) - max(s, lo)) / 1e6
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])
            [:n]]

  def idle_gaps(self, n: int = 10) -> List[List]:
    """The ``n`` longest stretches of the window in which the device was
    idle, longest first, each named after what the host was doing at its
    middle: the innermost host event open then ('host' where none was)."""
    edges = [self.window[0]]
    for a, b in self.busy():
      edges += [a, b]
    edges.append(self.window[1])
    gaps = sorted(((b - a, a, b) for a, b in zip(edges[::2], edges[1::2])
                   if b > a), reverse=True)[:n]
    out = []
    for length, a, b in gaps:
      mid = 0.5 * (a + b)
      inner: Optional[Tuple[float, str]] = None
      for s, e, name, _ in self.host:
        if s <= mid <= e and (inner is None or e - s < inner[0]):
          inner = (e - s, name)
      out.append([inner[1] if inner else 'host', length / 1e6])
    return out
