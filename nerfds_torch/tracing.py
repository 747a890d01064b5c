"""Spans: the program's phases, named on the profiler's clock.

``span(name, unit=None)`` marks a stretch of the host's work, such as a
train step, a level of the model or a render chunk::

  with tracing.span('nerfds.train.step', unit=state.step):
    ...

It does nothing unless a profiler records (``torch.profiler.profile``,
say): then it returns one shared no-op context, at the cost of one
attribute read. While a profiler records, a span

* opens ``torch.profiler.record_function(name)``, so that it lands in that
  profiler's own trace as a ``user_annotation`` on the clock of the
  device's kernels, copies and memsets; and
* appends a :class:`Record` to an in-memory list: its name, its parent
  (the innermost span open on the same thread when it opened), its unit,
  the host's start and end (``time.perf_counter_ns``), and on CUDA a pair
  of timing events recorded on the current stream at entry and exit.

The events give the span's device interval: from when the stream reached
the entry event (when the work enqueued before it ended, or at once if the
card was idle) to the end of the span's last operation. So the interval
holds the span's own work and the time the card waited for the host to
dispatch it, and sibling spans tile the stream's timeline, but for the
idle time that falls between them while the host is outside every span.
The events are read by :func:`records`, after the caller has synchronised,
so the host never waits on them while the spans run.

A span's unit says which step or chunk it belongs to, as a tuple. A span
given ``unit=k`` takes its parent's unit followed by ``k`` (``(k,)`` where
it has no parent); a span given none takes its parent's, or, where it has
no parent, ``(i,)`` with ``i`` the number of earlier parentless spans of
its name in the stretch. So a train step's spans share ``(step,)``, and a
render chunk's ``(frame, chunk)``.

The list holds the last stretch of spans recorded: the first span opened
after a profiler starts recording clears it. To see the starts, the first
span recorded wraps ``torch.autograd.profiler._run_on_profiler_start``,
which every profiler calls as it starts recording.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler


@dataclasses.dataclass
class Record:
  """One span of the last stretch. ``parent`` indexes the list that
  :func:`records` returns; the times are the host's, in ns; ``device_ms``
  is filled by :func:`records` (None off CUDA, or while the span is
  open)."""
  name: str
  parent: Optional[int]
  unit: Tuple[int, ...]
  host_start_ns: int
  host_end_ns: Optional[int] = None
  device_ms: Optional[float] = None
  events: Optional[Tuple[Any, Any]] = dataclasses.field(default=None,
                                                        repr=False)

  @property
  def host_ms(self) -> Optional[float]:
    if self.host_end_ns is None:
      return None
    return (self.host_end_ns - self.host_start_ns) / 1e6


class _Off:
  """The context a span returns while no profiler records."""
  __slots__ = ()

  def __enter__(self):
    return None

  def __exit__(self, *exc):
    return False


_OFF = _Off()
_lock = threading.Lock()
_records: List[Record] = []
_roots: Dict[str, int] = {}   # parentless spans of each name in the stretch
_stale = True                 # a profiler started after the last span
_watching = False             # profiler starts set _stale
_stretch = 0                  # the number of stretches begun
_local = threading.local()    # .stack: this thread's open spans; .stretch


def span(name: str, unit: Optional[int] = None):
  """A context manager that marks its body as the span ``name``; see the
  module docstring."""
  if not _profiler._is_profiler_enabled:
    return _OFF
  return _Span(name, unit)


def _watch_profiler_starts() -> None:
  start = _profiler._run_on_profiler_start

  def on_profiler_start():
    global _stale
    _stale = True
    start()

  _profiler._run_on_profiler_start = on_profiler_start


def _event():
  if torch.cuda.is_initialized():
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event
  return None


class _Span:
  __slots__ = ('name', 'unit', 'stretch', 'record', 'scope')

  def __init__(self, name: str, unit: Optional[int]):
    self.name, self.unit = name, unit

  def __enter__(self):
    global _stale, _stretch, _watching
    with _lock:
      if not _watching:
        _watch_profiler_starts()
        _watching = True
      if _stale:
        _records.clear()
        _roots.clear()
        _stale = False
        _stretch += 1
      if getattr(_local, 'stretch', None) != _stretch:
        _local.stack, _local.stretch = [], _stretch
      stack = _local.stack
      parent = stack[-1] if stack else None
      if parent is None:
        unit = ((self.unit,) if self.unit is not None
                else (_roots.get(self.name, 0),))
        _roots[self.name] = _roots.get(self.name, 0) + 1
      else:
        unit = _records[parent].unit + (
            (self.unit,) if self.unit is not None else ())
      self.stretch = _stretch
      self.record = Record(self.name, parent, unit, time.perf_counter_ns())
      stack.append(len(_records))
      _records.append(self.record)
    self.scope = torch.profiler.record_function(self.name)
    self.scope.__enter__()
    start = _event()
    if start is not None:
      self.record.events = (start, None)
    return None

  def __exit__(self, *exc):
    end = _event()
    self.scope.__exit__(*exc)
    record = self.record
    record.host_end_ns = time.perf_counter_ns()
    if end is not None and record.events is not None:
      record.events = (record.events[0], end)
    # A stretch begun while this span was open has dropped it.
    if getattr(_local, 'stretch', None) == self.stretch:
      _local.stack.pop()
    return False


def records() -> List[Record]:
  """The last stretch's spans in the order they opened, each with its
  device interval in ms (``device_ms``) where it ran on CUDA. Call it after
  the device has finished the stretch's work (a synchronise)."""
  with _lock:
    out = list(_records)
  for r in out:
    start, end = r.events or (None, None)
    if r.device_ms is None and end is not None:
      end.synchronize()
      r.device_ms = start.elapsed_time(end)
  return out
