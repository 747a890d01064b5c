"""What every run shares: finding a cell's configuration, traffic mix,
limits and metrics by name, running its traffic kind, and making the
result's line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``); the mix's ``kind`` names the
module that drives it (``traffic/<kind>.py``), the cell's own file
(``cells/<cell>.json``) holds the limits of its correctness check, and
each per-layer metric is read by ``metrics/<metric>.py``. So a new cell of
an existing kind is data only, and a new metric is one new file.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib
from typing import Any, Callable, Dict, List, Optional

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
RESULT_KEYS = ('correct', 'attempted', 'failed', 'metrics', 'device')


def load_json(path: pathlib.Path) -> Dict:
  return json.loads(path.read_text())


@dataclasses.dataclass
class Cell:
  """One entry of ``BENCHMARK.json``'s ``workloads``, with its files read."""
  name: str
  chips: int
  config: Dict         # configs/<config>.json
  traffic: Dict        # traffic/<traffic>.json
  limits: Dict         # cells/<name>.json's 'limits'
  end_to_end: List[Dict]
  per_layer: List[Dict]


def find_cell(bench: Dict, name: str) -> Cell:
  cells = {w['name']: w for w in bench['workloads']}
  if name not in cells:
    raise SystemExit(f'no workload {name!r} in BENCHMARK.json; one of '
                     f'{sorted(cells)}')
  w = cells[name]
  e2e = [m for m in bench['end_to_end']
         if name in m.get('workloads', [name])]
  moved = {m['name'] for m in e2e}
  per_layer = [m for m in bench['per_layer']
               if name in m.get('workloads', [name] if m['moves'] in moved
                                else [])]
  return Cell(name=name, chips=w['chips'],
              config=load_json(HERE / 'configs' / f'{w["config"]}.json'),
              traffic=load_json(HERE / 'traffic' / f'{w["traffic"]}.json'),
              limits=load_json(HERE / 'cells' / f'{name}.json')['limits'],
              end_to_end=e2e, per_layer=per_layer)


@dataclasses.dataclass
class Check:
  """One number compared with the plain reference, beside its limit."""
  name: str
  value: float
  limit: float

  @property
  def ok(self) -> bool:
    return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
  """What a traffic kind's run hands back."""
  attempted: int
  failed: int
  end_to_end: Dict[str, float]
  checks: List[Check]
  memory_peak_bytes: Optional[int]
  view: Any = None          # what the per-layer readers read (traced runs)
  # The control's numbers (the reference in TF32 against the reference),
  # where the caller asked for them; the benchmark's own runs do not.
  control: Optional[List[Check]] = None
  # What the check compared, for a look at where a gap comes from.
  readings: Optional[Dict] = None


def traffic_module(kind: str):
  return importlib.import_module(f'h100_bench.traffic.{kind}')


def metric_reader(name: str) -> Callable[[Any], Optional[float]]:
  """``metrics/<name>.py``'s ``read``."""
  path = HERE / 'metrics' / f'{name}.py'
  spec = importlib.util.spec_from_file_location(
      f'h100_bench.metrics.{name.replace(".", "_")}', path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module.read


def metrics_line(cell: Cell, outcome: Outcome, trace: bool) -> Dict:
  """The line's ``metrics``: the cell's end-to-end metrics, or with
  ``trace`` its per-layer ones; a reader that finds nothing to read
  leaves its metric out."""
  out = {}
  if not trace:
    for m in cell.end_to_end:
      out[m['name']] = {'value': outcome.end_to_end[m['name']],
                        'unit': m['unit']}
    return out
  for m in cell.per_layer:
    value = metric_reader(m['name'])(outcome.view)
    if value is not None:
      out[m['name']] = {'value': value, 'unit': m['unit']}
  return out


def result_line(cell: Cell, outcome: Outcome, trace: bool,
                device: Dict) -> Dict:
  line = {
      'correct': all(c.ok for c in outcome.checks),
      'attempted': outcome.attempted,
      'failed': outcome.failed,
      'metrics': metrics_line(cell, outcome, trace),
      'device': device,
  }
  if trace and outcome.view is not None:
    line['breakdown'] = {
        'device_ops': outcome.view.trace.top_device_ops(),
        'idle_gaps': outcome.view.trace.idle_gaps(),
    }
  line['checks'] = {c.name: {'value': c.value, 'limit': c.limit}
                    for c in outcome.checks}
  return line


def check_lines(outcome: Outcome) -> List[str]:
  return [f'check {c.name}: {c.value!r} (limit {c.limit!r}) '
          f'{"ok" if c.ok else "FAILED"}' for c in outcome.checks]


@dataclasses.dataclass
class View:
  """What the per-layer readers of a traced run read."""
  kind: str                 # the traffic kind: 'train' or 'render'
  trace: Any                # trace.Trace of the window
  units: int                # steps (train) or chunks (render) in it
  rays: int                 # rays trained or rendered in it
  model_cfg: Dict
  trunk_rows: List[int]     # N of each K1 launch in one unit


def percentile(values: List[float], q: float) -> float:
  """The ``q``-th percentile, interpolated linearly between order
  statistics."""
  s = sorted(values)
  pos = (len(s) - 1) * q / 100.0
  lo = int(pos)
  hi = min(lo + 1, len(s) - 1)
  return s[lo] + (s[hi] - s[lo]) * (pos - lo)


class StepTimer:
  """The time of each unit of a window, from CUDA events recorded on the
  stream after each unit and read once the window has closed, so the
  timing makes the host wait for nothing; on the CPU, the host's clock."""

  def __init__(self, torch, device):
    self._torch = torch
    self._cuda = device.type == 'cuda'
    self._marks: List[Any] = []

  def mark(self) -> None:
    if self._cuda:
      event = self._torch.cuda.Event(enable_timing=True)
      event.record()
      self._marks.append(event)
    else:
      import time
      self._marks.append(time.perf_counter())

  def durations_ms(self) -> List[float]:
    """Each unit's milliseconds; call after the stream is synchronised."""
    m = self._marks
    if self._cuda:
      return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
    return [1e3 * (b - a) for a, b in zip(m, m[1:])]


def synchronize(torch, device) -> None:
  if device.type == 'cuda':
    torch.cuda.synchronize(device)


def memory_peak(torch, device) -> Optional[int]:
  return (int(torch.cuda.max_memory_allocated(device))
          if device.type == 'cuda' else None)


def profiled(torch, device, body: Callable[[], None]):
  """Runs ``body`` under ``torch.profiler`` inside the window mark, ends
  the window with a synchronise, and returns the window's trace."""
  from torch.profiler import ProfilerActivity, profile, record_function

  from h100_bench import trace as trace_lib
  activities = [ProfilerActivity.CPU]
  if device.type == 'cuda':
    activities.append(ProfilerActivity.CUDA)
  with profile(activities=activities) as prof:
    with record_function(trace_lib.WINDOW):
      body()
      synchronize(torch, device)
  return trace_lib.Trace.from_profiler(prof)
