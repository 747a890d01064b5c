"""The readers of the program's spans on synthetic records and a synthetic
trace: each gives the value computed by hand, and None where a unit's spans
are missing, where the records do not cover the window's units, and where
the program has no spans."""
from types import SimpleNamespace

import pytest

from h100_bench import harness, spans, trace as trace_lib

TRAIN = ['gather_ms.train', 'forward_ms.train', 'backward_ms.train',
         'adam_ms.train', 'host_step_ms.train']
RENDER = ['trunk_ms_per_chunk.render', 'fields_ms_per_chunk.render',
          'to_host_idle_ms_per_chunk.render']


def rec(name, unit, device_ms, host_ms=None):
  return SimpleNamespace(name=name, unit=unit, device_ms=device_ms,
                         host_ms=host_ms)


def train_records():
  """Two steps, the second with two backward spans (microbatches)."""
  out = []
  for step, (gather, forward, backward, adam, host) in {
      7: (0.5, 20.0, [60.0], 3.0, 150.0),
      8: (0.7, 22.0, [30.0, 32.0], 5.0, 170.0)}.items():
    unit = (step,)
    out.append(rec('nerfds.train.step', unit, 90.0, host))
    out.append(rec('nerfds.train.gather', unit, gather))
    out.append(rec('nerfds.train.forward', unit, forward))
    out.append(rec('nerfds.model.trunk', unit, 99.0))   # no train metric's
    out += [rec('nerfds.train.backward', unit, b) for b in backward]
    out.append(rec('nerfds.train.adam', unit, adam))
  return out


def render_records():
  """One frame of two chunks."""
  out = [rec('nerfds.render.image', (0,), 500.0)]
  for c, (trunk, warp, hyper, mask) in enumerate([(10.0, 2.0, 1.0, 3.0),
                                                  (12.0, 4.0, 1.0, 5.0)]):
    unit = (0, c)
    out.append(rec('nerfds.render.chunk', unit, 70.0))
    out += [rec('nerfds.model.trunk', unit, trunk / 2),
            rec('nerfds.model.trunk', unit, trunk / 2),
            rec('nerfds.model.warp', unit, warp),
            rec('nerfds.model.hyper', unit, hyper),
            rec('nerfds.model.mask', unit, mask),
            rec('nerfds.model.rgb', unit, 40.0)]
  return out


def window(annotations=()):
  """Window 0-1000 µs: kernels at 0-100, 300-400 and 600-1000."""
  ev = lambda cat, name, ts, dur: {'ph': 'X', 'cat': cat, 'name': name,
                                   'ts': ts, 'dur': dur}
  return trace_lib.Trace.from_events(
      [ev('user_annotation', trace_lib.WINDOW, 0, 1000),
       ev('kernel', 'k1', 0, 100), ev('kernel', 'k2', 300, 100),
       ev('gpu_memcpy', 'Memcpy DtoH', 600, 400)]
      + [ev('user_annotation', name, ts, dur)
         for name, ts, dur in annotations])


def view(kind, units, trace=None):
  return harness.View(kind=kind, trace=trace or window(), units=units,
                      rays=1, model_cfg={}, trunk_rows=[])


def read(name, v):
  return harness.metric_reader(name)(v)


@pytest.fixture
def records(monkeypatch):
  def use(recs):
    monkeypatch.setattr(spans, 'records', lambda: recs)
  return use


def test_train_readers(records):
  records(train_records())
  v = view('train', 2)
  assert read('gather_ms.train', v) == pytest.approx(0.6)
  assert read('forward_ms.train', v) == pytest.approx(21.0)
  assert read('backward_ms.train', v) == pytest.approx(61.0)
  assert read('adam_ms.train', v) == pytest.approx(4.0)
  assert read('host_step_ms.train', v) == pytest.approx(160.0)
  assert all(read(name, v) is None for name in RENDER)


def test_render_readers(records):
  records(render_records())
  v = view('render', 2)
  assert read('trunk_ms_per_chunk.render', v) == pytest.approx(11.0)
  assert read('fields_ms_per_chunk.render', v) == pytest.approx(8.0)
  assert all(read(name, v) is None for name in TRAIN)


def test_to_host_idle():
  # Idle: 100-300 and 400-600. to_host 50-250 holds 150 µs of it; to_host
  # 350-450 and assemble 440-700 (350-700 together) hold 200: 350 µs over
  # 2 chunks. The trunk's span, idle 100-300 too, is not read.
  v = view('render', 2, window([('nerfds.render.to_host', 50, 200),
                                ('nerfds.render.to_host', 350, 100),
                                ('nerfds.render.assemble', 440, 260),
                                ('nerfds.model.trunk', 100, 200)]))
  assert read('to_host_idle_ms_per_chunk.render', v) == pytest.approx(0.175)
  assert read('to_host_idle_ms_per_chunk.render', view('render', 2)) is None
  assert read('to_host_idle_ms_per_chunk.render',
              view('train', 2, v.trace)) is None


def drop(recs, name, unit):
  return [r for r in recs if not (r.name == name and r.unit == unit)]


@pytest.mark.parametrize('name,kind,recs', [
    # A step without its gather, or without its backward.
    ('gather_ms.train', 'train',
     drop(train_records(), 'nerfds.train.gather', (8,))),
    ('backward_ms.train', 'train',
     drop(train_records(), 'nerfds.train.backward', (7,))),
    # A chunk without its trunk, or without any of the fields.
    ('trunk_ms_per_chunk.render', 'render',
     drop(render_records(), 'nerfds.model.trunk', (0, 1))),
    ('fields_ms_per_chunk.render', 'render', [
        r for r in render_records()
        if not (r.unit == (0, 0) and r.name in (
            'nerfds.model.warp', 'nerfds.model.hyper', 'nerfds.model.mask'))]),
    # A device interval not read (a span still open, or no card).
    ('forward_ms.train', 'train', [
        rec(r.name, r.unit, None) if r.name == 'nerfds.train.forward' else r
        for r in train_records()]),
])
def test_none_where_a_unit_lacks_its_spans(records, name, kind, recs):
  records(recs)
  assert read(name, view(kind, 2)) is None


@pytest.mark.parametrize('name', TRAIN + RENDER[:2])
def test_none_where_the_records_do_not_cover_the_window(records, name):
  kind = 'train' if name.endswith('.train') else 'render'
  full = train_records() if kind == 'train' else render_records()
  for recs, units in ((full, 3), (full, 1), ([], 2), (None, 2)):
    records(recs)
    assert read(name, view(kind, units)) is None
  # A window in which no device ran anything.
  records(full)
  idle = trace_lib.Trace.from_events([{
      'ph': 'X', 'cat': 'user_annotation', 'name': trace_lib.WINDOW,
      'ts': 0, 'dur': 1000}])
  assert read(name, view(kind, 2, idle)) is None
