"""The harness end to end on the CPU at toy widths: cells, configurations,
traffic kinds and metrics found by name, the result's line, the traced
window's readings, and no result without a card."""
import json

import pytest

from h100_bench import harness, run as run_cli, trace as trace_lib
from h100_bench.tests import toy_cells

WORKLOADS = [w['name'] for w in toy_cells.bench()['workloads']]


@pytest.mark.parametrize('name', WORKLOADS)
def test_cell_files_found_by_name(name):
  cell = harness.find_cell(toy_cells.bench(), name)
  assert harness.traffic_module(cell.traffic['kind']).run
  assert {m['name'] for m in cell.end_to_end} >= {'setup_s'}
  assert len(cell.end_to_end) >= 2 and cell.per_layer
  for m in cell.per_layer:
    assert callable(harness.metric_reader(m['name']))
  assert set(cell.limits) >= {'loss', 'grad', 'step'} or set(
      cell.limits) >= {'rgb', 'acc', 'depth', 'normal'}


def test_every_metric_and_config_is_used():
  bench = toy_cells.bench()
  used = {w['config'] for w in bench['workloads']}
  assert used == {c['name'] for c in bench['configs']}
  for c in bench['configs']:
    assert harness.load_json(harness.ROOT / c['file'])['name'] == c['name']
  reported = set()
  for name in WORKLOADS:
    cell = harness.find_cell(bench, name)
    reported |= {m['name'] for m in cell.end_to_end + cell.per_layer}
  assert reported == {m['name'] for m in bench['end_to_end']
                      + bench['per_layer']}


@pytest.mark.parametrize('name', WORKLOADS)
@pytest.mark.parametrize('trace', [False, True])
def test_result_line(name, trace):
  cell = toy_cells.toy_cell(name)
  outcome = toy_cells.run(name, trace=trace)
  line = harness.result_line(cell, outcome, trace, {'platform': 'cpu'})
  keys = list(line)
  assert keys[:5] == list(harness.RESULT_KEYS)
  assert keys[-1] == 'checks' and set(keys[5:-1]) <= {'breakdown'}
  assert line['correct'] is True and line['failed'] == 0
  assert line['attempted'] >= 1
  if trace:
    # No device ran anything: every reader finds nothing to read.
    assert line['metrics'] == {}
    assert outcome.view.trace.busy_s == 0
  else:
    assert set(line['metrics']) == {m['name'] for m in cell.end_to_end}
    assert all(m['value'] > 0 for m in line['metrics'].values())
  json.dumps(line)


def test_no_card_no_result(capsys, monkeypatch):
  import torch
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  rc = run_cli.main(['--workload', WORKLOADS[0], '--seed', str(2 ** 31 + 5),
                     '--seconds', '1', '--trace', '0'])
  out, err = capsys.readouterr()
  assert rc != 0 and out == '' and 'no result' in err


def _trace():
  """A window of two units: kernels, a copy, host waits and a gap."""
  ev = lambda cat, name, ts, dur: {'ph': 'X', 'cat': cat, 'name': name,
                                   'ts': ts, 'dur': dur}
  return trace_lib.Trace.from_events([
      ev('user_annotation', trace_lib.WINDOW, 0, 1000),
      ev('user_annotation', trace_lib.UNIT, 0, 500),
      ev('user_annotation', trace_lib.UNIT, 500, 480),
      ev('kernel', 'void fused_trunk_fwd_kernel<4>(Params)', 10, 100),
      ev('kernel', 'trunk_bwd_sweep_kernel', 110, 200),
      ev('kernel', 'fused_trunk_fwd_bf16_kernel', 320, 50),
      ev('gpu_memcpy', 'Memcpy DtoH', 400, 10),
      ev('kernel', 'composite_fwd_kernel', 600, 300),
      ev('cuda_runtime', 'cudaStreamSynchronize', 405, 20),
      ev('cuda_runtime', 'cudaStreamSynchronize', 700, 250),
      ev('cuda_runtime', 'cudaMemcpyAsync', 401, 2),
      ev('cuda_runtime', 'cudaDeviceSynchronize', 985, 10),  # outside units
      ev('cpu_op', 'aten::item', 420, 170),
  ])


def test_trace_readings():
  t = _trace()
  assert t.window_s == pytest.approx(1e-3)
  assert t.busy_s == pytest.approx(660e-6)
  assert t.host_waits() == 2
  assert t.device_s(lambda n: 'fused_trunk_fwd_kernel' in n) == \
      pytest.approx(100e-6)
  assert t.top_device_ops(2) == [['composite_fwd_kernel', 300e-6],
                                 ['trunk_bwd_sweep_kernel', 200e-6]]
  gaps = t.idle_gaps(1)
  assert gaps[0][0] == 'aten::item' and gaps[0][1] == pytest.approx(190e-6)


def test_readers_on_a_trace():
  cfg = harness.load_json(harness.HERE / 'configs' / 'nerf_ds.json')['model']
  view = harness.View(kind='train', trace=_trace(), units=2, rays=10,
                      model_cfg=cfg, trunk_rows=[1])
  read = lambda name: harness.metric_reader(name)(view)
  assert read('host_syncs_per_step.train') == 1.0
  assert read('device_idle_share.train') == pytest.approx(34.0)
  assert read('mfu.render') is None and read('device_idle_share.render') is None
  from h100_bench import yardstick
  assert read('mfu.train') == pytest.approx(
      100 * 10 * yardstick.train_flops_per_ray(cfg) / 1e-3 / 67e12)
  spec = yardstick.trunk_spec(cfg)
  least = 2 * (yardstick.trunk_fwd_bound(spec, 1)[0]
               + yardstick.trunk_bwd_bound(spec, 1)[0])
  assert read('trunk_roofline.train') == pytest.approx(100 * least / 300e-6)
