"""The port's spans (``nerfds_torch/tracing.py``) on the CPU at tiny sizes:
nothing while no profiler records; under ``torch.profiler`` the train
step's and the render's span trees, in the profiler's own trace and in the
records; a new stretch clearing the last one's records; and the trainer's
logged rate."""
import dataclasses
import json
import math
import os
import tempfile
import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nerfds_torch import config as tconfig
from nerfds_torch import tracing
from nerfds_torch import trainer as trainer_lib
from nerfds_torch.datasets import synthetic as tsynthetic
from nerfds_torch.datasets.core import RayStore
from nerfds_torch.evaluation.render import render_image
from nerfds_torch.models import NerfDSModel
from nerfds_torch.models.nerfds import default_extra_params
from nerfds_torch.training import step as tstep

torch.set_num_threads(1)

TOY = dict(num_coarse_samples=6, num_fine_samples=4, nerf_trunk_depth=3,
           nerf_trunk_width=32, nerf_skips=(2,), se3_trunk_depth=3,
           se3_trunk_width=16, se3_skips=(2,), hyper_sheet_depth=3,
           hyper_sheet_width=16, hyper_sheet_skips=(2,), mask_mlp_depth=3,
           mask_mlp_width=16, mask_skips=(2,), use_pallas_compositing=True)
NUM_EMBEDS = 4
STEP_CHILDREN = ['nerfds.train.gather', 'nerfds.train.forward',
                 'nerfds.train.loss', 'nerfds.train.backward',
                 'nerfds.train.adam']
# Each level's parts, by configuration: nerf_ds has the mask MLP.
PARTS = {
    'nerf_ds': {'sample', 'mask', 'warp', 'hyper', 'trunk', 'rgb',
                'composite'},
    'hypernerf': {'sample', 'warp', 'hyper', 'trunk', 'rgb', 'composite'},
}


def model_for(name: str) -> NerfDSModel:
  preset = {'nerf_ds': tconfig.nerf_ds(), 'hypernerf': tconfig.hypernerf()}
  cfg = dataclasses.replace(preset[name], **TOY)
  return NerfDSModel(cfg, num_warp_embeds=NUM_EMBEDS,
                     num_hyper_embeds=NUM_EMBEDS, device='cpu')


def fused_step(model: NerfDSModel, rays: int = 32):
  g = torch.Generator().manual_seed(0)
  directions = torch.nn.functional.normalize(torch.randn(rays, 3,
                                                         generator=g), dim=-1)
  store = RayStore.from_dict({
      'origins': 0.1 * torch.randn(rays, 3, generator=g),
      'directions': directions, 'rgb': torch.rand(rays, 3, generator=g),
      'mask': torch.rand(rays, 1, generator=g),
      'metadata': {'warp': torch.randint(0, NUM_EMBEDS, (rays, 1),
                                         generator=g, dtype=torch.int32)}})
  train_cfg = tconfig.nerf_ds_train_config(max_steps=200, batch_size=8)
  step = tstep.make_fused_train_step(model, train_cfg, store)
  state = tstep.TrainState.create(
      {k: v.detach() for k, v in model.named_parameters()})
  return step, state


def frame(height=5, width=7):
  g = torch.Generator().manual_seed(1)
  directions = torch.nn.functional.normalize(
      torch.randn(height, width, 3, generator=g), dim=-1)
  return {'origins': 0.1 * torch.randn(height, width, 3, generator=g),
          'directions': directions,
          'metadata': {'warp': torch.zeros(height, width, 1,
                                           dtype=torch.int32)}}


def render(model, rays, chunk=8):
  return render_image(model, rays, default_extra_params(model.config),
                      chunk=chunk,
                      generator=torch.Generator().manual_seed(0))


def profiled(fn):
  """Runs ``fn`` under a CPU profiler; the spans' events of its Chrome
  trace, in order of start."""
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    fn()
  events = json.loads(_chrome_trace(prof))
  events = events['traceEvents'] if isinstance(events, dict) else events
  return sorted(({'name': e['name'], 'start': float(e['ts']),
                  'end': float(e['ts']) + float(e['dur']), 'tid': e['tid']}
                 for e in events
                 if e.get('ph') == 'X' and e.get('cat') == 'user_annotation'
                 and str(e.get('name', '')).startswith('nerfds.')),
                key=lambda e: (e['start'], -e['end']))


def _chrome_trace(prof) -> str:
  fd, path = tempfile.mkstemp(suffix='.json')
  os.close(fd)
  try:
    prof.export_chrome_trace(path)
    with open(path) as f:
      return f.read()
  finally:
    os.remove(path)


def trace_tree(events):
  """(name, [children]) of each outermost span event, nesting by the
  intervals on one thread."""
  roots, stack = [], []
  for e in events:
    node = (e['name'], [])
    while stack and not (stack[-1][0]['tid'] == e['tid']
                         and e['end'] <= stack[-1][0]['end']):
      stack.pop()
    (stack[-1][1][1] if stack else roots).append(node)
    stack.append((e, node))
  return roots


def record_tree(recs):
  """The same tree from the records' parents."""
  nodes = [(r.name, []) for r in recs]
  roots = []
  for r, node in zip(recs, nodes):
    (nodes[r.parent][1] if r.parent is not None else roots).append(node)
  return roots


def names(nodes):
  return [n for n, _ in nodes]


def test_off_no_scope_and_no_record(monkeypatch):
  model = model_for('nerf_ds')
  step, state = fused_step(model)
  profiled(lambda: step(state, torch.Generator().manual_seed(2)))
  before = tracing.records()
  opened = []
  monkeypatch.setattr(torch.profiler, 'record_function',
                      lambda name: opened.append(name))
  assert tracing.span('nerfds.x') is tracing.span('nerfds.y')
  step(state, torch.Generator().manual_seed(3))
  render(model, frame())
  assert opened == []
  after = tracing.records()
  assert len(after) == len(before)
  assert all(a is b for a, b in zip(after, before))


@pytest.mark.parametrize('name', ['nerf_ds', 'hypernerf'])
def test_train_step_span_tree(name):
  model = model_for(name)
  step, state = fused_step(model)
  state.step = 41
  events = profiled(lambda: step(state, torch.Generator().manual_seed(2)))
  tree = trace_tree(events)
  assert names(tree) == ['nerfds.train.step']
  step_children = tree[0][1]
  assert names(step_children) == STEP_CHILDREN
  forward = step_children[1][1]
  assert names(forward) == ['nerfds.model.coarse', 'nerfds.model.fine']
  for _, parts in forward:
    assert parts[0][0] == 'nerfds.model.sample'
    assert {n.split('.')[-1] for n in names(parts)} == PARTS[name]
  # The records hold the same tree, every span in the step's unit.
  recs = tracing.records()
  assert record_tree(recs) == tree
  assert {r.unit for r in recs} == {(41,)}
  assert all(r.host_ms >= 0 and r.device_ms is None for r in recs)


def test_render_span_tree():
  model = model_for('nerf_ds')
  rays = frame(5, 7)
  chunk = 8
  events = profiled(lambda: render(model, rays, chunk))
  tree = trace_tree(events)
  assert names(tree) == ['nerfds.render.image']
  chunks = math.ceil(5 * 7 / chunk)
  assert names(tree[0][1]) == (['nerfds.render.encode']
                               + ['nerfds.render.chunk'] * chunks
                               + ['nerfds.render.assemble'])
  for _, inside in tree[0][1][1:-1]:
    assert names(inside) == ['nerfds.model.coarse', 'nerfds.model.fine',
                             'nerfds.render.to_host']
  recs = tracing.records()
  assert record_tree(recs) == tree
  units = [r.unit for r in recs if r.name == 'nerfds.render.chunk']
  assert units == [(0, c) for c in range(chunks)]
  for r in recs:
    if r.parent is not None and r.name != 'nerfds.render.chunk':
      assert r.unit == recs[r.parent].unit


def test_units_and_parents():
  def spans():
    with tracing.span('a', unit=5):
      with tracing.span('b'):
        with tracing.span('c', unit=2):
          pass
    with tracing.span('d'):
      pass
    with tracing.span('d'):
      pass

  profiled(spans)
  recs = tracing.records()
  assert [(r.name, r.parent, r.unit) for r in recs] == [
      ('a', None, (5,)), ('b', 0, (5,)), ('c', 1, (5, 2)),
      ('d', None, (0,)), ('d', None, (1,))]
  assert all(r.host_end_ns >= r.host_start_ns for r in recs)


def test_a_new_stretch_clears_the_last():
  model = model_for('nerf_ds')
  step, state = fused_step(model)
  profiled(lambda: step(state, torch.Generator().manual_seed(2)))
  assert 'nerfds.train.step' in {r.name for r in tracing.records()}
  profiled(lambda: render(model, frame()))
  got = {r.name for r in tracing.records()}
  assert 'nerfds.render.image' in got
  assert not any(n.startswith('nerfds.train.') for n in got)


def small_trainer(exp_dir=None, **train):
  source = tsynthetic.SyntheticDataSource(num_frames=4, image_size=8,
                                          gt_samples=8)
  train_cfg = dataclasses.replace(
      tconfig.nerf_ds_train_config(max_steps=200, batch_size=8), **train)
  return trainer_lib.Trainer(model=model_for('nerf_ds'), train_cfg=train_cfg,
                             datasource=source, exp_dir=exp_dir,
                             use_mesh=False)


def test_trainer_rate_is_steps_over_wall_time_between_print_points(
    monkeypatch, tmp_path):
  reads = []

  def clock():
    reads.append(time.perf_counter())
    return reads[-1]

  monkeypatch.setattr(trainer_lib, 'time',
                      types.SimpleNamespace(perf_counter=clock))
  trainer = small_trainer(tmp_path, print_every=2, save_every=1000)
  logged = []
  trainer.train(num_steps=6, log_fn=lambda step, log: logged.append(
      (step, log['time'])))
  assert [s for s, _ in logged] == [2, 4, 6]
  # One clock read at the loop's start and one at each print point, after
  # the stats came to the host.
  assert len(reads) == 4
  for k, (_, times) in enumerate(logged):
    assert times['steps_per_sec'] == 2 / (reads[k + 1] - reads[k])
    assert times['rays_per_sec'] == times['steps_per_sec'] * 8
  lines = [json.loads(x) for x in
           (tmp_path / 'summaries' / 'metrics.jsonl').read_text().split('\n')
           if x]
  assert [x['time/steps_per_sec'] for x in lines] == [
      t['steps_per_sec'] for _, t in logged]
  assert [x['time/rays_per_sec'] for x in lines] == [
      t['rays_per_sec'] for _, t in logged]


def test_trainer_log_and_checkpoint_spans(tmp_path):
  trainer = small_trainer(tmp_path, print_every=1, save_every=2)
  profiled(lambda: trainer.train(num_steps=3))
  got = [(r.name, r.unit) for r in tracing.records() if r.parent is None]
  assert got == [
      ('nerfds.train.step', (0,)), ('nerfds.trainer.log', (0,)),
      ('nerfds.train.step', (1,)), ('nerfds.trainer.log', (1,)),
      ('nerfds.trainer.checkpoint', (1,)),
      ('nerfds.train.step', (2,)), ('nerfds.trainer.log', (2,)),
      ('nerfds.trainer.checkpoint', (2,))]
