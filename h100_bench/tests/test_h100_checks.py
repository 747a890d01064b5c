"""The check that decides ``correct`` fails a broken timed path: each fault
of ``faults.py`` that a cell can have, planted underneath a toy run on the
CPU; and on the card, the control (the reference in TF32) at a cut size."""
import pytest
import torch

from h100_bench import faults
from h100_bench.tests import toy_cells


@pytest.mark.parametrize('name, fault', [
    ('nerf_ds.train.b2048', 'unchanged'),
    ('nerf_ds.train.b2048', 'half_batch'),
    ('hypernerf.train.b2048', 'unchanged'),
    ('hypernerf.train.b2048', 'half_batch'),
    ('nerf_ds.train.b2048', 'trunk_nu'),
    ('hypernerf.train.b2048', 'trunk_nu'),
    ('nerf_ds.render.c4096', 'altered_answer'),
    ('nerf_ds.render.c4096', 'half_rows'),
])
def test_a_fault_is_not_correct(name, fault):
  with faults.plant(fault):
    outcome = toy_cells.run(name, seed=13)
  assert not all(c.ok for c in outcome.checks), [
      (c.name, c.value, c.limit) for c in outcome.checks]


@pytest.mark.parametrize('name', [w['name'] for w in
                                  toy_cells.bench()['workloads']])
def test_a_sound_toy_run_is_correct(name):
  outcome = toy_cells.run(name, seed=17)
  assert all(c.ok for c in outcome.checks), [
      (c.name, c.value, c.limit) for c in outcome.checks]


@pytest.mark.cuda
@pytest.mark.parametrize('name', [w['name'] for w in
                                  toy_cells.bench()['workloads']])
def test_the_control_is_not_correct_on_the_card(name):
  """The cell's own widths and limits, with the mix cut to fit a test
  run: a smaller capture, batch and frame."""
  if not torch.cuda.is_available():
    pytest.skip('the control runs in TF32, which only the card has')
  import time

  from h100_bench import harness
  cell = harness.find_cell(toy_cells.bench(), name)
  cell.traffic = {**cell.traffic, **{k: v for k, v in dict(
      frames=8, image_size=128, batch_size=1024
  ).items() if k in cell.traffic}}
  kind = harness.traffic_module(cell.traffic['kind'])
  outcome = kind.run(cell, 29, 0.1, False, torch.device('cuda', 0),
                     time.perf_counter(), control=True)
  assert all(c.ok for c in outcome.checks)
  assert not all(c.ok for c in outcome.control), [
      (c.name, c.value, c.limit) for c in outcome.control]


def test_the_look_against_float64():
  """``calibrate --witness``'s look: every training number of the program,
  the reference and the control against the reference in float64."""
  from h100_bench import calibrate
  outcome = toy_cells.run('nerf_ds.train.b2048', seed=19, control=True,
                          witness=True)
  look = calibrate.look(outcome.readings, 'float64')
  assert look['dead_leaves'] == 0 and look['leaves'] > 10
  for side in ('program', 'reference', 'control'):
    assert len(look[side]['loss_gaps']) == 3
    assert look[side]['loss_gaps'][0] < 1e-5
