"""The plain reference against the port's plain path (no kernel) at toy
widths, for one training step and one render chunk, and the imports of
every module of the benchmark."""
import ast
import dataclasses
import pathlib

import pytest
import torch

from h100_bench import inputs
from h100_bench.reference import model as ref_model
from h100_bench.reference import train as ref_train
from h100_bench.tests import toy_cells

PLAIN = dict(sigma_gradient_mode='vmap', use_pallas_compositing=False)
CONFIGS = ('nerf_ds.train.b2048', 'hypernerf.train.b2048')


def _program(cell, params):
  from nerfds_torch import config as config_lib
  from nerfds_torch.models.nerfds import NerfDSModel
  cfg = dataclasses.replace(
      config_lib.model_config_from_dict(cell.config['model']), **PLAIN)
  n = cell.traffic['num_embeds']
  model = NerfDSModel(cfg, num_warp_embeds=n, num_hyper_embeds=n,
                      near=cell.traffic['near'], far=cell.traffic['far'],
                      device='cpu')
  model.load_state_dict(params)
  return model


@pytest.mark.parametrize('name', CONFIGS)
def test_one_step_against_the_plain_path(name):
  from nerfds_torch import config as config_lib
  from nerfds_torch.datasets.core import RayStore
  from nerfds_torch.training.step import TrainState, make_fused_train_step
  torch.set_num_threads(1)
  cell = toy_cells.toy_cell(name)
  mix, model_cfg = cell.traffic, cell.config['model']
  train_cfg = dict(cell.config['train'], batch_size=mix['batch_size'])
  params = inputs.params(model_cfg, mix['num_embeds'], 3, 'cpu')
  store = inputs.ray_store(mix['frames'], mix['image_size'], 3, 'cpu')
  model = _program(cell, params)
  step = make_fused_train_step(
      model, config_lib.TrainConfig(**train_cfg), RayStore.from_dict(
          {**{k: store[k] for k in ('origins', 'directions', 'rgb', 'mask')},
           'metadata': {'warp': store['warp']}}))
  state = TrainState.create(params)
  state.step = mix['start_step']
  new, stats = step(state, torch.Generator().manual_seed(11))
  want = ref_train.follow(params, model_cfg, train_cfg, store, [11],
                          mix['start_step'], mix['near'], mix['far'])
  got_loss = float(stats['fine']['loss/total'] + stats['coarse']['loss/total'])
  assert got_loss == pytest.approx(want['losses'][0], rel=1e-6)
  grads = {k: m / (1 - ref_train.ADAM_B1)
           for k, m in new.opt_state.mu.items()}
  for k, g in want['grads'].items():
    scale = max(float(g.norm()), 1e-12)
    assert float((grads[k] - g).norm()) <= 1e-4 * scale, k
  for k, p in want['params'].items():
    assert torch.allclose(new.params[k], p, atol=1e-6, rtol=0), k


def test_one_render_chunk_against_the_plain_path():
  from nerfds_torch.evaluation.render import make_render_fn
  torch.set_num_threads(1)
  cell = toy_cells.toy_cell('nerf_ds.render.c4096')
  mix, model_cfg = cell.traffic, cell.config['model']
  params = inputs.params(model_cfg, mix['num_embeds'], 5, 'cpu')
  model = _program(cell, params)
  frame = inputs.orbit_frame(2, mix['image_size'], mix['num_embeds'], 5,
                             'cpu')
  n = mix['chunk']
  scalars = dict(ref_train.scalars_at(cell.config['train'], mix['step']),
                 mask_ratio=1.0, sharp_weights_std=1.0)
  extra = {k: scalars[k] for k in ('nerf_alpha', 'warp_alpha', 'hyper_alpha',
                                   'hyper_sheet_alpha', 'norm_input_alpha')}
  ids = torch.full((n, 1), frame['warp'])
  rays = {'origins': frame['origins'][:n],
          'directions': frame['directions'][:n],
          'metadata': model.encode_metadata({'warp': ids}),
          'mask': torch.zeros(n, 1)}
  got = make_render_fn(model)(rays, extra,
                             torch.Generator().manual_seed(9))['fine']
  g = torch.Generator().manual_seed(9)
  want = ref_model.render(
      params, model_cfg, rays['origins'], rays['directions'], ids[:, 0],
      rays['mask'], scalars, lambda shape: torch.rand(shape, generator=g),
      mix['near'], mix['far'], with_grad=False, sigma_gradient=False)['fine']
  assert 'target_norm' not in got and 'target_norm' not in want
  for k in ('rgb', 'depth', 'acc', 'ray_norm'):
    assert torch.allclose(got[k], want[k], atol=1e-5, rtol=1e-5), k


HERE = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'nerfds_tpu'}


def _imports(path):
  for node in ast.walk(ast.parse(path.read_text())):
    if isinstance(node, ast.Import):
      yield from (a.name.split('.')[0] for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
      yield node.module.split('.')[0]


def test_no_module_imports_jax_and_the_reference_imports_no_program():
  files = sorted(HERE.rglob('*.py'))
  assert len(files) > 10
  for path in files:
    names = set(_imports(path))
    assert not names & FORBIDDEN, (path, names & FORBIDDEN)
    if 'reference' in path.relative_to(HERE).parts:
      assert 'nerfds_torch' not in names, path
