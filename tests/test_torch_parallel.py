"""The port's data-parallel layer (``nerfds_torch/parallel``) against one
process and the JAX package.

* ``local_shard_slice`` against JAX's, for 1-5 processes.
* A mesh of one rank is the step without a mesh, bit for bit.
* Two gloo ranks in child processes (``tests/torch_parallel_worker.py``,
  a ``FileStore`` rendezvous under ``tmp_path``), at the toy widths of
  ``tests/test_torch_training.py``: the explicit step on a global batch
  split in two against one process's step and JAX's ``make_train_step``;
  parameters bit-identical across ranks; each rank's process-local store
  against JAX's ``build_ray_store`` of its items; ``render_image`` across
  ranks against one process; a checkpoint written by rank 0 resumed on
  both; ``eval_psnr`` through the mesh; the refused 'batch' norm.
* The train CLI under ``python -m torch.distributed.run`` with 2 ranks.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfds_tpu import config as jconfig
from nerfds_tpu.datasets import synthetic as jsynthetic
from nerfds_tpu.models import NerfDSModel as JaxModel
from nerfds_tpu.parallel import distributed as jdistributed
from nerfds_tpu.training import step as jstep
from nerfds_torch.convert import params_from_jax
from nerfds_torch.datasets import synthetic as tsynthetic
from nerfds_torch.evaluation.render import render_image
from nerfds_torch.parallel import distributed, mesh as mesh_lib
from nerfds_torch.trainer import Trainer, eval_extra_params
from tests import torch_parallel_worker as worker

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CHILD_TIMEOUT_S = 300


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
  return float((got - want).norm() / want.norm().clamp_min(1e-12))


@pytest.mark.parametrize('processes', range(1, 6))
def test_local_shard_slice_matches_jax(monkeypatch, processes):
  for index in range(processes):
    monkeypatch.setattr(jax, 'process_count', lambda: processes)
    monkeypatch.setattr(jax, 'process_index', lambda: index)
    monkeypatch.setattr(distributed, 'process_count', lambda: processes)
    monkeypatch.setattr(distributed, 'process_index', lambda: index)
    for total in range(13):
      assert (distributed.local_shard_slice(total)
              == jdistributed.local_shard_slice(total)), (total, index)


def test_mesh_helpers_on_one_process():
  mesh = mesh_lib.create_mesh('cpu')
  assert (mesh.rank, mesh.world_size, mesh.group) == (0, 1, None)
  tensors = {'a': torch.ones(3), 'b': torch.zeros(2, 2)}
  # No collective at world size 1: the tensors come back as they were.
  assert mesh_lib.all_reduce_mean(tensors, mesh) is tensors
  assert mesh_lib.broadcast(tensors, mesh) is tensors
  assert mesh_lib.all_gather_rows(tensors['b'], mesh) is tensors['b']
  assert mesh_lib.pad_to_multiple(49, 2) == 50
  assert mesh_lib.pad_to_multiple(48, 4) == 48
  two = dataclasses.replace(mesh, rank=1, world_size=2)
  batch = {'x': torch.arange(8), 'm': {'y': torch.arange(16).reshape(8, 2)}}
  half = mesh_lib.shard_batch(batch, two)
  assert half['x'].tolist() == [4, 5, 6, 7]
  assert half['m']['y'].tolist() == [[8, 9], [10, 11], [12, 13], [14, 15]]
  with pytest.raises(ValueError, match='divide'):
    mesh_lib.shard_batch({'x': torch.arange(7)}, two)
  with pytest.raises(ValueError, match='batch'):
    mesh_lib.check_batch_norm('batch', two)
  mesh_lib.check_batch_norm('batch', mesh)


def test_world_one_mesh_is_the_step_without_one():
  source = tsynthetic.SyntheticDataSource(**worker.SOURCE)
  cfg = worker.train_cfg(print_every=1)
  runs = {}
  for use_mesh in (True, False):
    stats = []
    trainer = Trainer.from_experiment(worker.model_cfg(), cfg, source,
                                      use_mesh=use_mesh, device='cpu')
    assert (trainer.mesh is not None) == use_mesh
    state = trainer.train(num_steps=2, log_fn=lambda s, d: stats.append(
        d['stats']))
    runs[use_mesh] = state, stats
  (mesh_state, mesh_stats), (state, stats) = runs[True], runs[False]
  for k, v in state.params.items():
    assert torch.equal(mesh_state.params[k], v), k
  assert mesh_stats == stats


# -- two gloo ranks ---------------------------------------------------------


def _jax_params():
  jmodel = JaxModel(
      config=worker.model_cfg(jconfig, sigma_gradient_mode='vmap'),
      num_warp_embeds=worker.NUM_EMBEDS, num_hyper_embeds=worker.NUM_EMBEDS)
  return jmodel, jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0)))


def _jax_steps(jmodel, params):
  """JAX's step-0 gradients and its params after ``worker.STEPS`` steps of
  ``make_train_step`` on the global batches."""
  cfg = worker.train_cfg(jconfig)
  batches = [jax.tree_util.tree_map(jnp.asarray, worker.toy_batch(s))
             for s in range(worker.STEPS)]
  scalars = jstep.eval_schedules(jstep.build_schedules(cfg), 0)
  (_, _), grads = jax.jit(jax.value_and_grad(
      jstep.make_loss_fn(jmodel, cfg), has_aux=True))(
          params, batches[0], jax.random.PRNGKey(1), scalars)
  step_fn = jstep.make_train_step(jmodel, cfg, donate=False)
  state = jstep.TrainState.create(params)
  for i, batch in enumerate(batches):
    state, _ = step_fn(state, batch, jax.random.PRNGKey(i))
  return jax.device_get(grads), jax.device_get(state.params)


@pytest.fixture(scope='module')
def two_ranks(tmp_path_factory):
  """The two ranks' results, with the references computed here while the
  children run."""
  out_dir = tmp_path_factory.mktemp('ranks')
  jmodel, jparams = _jax_params()
  params = params_from_jax(jparams)
  torch.save(params, out_dir / 'params.pt')
  env = {**os.environ, 'OMP_NUM_THREADS': '1'}
  procs = [subprocess.Popen(
      [sys.executable, str(REPO / 'tests' / 'torch_parallel_worker.py'),
       str(rank), '2', str(out_dir)], cwd=REPO, env=env,
      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
      for rank in range(2)]
  try:
    refs = {'params': params}
    refs['one'] = worker.explicit_steps(worker.toy_model(),
                                        worker.train_cfg(), params)
    refs['jax_grads'], refs['jax_params'] = _jax_steps(jmodel, jparams)
    source = tsynthetic.SyntheticDataSource(**worker.SOURCE)
    refs['init_params'] = Trainer.from_experiment(
        worker.model_cfg(), worker.train_cfg(), source, use_mesh=False,
        device='cpu').init_state(seed=0).params
    strat = worker.toy_model(**worker.STRATIFIED)
    strat.load_state_dict(params)
    # Two ranks pad the chunk to a multiple of 2: one process renders the
    # padded chunk to draw the same numbers.
    refs['render'] = render_image(
        strat, worker.render_rays(source),
        eval_extra_params(strat.config, worker.train_cfg(), 0),
        chunk=mesh_lib.pad_to_multiple(worker.RENDER_CHUNK, 2),
        generator=torch.Generator().manual_seed(0))
    jsource = jsynthetic.SyntheticDataSource(**worker.SOURCE)
    refs['jax_stores'] = [jsource.build_ray_store(jsource.train_ids[a:b])
                          for a, b in ((0, 1), (1, 3))]
    logs = [p.communicate(timeout=CHILD_TIMEOUT_S)[0] for p in procs]
  finally:
    for p in procs:
      if p.poll() is None:
        p.kill()
        p.communicate()
  for p, log in zip(procs, logs):
    assert p.returncode == 0, log[-4000:]
  ranks = [torch.load(out_dir / f'rank{r}.pt', weights_only=False)
           for r in range(2)]
  return dict(ranks=ranks, refs=refs, out_dir=out_dir)


def test_two_rank_step_matches_one_process(two_ranks):
  one = two_ranks['refs']['one']
  for got in (r['explicit'] for r in two_ranks['ranks']):
    # The mean of two half-batch means is the full-batch mean up to
    # float32 reassociation (measured below 1e-6).
    for name, want in one['grads'].items():
      assert rel_err(got['grads'][name], want) < 1e-5, name
    for key in ('stats', 'last_stats'):
      for level in ('coarse', 'fine'):
        assert set(got[key][level]) == set(one[key][level])
        for k, want in one[key][level].items():
          np.testing.assert_allclose(float(got[key][level][k]), float(want),
                                     rtol=1e-5, atol=1e-7,
                                     err_msg=f'{key} {level}/{k}')
    # After three Adam steps (tests/test_sharding.py's tolerance).
    for name, want in one['params'].items():
      torch.testing.assert_close(got['params'][name], want, atol=2e-6,
                                 rtol=2e-3, msg=name)


def test_two_rank_params_identical_across_ranks(two_ranks):
  a, b = two_ranks['ranks']
  for key in ('init_params', 'unbroken', 'resumed', 'host'):
    assert a[key].keys() == b[key].keys()
    for name in a[key]:
      assert torch.equal(a[key][name], b[key][name]), (key, name)
  for name in a['explicit']['params']:
    assert torch.equal(a['explicit']['params'][name],
                       b['explicit']['params'][name]), name
  # init_state(seed=rank): rank 1 takes rank 0's draw, one process's seed
  # 0 parameters.
  for name, v in two_ranks['refs']['init_params'].items():
    assert torch.equal(a['init_params'][name], v), name
  assert a['losses'] == b['losses'] and np.isfinite(a['losses']).all()


def test_two_rank_step_matches_jax(two_ranks):
  want_grads = params_from_jax(two_ranks['refs']['jax_grads'])
  want_params = params_from_jax(two_ranks['refs']['jax_params'])
  for got in (r['explicit'] for r in two_ranks['ranks']):
    # tests/test_torch_training.py's tolerance: float32 through two levels
    # and the second order ('fused' here, 'vmap' in JAX).
    for name, want in want_grads.items():
      assert rel_err(got['grads'][name], want) < 1e-3, name
    # tests/test_torch_paired_ab.py's: Adam's first steps are about
    # lr·sign(g), so the grads' rounding shows as about 1e-5.
    for name, want in want_params.items():
      torch.testing.assert_close(got['params'][name], want, rtol=0,
                                 atol=2e-4, msg=name)


def test_process_local_store_matches_jax(two_ranks):
  for rank, want in zip(two_ranks['ranks'], two_ranks['refs']['jax_stores']):
    got = rank['store']
    assert rank['store_slice'] == ((0, 1), (1, 3))[rank['rank']]
    for k in ('origins', 'directions', 'rgb', 'mask'):
      np.testing.assert_array_equal(got[k], getattr(want, k), err_msg=k)
    assert got['metadata'].keys() == want.metadata.keys()
    for k, v in want.metadata.items():
      np.testing.assert_array_equal(got['metadata'][k], v, err_msg=k)
    # tests/test_multihost.py: 3 items of 16x16 split 1/2 leave 512 rays
    # in all once trimmed to the smaller share; one device a rank here.
    assert rank['placed_rays'] == 256


def test_two_rank_render_matches_one_process(two_ranks):
  want = two_ranks['refs']['render']
  for rank in two_ranks['ranks']:
    assert rank['render'].keys() == want.keys()
    for k, v in want.items():
      # The same draws row for row; float32 from two batch shapes.
      np.testing.assert_allclose(rank['render'][k], v, atol=1e-5, rtol=1e-4,
                                 err_msg=k)


def test_checkpoint_by_rank_zero_resumes_on_both(two_ranks):
  for rank in two_ranks['ranks']:
    assert rank['resumed_step'] == worker.STEPS
    for name, v in rank['unbroken'].items():
      assert torch.equal(rank['resumed'][name], v), name
  exp = two_ranks['out_dir'] / 'exp'
  assert sorted(p.name for p in (exp / 'checkpoints').iterdir()) == [
      'ckpt_2.pt', 'ckpt_3.pt']
  lines = (exp / 'summaries' / 'metrics.jsonl').read_text().splitlines()
  assert [json.loads(x)['step'] for x in lines] == [1, 2, 3]  # rank 0 only
  assert json.loads((exp / 'train_config.json').read_text())[
      'batch_size'] == worker.GLOBAL_BATCH


def test_eval_psnr_through_the_mesh(two_ranks):
  for rank in two_ranks['ranks']:
    assert rank['eval_mesh'].keys() == rank['eval_alone'].keys()
    assert abs(rank['eval_mesh']['psnr'] - rank['eval_alone']['psnr']) < 1e-3
  assert (two_ranks['ranks'][0]['eval_mesh']
          == two_ranks['ranks'][1]['eval_mesh'])


def test_batch_norm_refused_across_ranks(two_ranks):
  """JAX takes a 'batch' norm's statistics over the global batch; the
  port refuses the combination (ROADMAP.md, queue 3)."""
  for rank in two_ranks['ranks']:
    assert rank['batch_norm_refused'] == [True, True]


def test_collectives_across_ranks(two_ranks):
  for rank in two_ranks['ranks']:
    assert rank['mean']['a'].tolist() == [0.5, -1.5]
    assert rank['mean']['b'].tolist() == [[2.5, 2.5], [2.5, 2.5]]
    assert rank['max']['a'].tolist() == [1.0, 0.0]
    assert rank['max']['b'].tolist() == [[3.0, 3.0], [3.0, 3.0]]
    assert rank['broadcast']['a'].tolist() == [0.0, -0.0]
    assert rank['broadcast']['b'].tolist() == [[2.0, 2.0], [2.0, 2.0]]
    assert rank['gathered'].tolist() == [[-0.5, -0.5], [-1.5, -1.5],
                                         [-1.5, -1.5]]


def test_histogram_rows_are_the_global_stride(two_ranks):
  rows = torch.arange(2 * 1000 * 3, dtype=torch.float32).reshape(-1, 3)
  for rank in two_ranks['ranks']:
    assert torch.equal(rank['strided'], rows[::2000 // 64])


# -- the CLI under torchrun -------------------------------------------------


def _free_port() -> int:
  with socket.socket() as s:
    s.bind(('127.0.0.1', 0))
    return s.getsockname()[1]


def test_train_cli_under_torchrun(tmp_path):
  exp = tmp_path / 'exp'
  cmd = [sys.executable, '-m', 'torch.distributed.run', '--nnodes', '1',
         '--nproc_per_node', '2', '--master_addr', '127.0.0.1',
         '--master_port', str(_free_port()), '-m', 'nerfds_torch.train',
         '--device', 'cpu', '--preset', 'synthetic_smoke', '--exp_dir',
         str(exp), '--max_steps', '3', '--batch_size', '16', '--set',
         'model.num_coarse_samples=4', '--set', 'model.num_fine_samples=4',
         '--set', 'model.nerf_trunk_width=16', '--set',
         'train.print_every=1']
  env = {**os.environ, 'OMP_NUM_THREADS': '1'}
  proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                        text=True, timeout=CHILD_TIMEOUT_S)
  assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
  assert proc.stdout.count('ranks: 2') == 1, proc.stdout
  assert proc.stdout.count('step 3 loss') == 1, proc.stdout
  names = sorted(p.name for p in exp.iterdir())
  assert names == ['checkpoints', 'experiment.json', 'final_metrics.json',
                   'model_config.json', 'summaries', 'train_config.json']
  assert np.isfinite(json.loads(
      (exp / 'final_metrics.json').read_text())['psnr'])
  lines = (exp / 'summaries' / 'metrics.jsonl').read_text().splitlines()
  assert [json.loads(x)['step'] for x in lines] == [1, 2, 3]
