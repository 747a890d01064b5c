"""The port's measuring CLIs against the JAX package's: ``python -m
nerfds_torch.bench`` against the root ``bench.py``, ``bench_ablate``
against ``scripts/bench_ablate.py``, and ``bench_scaling`` under two gloo
ranks, on the CPU at toy widths (``nerf_ds()`` shrunk by monkeypatching
the preset; the kernels' plain versions run on CPU tensors).

Tables and recipes are compared as data. The JAX side runs only where its
numbers are compared: ``bench.py``'s ``build`` at toy widths, for its
batch and its model configs.
"""
import dataclasses
import importlib.util
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nerfds_tpu import config as jconfig
from nerfds_torch import bench, bench_ablate
from nerfds_torch import config as tconfig

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
CHILD_TIMEOUT_S = 300
BATCH = 16
# The toy widths of tests/test_torch_quality_ablate.py.
TOY = dict(
    num_coarse_samples=6, num_fine_samples=4, nerf_trunk_depth=3,
    nerf_trunk_width=32, nerf_skips=(2,), se3_trunk_depth=3,
    se3_trunk_width=16, se3_skips=(2,), hyper_sheet_depth=3,
    hyper_sheet_width=16, hyper_sheet_skips=(2,), mask_mlp_depth=3,
    mask_mlp_width=16, mask_skips=(2,))
# bench.py's JSON keys (bench.py:116-127), and the port's one more.
JAX_KEYS = ['metric', 'value', 'unit', 'vs_baseline', 'baseline']
ROW_KEYS = ['ablation', 'ms_per_step', 'rays_per_sec', 'path']


def load_script(path, name):
  spec = importlib.util.spec_from_file_location(name, REPO / path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def toy(lib):
  return dataclasses.replace(lib.nerf_ds(), **TOY)


@pytest.fixture
def toy_nerf_ds(monkeypatch):
  """The port's ``nerf_ds()`` at toy widths, for every caller."""
  toy_cfg = toy(tconfig)
  monkeypatch.setattr(tconfig, 'nerf_ds', lambda: toy_cfg)


@pytest.fixture(scope='module')
def jax_builds():
  """{naive: (the model config bench.py builds, its batch as numpy)} from
  the root bench.py's ``build`` at the toy widths."""
  import jax
  import nerfds_tpu.models
  jbench = load_script('bench.py', 'jax_bench')
  built = {}
  with pytest.MonkeyPatch.context() as mp:
    toy_cfg = toy(jconfig)
    mp.setattr(jconfig, 'nerf_ds', lambda: toy_cfg)
    model_cls = nerfds_tpu.models.NerfDSModel
    for naive in (False, True):
      seen = []

      def recorder(**kwargs):
        seen.append(kwargs)
        return model_cls(**kwargs)

      mp.setattr(nerfds_tpu.models, 'NerfDSModel', recorder)
      _, _, batch = jbench.build(BATCH, naive=naive)
      (kwargs,) = seen
      assert (kwargs['num_warp_embeds'], kwargs['num_hyper_embeds'],
              kwargs['near'], kwargs['far']) == (64, 64, 0.2, 2.0)
      built[naive] = kwargs['config'], jax.device_get(batch)
  return built


@pytest.mark.parametrize('naive', [False, True])
def test_batch_is_bench_pys_bit_for_bit(jax_builds, naive):
  want = jax_builds[naive][1]
  got = bench.random_batch(BATCH, 'cpu')
  assert set(got) == set(want) and set(got['metadata']) == {'warp'}
  pairs = [(got[k], want[k]) for k in want if k != 'metadata']
  pairs.append((got['metadata']['warp'], want['metadata']['warp']))
  for g, w in pairs:
    w = np.asarray(w)
    assert g.numpy().dtype == w.dtype
    np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize('path', bench.PATHS)
@pytest.mark.parametrize('naive', [False, True])
def test_model_configs_are_bench_pys(jax_builds, toy_nerf_ds, naive, path):
  """The path's model and the baseline are bench.py's, field for field,
  but for the kernel path's two flags; the baseline is the same on both
  paths (neither K1 nor K2)."""
  want = dataclasses.asdict(jax_builds[naive][0])
  got = dataclasses.asdict(bench.model_config(naive, path))
  if path == 'kernel' and not naive:
    assert {k: got[k] for k in bench.KERNEL_PATH} == bench.KERNEL_PATH
    got.update({k: want[k] for k in bench.KERNEL_PATH})
  assert got == want
  if naive:
    assert (want['sigma_gradient_mode'], want['concat_dense_inputs'],
            want['use_pallas_compositing']) == ('naive', True, False)


def test_build_takes_the_trainers_init_and_the_batch(toy_nerf_ds):
  """``build``: parameters from ``Generator().manual_seed(0)`` as
  ``Trainer.init_state`` makes them, and one step on the batch moves
  them."""
  from nerfds_torch.models.nerfds import NerfDSModel
  state, step_fn, batch = bench.build(BATCH, path='plain', device='cpu')
  fresh = NerfDSModel(bench.model_config(path='plain'), num_warp_embeds=64,
                      num_hyper_embeds=64, near=0.2, far=2.0,
                      generator=torch.Generator().manual_seed(0),
                      device='cpu')
  for k, v in fresh.named_parameters():
    assert torch.equal(state.params[k], v.detach()), k
  new, stats = step_fn(state, batch, torch.Generator().manual_seed(3))
  assert new.step == 1 and np.isfinite(float(stats['coarse']['loss/total']))
  assert any(not torch.equal(new.params[k], state.params[k])
             for k in state.params)


def test_bench_py_names_the_same_metric():
  source = (REPO / 'bench.py').read_text()
  assert f"'metric': '{bench.METRIC}'" in source
  assert f"'baseline': '{bench.BASELINE}'" in source


def bench_line(capsys):
  lines = capsys.readouterr().out.strip().splitlines()
  assert len(lines) == 1
  return json.loads(lines[0])


@pytest.mark.parametrize('path', bench.PATHS)
def test_bench_cli_prints_bench_pys_line(toy_nerf_ds, capsys, path):
  result, runs = bench.main(['--device', 'cpu', '--quick', '--batch',
                             str(BATCH), '--path', path])
  line = bench_line(capsys)
  assert line == result
  assert list(line) == JAX_KEYS + ['path']
  assert line['metric'] == bench.METRIC and line['path'] == path
  # A CPU number never stands under the card's unit.
  assert line['unit'] == 'rays/s on the cpu'
  assert line['value'] == round(BATCH / runs['path']['sec'], 2)
  assert line['vs_baseline'] == round(
      runs['baseline']['sec'] / runs['path']['sec'], 3)
  assert runs['path']['steps'] == 2 + 3 * 4
  assert runs['baseline']['steps'] == 1 + 3 * 4
  assert len(runs['path']['chains']) == 3
  assert runs['path']['peak_gib'] is None


def test_bench_cli_baseline_failure_raises(toy_nerf_ds, monkeypatch, capsys):
  """A failing baseline is not caught: the CLI exits with its error, and
  prints no line. ``--no-baseline`` leaves it out."""
  build = bench.build

  def failing(batch_size, naive=False, *args, **kwargs):
    if naive:
      raise RuntimeError('baseline failed')
    return build(batch_size, naive, *args, **kwargs)

  monkeypatch.setattr(bench, 'build', failing)
  argv = ['--device', 'cpu', '--quick', '--batch', '8']
  with pytest.raises(RuntimeError, match='baseline failed'):
    bench.main(argv)
  assert capsys.readouterr().out == ''
  result, runs = bench.main(argv + ['--no-baseline'])
  assert result['vs_baseline'] is None and set(runs) == {'path'}
  assert bench_line(capsys) == result


def test_bench_refuses_cuda_without_a_card(monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='CUDA'):
    bench.main(['--quick'])


def test_bench_refuses_to_run_in_a_process_group(monkeypatch, capsys):
  """Inside a process group each rank would time the whole batch, so the
  bench refuses and prints no line: ranks are ``bench_scaling``'s."""
  monkeypatch.setattr(torch.distributed, 'is_initialized', lambda: True)
  with pytest.raises(RuntimeError, match='bench_scaling'):
    bench.main(['--device', 'cpu', '--quick', '--batch', '8'])
  assert capsys.readouterr().out == ''


# -- bench_ablate ---------------------------------------------------------------


@pytest.fixture(scope='module')
def jax_ablate():
  return load_script('scripts/bench_ablate.py', 'jax_bench_ablate')


def test_ablations_are_the_jax_scripts(jax_ablate):
  assert list(bench_ablate.ABLATIONS) == list(jax_ablate.ABLATIONS)
  assert bench_ablate.ABLATIONS == jax_ablate.ABLATIONS
  assert len(bench_ablate.ABLATIONS) == 13


@pytest.mark.parametrize('name', list(bench_ablate.ABLATIONS))
def test_ablation_row_builds_the_jax_scripts_config(jax_ablate, name):
  """Each row's overrides are fields of the port's ``ModelConfig`` with
  JAX's meaning: on the plain path the row's config is JAX's, field for
  field; the kernel path adds only its two flags. The top-k rows are
  refused on the kernel path alone, where top-k cannot act."""
  want = dataclasses.asdict(dataclasses.replace(
      jconfig.nerf_ds(), **jax_ablate.ABLATIONS[name]))
  plain = bench.model_config(path='plain',
                             overrides=bench_ablate.ABLATIONS[name])
  assert dataclasses.asdict(plain) == want
  kernel = bench.model_config(overrides=bench_ablate.ABLATIONS[name])
  assert dataclasses.replace(plain, **bench.KERNEL_PATH) == kernel
  bench_ablate.check_row(name, 'plain')
  if name.startswith('topk'):
    assert plain.norm_grad_topk_active
    with pytest.raises(ValueError, match='active only'):
      bench_ablate.check_row(name, 'kernel')
  else:
    bench_ablate.check_row(name, 'kernel')


@pytest.mark.parametrize('path', bench.PATHS)
def test_bench_ablate_cli_prints_the_jax_scripts_rows(toy_nerf_ds, capsys,
                                                      path):
  results, runs = bench_ablate.main([
      '--device', 'cpu', '--batch', str(BATCH), '--warmup', '1', '--iters',
      '2', '--path', path, '--only', 'full', 'topk16', 'bf16', 'no_warp'])
  lines = capsys.readouterr().out.strip().splitlines()
  rows = [json.loads(x) for x in lines if x.startswith('{')]
  assert [r['ablation'] for r in rows] == ['full', 'topk16', 'bf16',
                                           'no_warp']
  timed = ['full', 'bf16', 'no_warp'] + (['topk16'] if path == 'plain'
                                         else [])
  assert sorted(results) == sorted(timed) == sorted(runs)
  for row in rows:
    if row['ablation'] in timed:
      assert list(row) == ROW_KEYS and row['path'] == path
      assert row['ms_per_step'] == results[row['ablation']] > 0
      assert runs[row['ablation']]['steps'] == 3
    else:  # JAX's error row, with the reason
      assert list(row) == ['ablation', 'error', 'path']
      assert 'norm_grad_topk is active only' in row['error']
  notes = [x for x in lines if x.startswith('#')]
  assert notes == [f'# {name}: {results["full"] - results[name]:+.1f} ms vs '
                   f'full ({results[name]} ms)'
                   for name in results if name != 'full']


# -- bench_scaling ------------------------------------------------------------------


def _free_port() -> int:
  with socket.socket() as s:
    s.bind(('127.0.0.1', 0))
    return s.getsockname()[1]


def test_bench_scaling_on_two_gloo_ranks():
  """Two ranks on the CPU: one of two steps alone while the other waits
  at the barrier, then both step over one group; rank 0 alone prints the
  JAX script's rows and summary. The run has its own time limit, so a
  deadlock fails the test."""
  cmd = [sys.executable, '-m', 'torch.distributed.run', '--nnodes', '1',
         '--nproc_per_node', '2', '--master_addr', '127.0.0.1',
         '--master_port', str(_free_port()), '-m', 'nerfds_torch.bench_scaling',
         '--device', 'cpu', '--tiny', '--per_chip_batch', '8', '--warmup',
         '1', '--iters', '2', '--device_counts', '1', '2', '4']
  env = {**os.environ, 'OMP_NUM_THREADS': '1'}
  proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                        text=True, timeout=CHILD_TIMEOUT_S)
  assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
  lines = [json.loads(x) for x in proc.stdout.splitlines()
           if x.startswith('{')]
  assert len(lines) == 3, proc.stdout
  rows, summary = lines[:2], lines[2]
  assert [r['devices'] for r in rows] == [1, 2]  # 4 > the world: left out
  for row in rows:
    assert list(row) == ['devices', 'ms_per_step', 'rays_per_sec_per_chip',
                         'scaling_efficiency', 'path']
    assert row['ms_per_step'] > 0 and row['path'] == 'kernel'
  assert rows[0]['scaling_efficiency'] == 1.0
  assert summary == {'metric': 'weak_scaling_efficiency',
                     'value': rows[1]['scaling_efficiency'],
                     'unit': 'x vs 1 device @ 8 rays/chip on the cpu',
                     'devices': 2, 'path': 'kernel'}
