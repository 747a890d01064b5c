"""The port's study CLIs against the JAX package's scripts:
``convergence_run``, ``normals_ablation``, ``batch_scaling_study`` and
``run_scenes``, on the CPU.

Tables and recipes are compared as data: each JAX script's ``main`` runs
with its scene and its ``Trainer`` replaced by recorders, which stop it
before anything trains, and so does the port's. The port's CLIs then run
for a few steps at toy widths (``nerf_ds()`` shrunk by monkeypatching the
preset) on a 4-frame 16-pixel scene, and ``run_scenes`` trains one
exported capture beside a missing directory.
"""
import csv
import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path

import pytest
import torch

import nerfds_tpu.datasets.synthetic
import nerfds_tpu.trainer
from nerfds_torch import batch_scaling_study, bench, convergence_run
from nerfds_torch import config as tconfig
from nerfds_torch import export_synthetic, normals_ablation, run_scenes
import nerfds_torch.datasets.synthetic
import nerfds_torch.trainer

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
# The toy widths of tests/test_torch_quality_ablate.py.
TOY = dict(
    num_coarse_samples=6, num_fine_samples=4, nerf_trunk_depth=3,
    nerf_trunk_width=32, nerf_skips=(2,), se3_trunk_depth=3,
    se3_trunk_width=16, se3_skips=(2,), hyper_sheet_depth=3,
    hyper_sheet_width=16, hyper_sheet_skips=(2,), mask_mlp_depth=3,
    mask_mlp_width=16, mask_skips=(2,))
SCENE = ['--frames', '4', '--image_size', '16', '--batch', '16']


def load_script(name):
  spec = importlib.util.spec_from_file_location(
      f'jax_{name}', REPO / 'scripts' / f'{name}.py')
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


@pytest.fixture
def toy_nerf_ds(monkeypatch):
  toy_cfg = dataclasses.replace(tconfig.nerf_ds(), **TOY)
  monkeypatch.setattr(tconfig, 'nerf_ds', lambda: toy_cfg)


class Stop(Exception):
  pass


def record(monkeypatch, trainer_module, synthetic_module, stop_after=1):
  """Replaces ``Trainer`` and ``SyntheticDataSource`` in both modules with
  recorders; the ``stop_after``-th ``from_experiment`` raises ``Stop``."""
  seen = {'sources': [], 'trainers': []}

  class Source:
    train_ids = val_ids = ['0000']

    def __init__(self, **kwargs):
      seen['sources'].append(kwargs)

  class Recorder:
    @classmethod
    def from_experiment(cls, model_cfg, train_cfg, source, **kwargs):
      kwargs.pop('device', None)
      seen['trainers'].append((dataclasses.asdict(model_cfg),
                               dataclasses.asdict(train_cfg), kwargs))
      if len(seen['trainers']) == stop_after:
        raise Stop

  monkeypatch.setattr(trainer_module, 'Trainer', Recorder)
  monkeypatch.setattr(synthetic_module, 'SyntheticDataSource', Source)
  return seen


def recorded_jax(monkeypatch, name, argv, stop_after=1):
  script = load_script(name)
  seen = record(monkeypatch, nerfds_tpu.trainer,
                nerfds_tpu.datasets.synthetic, stop_after)
  monkeypatch.setattr(sys, 'argv', [name] + argv)
  with pytest.raises(Stop):
    script.main()
  return seen


def recorded_port(monkeypatch, main, argv, stop_after=1):
  seen = record(monkeypatch, nerfds_torch.trainer,
                nerfds_torch.datasets.synthetic, stop_after)
  with pytest.raises(Stop):
    main(argv + ['--device', 'cpu'])
  return seen


def without_kernel_flags(model_cfg):
  assert {k: model_cfg[k] for k in bench.KERNEL_PATH} == bench.KERNEL_PATH
  return {k: v for k, v in model_cfg.items() if k not in bench.KERNEL_PATH}


# -- the tables -----------------------------------------------------------------


def test_cases_scenes_and_lr_rule_are_the_jax_scripts():
  assert normals_ablation.CASES == load_script('normals_ablation').CASES
  assert list(normals_ablation.CASES) == ['full', 'ref_radiance',
                                          'no_normals']
  assert run_scenes.DEFAULT_SCENES == load_script('run_scenes').DEFAULT_SCENES
  jax_study = load_script('batch_scaling_study')
  for rule in ('linear', 'sqrt', 'none'):
    for batch in (512, 1000, 2048, 8192):
      assert (batch_scaling_study.lr_factor(rule, batch)
              == jax_study.lr_factor(rule, batch))


# -- the recipes, as data ---------------------------------------------------------


@pytest.mark.parametrize('path', bench.PATHS)
@pytest.mark.parametrize('extra', [[], ['--no_normals']])
def test_convergence_run_recipe_is_the_jax_scripts(monkeypatch, tmp_path,
                                                   path, extra):
  argv = ['--steps', '1000', '--batch', '1024', '--seed', '3',
          '--frames', '8', '--image_size', '32', *extra]
  want = recorded_jax(monkeypatch, 'convergence_run',
                      argv + ['--out', str(tmp_path / 'jax.jsonl')])
  got = recorded_port(monkeypatch, convergence_run.main,
                      argv + ['--out', str(tmp_path / 'a' / 'port.jsonl'),
                              '--path', path])
  assert got['sources'] == want['sources']
  (model_cfg, train_cfg, kwargs), = got['trainers']
  (jmodel_cfg, jtrain_cfg, jkwargs), = want['trainers']
  if path == 'kernel':
    model_cfg = without_kernel_flags(model_cfg)
    jmodel_cfg = without_kernel_flags({**jmodel_cfg, **bench.KERNEL_PATH})
  assert model_cfg == jmodel_cfg
  assert train_cfg == jtrain_cfg and kwargs == jkwargs
  assert jmodel_cfg['predict_norm'] == (not extra)


@pytest.mark.parametrize('case', list(normals_ablation.CASES))
@pytest.mark.parametrize('scene', ['emissive', 'mechanism'])
def test_normals_ablation_recipe_is_the_jax_scripts(monkeypatch, tmp_path,
                                                    scene, case):
  """Each case's model and train config, and the scene, as the JAX
  script builds them; the port marches the ground truth in torch where
  JAX marches it in jitted JAX."""
  argv = ['--steps', '500', '--batch', '256', '--seeds', '1,2', '--scene',
          scene, '--exponent', '60', '--cases', case, '--out', str(tmp_path)]
  want = recorded_jax(monkeypatch, 'normals_ablation', argv)
  got = recorded_port(monkeypatch, normals_ablation.main,
                      argv + ['--path', 'plain'])
  (jsource,), (source,) = want['sources'], got['sources']
  assert jsource.pop('gt_backend') == 'jax'
  assert source.pop('gt_backend') == 'torch'
  assert source.pop('device') == torch.device('cpu')
  assert source == jsource
  assert got['trainers'] == want['trainers']
  assert got['trainers'][0][0]['use_ref_radiance'] == (case == 'ref_radiance')


@pytest.mark.parametrize('batch,rule', [(512, 'none'), (2048, 'linear'),
                                        (2048, 'sqrt'), (8192, 'linear'),
                                        (8192, 'sqrt')])
def test_batch_scaling_recipe_is_the_jax_scripts(monkeypatch, batch, rule):
  """``make_trainer``'s configs and Trainer arguments at each grid point
  of the JAX script's default grid (the warm-up, and 1024-ray
  microbatches from a batch of 4096)."""
  jax_study = load_script('batch_scaling_study')
  steps = 5_120_000 // batch
  seen = record(monkeypatch, nerfds_tpu.trainer,
                nerfds_tpu.datasets.synthetic, stop_after=0)
  jax_study.make_trainer(batch, steps, rule, 4, source=None)
  (jmodel_cfg, jtrain_cfg, jkwargs), = seen['trainers']
  for path in bench.PATHS:
    model_cfg, train_cfg = batch_scaling_study.make_configs(
        batch, steps, rule, 4, path)
    model_cfg = dataclasses.asdict(model_cfg)
    if path == 'kernel':
      model_cfg = without_kernel_flags(model_cfg)
      model_cfg.update({k: jmodel_cfg[k] for k in bench.KERNEL_PATH})
    assert model_cfg == jmodel_cfg
    assert dataclasses.asdict(train_cfg) == jtrain_cfg
  assert jtrain_cfg['accum_steps'] == (batch // 1024 if batch >= 4096 else 1)
  made = []
  monkeypatch.setattr(nerfds_torch.trainer.Trainer, 'from_experiment',
                      lambda *a, **k: made.append(k))
  batch_scaling_study.make_trainer(batch, steps, rule, 4, None, 'plain',
                                   'cpu')
  assert made == [dict(jkwargs, device='cpu')]


# -- the CLIs, a few steps at toy widths -----------------------------------------------


def test_convergence_run_writes_its_rows(toy_nerf_ds, tmp_path):
  out = tmp_path / 'conv' / 'rows.jsonl'
  rows = convergence_run.main(SCENE + ['--steps', '16', '--eval_every', '8',
                                       '--device', 'cpu', '--out', str(out)])
  assert [json.loads(x) for x in out.read_text().splitlines()] == rows
  meta, *curve, normals = rows
  assert meta['meta']['steps'] == 16 and meta['meta']['path'] == 'kernel'
  assert [r['step'] for r in curve] == [8, 16]
  for r in curve:
    assert list(r) == ['step', 'wall_s', 'train_psnr', 'val_psnr',
                       'val_ms_ssim']
    assert all(math.isfinite(r[k]) for k in r)
  assert normals['normal_pixels'] > 0
  assert -1 <= normals['normal_cosine_train_views'] <= 1


def test_normals_ablation_writes_its_rows(toy_nerf_ds, tmp_path, capsys):
  rows, summary = normals_ablation.main(
      SCENE + ['--steps', '16', '--cases', 'full,no_normals', '--device',
               'cpu', '--out', str(tmp_path), '--save_panels'])
  assert [(r['case'], r['seed']) for r in rows] == [('full', 0),
                                                    ('no_normals', 0)]
  for r in rows:
    assert r['path'] == 'kernel' and math.isfinite(r['val_masked_psnr'])
  assert summary['no_normals']['delta_val_psnr']['per_seed'] == [round(
      rows[1]['val_psnr'] - rows[0]['val_psnr'], 3)]
  assert f'PAIRED_SUMMARY {json.dumps(summary)}' in capsys.readouterr().out
  written = json.loads((tmp_path / 'normals_ablation.json').read_text())
  assert written == {'rows': rows, 'paired_vs_full': summary}
  from nerfds_torch.image_utils import load_image
  panel = load_image(tmp_path / 'normals_ablation_full_s0.png')
  assert panel.shape == (16, 32, 3)


def test_batch_scaling_study_writes_its_rows(toy_nerf_ds, tmp_path):
  out = tmp_path / 'study' / 'batch_scaling.json'
  rows, summary = batch_scaling_study.main([
      '--ray_budget', '4096', '--grid', '512:none,1024:sqrt', '--seeds',
      '0', '--device', 'cpu', '--out', str(out), '--path', 'plain'])
  assert [(r['batch'], r['steps']) for r in rows] == [(512, 8), (1024, 4)]
  assert rows[1]['lr0'] == 1e-3 * 2 ** 0.5
  assert all(math.isfinite(r['val_psnr']) for r in rows)
  assert summary == {'1024:sqrt': {
      'delta_val_psnr_mean': round(rows[1]['val_psnr'] - rows[0]['val_psnr'],
                                   3),
      'per_seed': [round(rows[1]['val_psnr'] - rows[0]['val_psnr'], 3)]}}
  assert json.loads(out.read_text()) == {'rows': rows,
                                         'paired_vs_512': summary}


def test_run_scenes_keeps_going_past_a_missing_scene(tmp_path):
  """One exported capture and one missing directory: the missing scene's
  child fails, the next scene trains, and ``summary.csv`` has a row each
  (empty metrics for the failure), as ``tests/test_run_scenes.py`` checks
  on JAX's side."""
  data_root = tmp_path / 'data'
  export_synthetic.main([
      '--out_dir', str(data_root / 'sphere_novel_view'), '--frames', '4',
      '--image_size', '16', '--gt_samples', '24', '--camera_path_frames',
      '2', '--device', 'cpu'])
  exp_root = tmp_path / 'exp'
  sets = [f'model.{k}={v}' for k, v in TOY.items()] + ['train.print_every=1']
  results = run_scenes.main([
      '--data_root', str(data_root), '--exp_root', str(exp_root),
      '--scenes', 'missing', 'sphere', '--max_steps', '2', '--batch_size',
      '16', '--device', 'cpu', '--extra_args',
      *[x for kv in sets for x in ('--set', kv)]])
  assert list(results) == ['missing', 'sphere']
  assert 'returned non-zero exit status' in results['missing']['error']
  config = json.loads((exp_root / 'sphere' / 'model_config.json').read_text())
  assert (config['sigma_gradient_mode'], config['use_pallas_compositing'],
          config['nerf_trunk_width']) == ('fused', True, 32)
  with open(exp_root / 'summary.csv') as f:
    table = list(csv.reader(f))
  keys = sorted(results['sphere'])
  assert 'psnr' in keys
  assert table[0] == ['scene'] + keys
  assert table[1] == ['missing'] + [''] * len(keys)
  assert table[2][0] == 'sphere'
  assert math.isfinite(float(table[2][1 + keys.index('psnr')]))


@pytest.mark.parametrize('preset', ['nerf_ds', 'nerf_ds_fast', 'hypernerf',
                                    'vanilla', 'synthetic_smoke'])
def test_run_scenes_refuses_a_preset_whose_topk_the_kernel_path_drops(
    preset, tmp_path, monkeypatch):
  """``nerf_ds_fast``'s ``norm_grad_topk=16`` is active only under 'vmap'
  ∇σ: ``--path kernel`` refuses it before any scene starts, and ``--path
  plain`` runs it as it stands. Every other preset runs on either path."""
  started = []
  monkeypatch.setattr(run_scenes.subprocess, 'run',
                      lambda cmd, **kwargs: started.append(cmd))
  argv = ['--data_root', str(tmp_path), '--exp_root', str(tmp_path / 'exp'),
          '--scenes', 'bell', '--preset', preset, '--device', 'cpu']
  if preset == 'nerf_ds_fast':
    with pytest.raises(ValueError, match='norm_grad_topk is active only'):
      run_scenes.main(argv)
    assert not started
    argv += ['--path', 'plain']
  run_scenes.main(argv)
  assert len(started) == 1 and started[0][started[0].index('--preset') + 1] \
      == preset
