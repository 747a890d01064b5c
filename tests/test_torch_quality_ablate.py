"""The port's paired-seed quality gate (``python -m
nerfds_torch.quality_ablate``) against ``scripts/quality_ablate.py``, and
the ``nerf_ds_fast`` preset through the train CLI, on the CPU at toy
widths."""
import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from nerfds_torch import quality_ablate
from nerfds_torch import train as train_cli

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The toy widths of tests/test_torch_render.py.
TOY = dict(
    num_coarse_samples=6, num_fine_samples=4, nerf_trunk_depth=3,
    nerf_trunk_width=32, nerf_skips=(2,), se3_trunk_depth=3,
    se3_trunk_width=16, se3_skips=(2,), hyper_sheet_depth=3,
    hyper_sheet_width=16, hyper_sheet_skips=(2,), mask_mlp_depth=3,
    mask_mlp_width=16, mask_skips=(2,))
TOY_SETS = [f'model.{k}={v}' for k, v in TOY.items()]
ROW_KEYS = ['case', 'steps', 'batch', 'seed', 'wall_s', 'train_psnr',
            'train_ssim', 'val_psnr', 'val_ssim', 'val_ms_ssim']


@pytest.fixture(scope='module')
def jax_script():
  spec = importlib.util.spec_from_file_location(
      'jax_quality_ablate', os.path.join(REPO, 'scripts', 'quality_ablate.py'))
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def test_cases_equal_the_jax_scripts(jax_script):
  assert list(quality_ablate.CASES) == list(jax_script.CASES)
  assert quality_ablate.CASES == jax_script.CASES


def test_paired_summary_equals_the_jax_scripts(jax_script):
  rows = []
  for i, (case, seed) in enumerate((c, s) for c in ('f32', 'topk16',
                                                    'bf16_trunk')
                                   for s in (0, 1, 2)):
    if (case, seed) == ('bf16_trunk', 2):
      continue  # an unpaired seed is left out of that case's deltas
    rows.append({'case': case, 'seed': seed,
                 'val_psnr': 20.0 + 1.37 * i - 0.5 * seed,
                 'val_ms_ssim': 0.8 - 0.011 * i + 0.003 * seed})
  rows.append({'case': 'topk8', 'seed': 5, 'val_psnr': 1.0,
               'val_ms_ssim': 0.1})  # no f32 run at seed 5: no deltas
  assert quality_ablate.paired_summary(rows) == jax_script.paired_summary(
      rows)
  assert quality_ablate.paired_summary(rows)['topk8'] == {}


@pytest.mark.parametrize('mode,case', [('vmap', 'topk16'),
                                       ('fused', 'bf16_trunk_rgb_mask')])
def test_cli_writes_the_jax_scripts_rows(tmp_path, monkeypatch, capsys, mode,
                                         case):
  """One seed of the gate's recipe on the CPU, shrunk: 10 steps (the
  recipe's schedules need 10 for every horizon to be a step or more; at 2,
  both packages' sharpening schedule gives NaN), batch 16, and the toy
  widths added to each case's overrides; in both ∇σ modes."""
  made = []

  def toy_trainer(overrides, *args, **kwargs):
    made.append(overrides)
    return make_trainer(dict(overrides, **TOY), *args, **kwargs)

  make_trainer = quality_ablate.make_trainer
  monkeypatch.setattr(quality_ablate, 'make_trainer', toy_trainer)
  out = tmp_path / 'gate.jsonl'
  quality_ablate.main(['--device', 'cpu', '--cases', case, '--steps', '10',
                       '--batch', '16', '--seeds', '0', '--out', str(out),
                       '--sigma_gradient_mode', mode])
  assert made == [{'sigma_gradient_mode': mode},
                  {**quality_ablate.CASES[case], 'sigma_gradient_mode': mode}]
  lines = capsys.readouterr().out.strip().splitlines()
  printed = [json.loads(line) for line in lines if line.startswith('{')]
  written = [json.loads(line) for line in out.read_text().splitlines()]
  assert printed == written[:2]
  assert [r['case'] for r in printed] == ['f32', case]
  for row in printed:
    assert list(row) == ROW_KEYS
    assert row['steps'] == 10 and row['batch'] == 16 and row['seed'] == 0
    assert all(math.isfinite(row[k]) for k in ROW_KEYS[4:])
  summary = json.loads(lines[-1][len('PAIRED_SUMMARY '):])
  assert lines[-1].startswith('PAIRED_SUMMARY ')
  assert written[2] == {'paired_summary': summary}
  assert summary[case]['delta_val_psnr']['per_seed'] == [round(
      printed[1]['val_psnr'] - printed[0]['val_psnr'], 3)]


def test_cli_fused_refuses_top_k_cases(capsys):
  """Top-k is inactive in 'fused' mode, where a top-k case would run the
  exact path: the gate refuses it before training anything."""
  with pytest.raises(SystemExit):
    quality_ablate.main(['--device', 'cpu', '--cases', 'bf16_trunk,topk8',
                         '--sigma_gradient_mode', 'fused'])
  assert 'topk8: norm_grad_topk is active only' in capsys.readouterr().err


def test_cli_lists_the_cases():
  done = subprocess.run([sys.executable, '-m', 'nerfds_torch.quality_ablate',
                         '--list'], cwd=REPO, capture_output=True, text=True,
                        timeout=120)
  assert done.stdout.split() == list(quality_ablate.CASES)


def test_train_cli_nerf_ds_fast_on_cpu(tmp_path):
  """The nerf_ds_fast preset (norm_grad_topk=16) trains through the train
  CLI: top-k selects 3 of 6 + 4 samples at the toy widths."""
  argv = ['--preset', 'nerf_ds_fast', '--datasource', 'synthetic',
          '--device', 'cpu', '--exp_dir', str(tmp_path), '--batch_size',
          '16', '--max_steps', '2', '--set', 'model.norm_grad_topk=3']
  for kv in TOY_SETS:
    argv += ['--set', kv]
  state, metrics, _ = train_cli.main(argv)
  model_cfg = json.loads((tmp_path / 'model_config.json').read_text())
  assert model_cfg['norm_grad_topk'] == 3
  assert model_cfg['sigma_gradient_mode'] == 'vmap'
  assert state.step == 2 and math.isfinite(metrics['psnr'])
  assert all(bool(torch.isfinite(v).all()) for v in state.params.values())
  preset, _, _ = train_cli.preset_configs('nerf_ds_fast', 10, False)
  assert preset.norm_grad_topk == 16 and preset.norm_grad_topk_active
  assert dataclasses.replace(preset, norm_grad_topk=None) == (
      train_cli.preset_configs('nerf_ds', 10, False)[0])
