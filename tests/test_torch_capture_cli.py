"""The port's captured-scene CLIs on a capture the port's export CLI
writes (the torch march on the CPU), with a toy model on the CPU:
export → split cameras → train (``--datasource nerfies``) → eval (val,
train and test splits) → render (the val cameras and a camera path) →
``metrics_pipeline``. ``generate_test_cameras`` and ``metrics_pipeline``
are held against the JAX package's scripts on the same directories.
"""
import csv
import importlib.util
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from nerfds_torch import eval as eval_cli
from nerfds_torch import export_synthetic, generate_test_cameras
from nerfds_torch import metrics_pipeline
from nerfds_torch import render as render_cli
from nerfds_torch import train as train_cli
from nerfds_torch.camera import Camera
from nerfds_torch.training.checkpoints import CheckpointManager

torch.set_num_threads(1)

FRAMES, SIZE, PATH_FRAMES = 4, 24, 5
# A toy nerf_ds through the preset's paths (the plain versions of the
# kernels run on the CPU).
TRAIN_ARGS = ['--preset', 'synthetic_smoke', '--device', 'cpu',
              '--batch_size', '32', '--max_steps', '3', '--set',
              'model.num_coarse_samples=4', '--set',
              'model.num_fine_samples=4', '--set',
              'model.use_pallas_compositing=True', '--set',
              'model.sigma_gradient_mode=fused', '--set',
              'train.print_every=1']


def jax_script(name):
  """A script of the JAX package's ``scripts/``, loaded as a module."""
  path = Path(__file__).resolve().parent.parent / 'scripts' / f'{name}.py'
  spec = importlib.util.spec_from_file_location(f'jax_{name}', path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


@pytest.fixture(scope='module')
def capture(tmp_path_factory):
  data = tmp_path_factory.mktemp('capture') / 'vrig'
  out, seconds = export_synthetic.main([
      '--out_dir', str(data), '--frames', str(FRAMES), '--image_size',
      str(SIZE), '--gt_samples', '32', '--camera_path_frames',
      str(PATH_FRAMES), '--device', 'cpu'])
  assert out == data and seconds > 0
  return data


@pytest.fixture(scope='module')
def trained(capture):
  exp = capture.parent / 'exp'
  state, metrics, store = train_cli.main([
      *TRAIN_ARGS, '--datasource', 'nerfies', '--data_dir', str(capture),
      '--exp_dir', str(exp)])
  assert store.num_rays == FRAMES * SIZE * SIZE
  return exp, state, metrics


@pytest.fixture(scope='module')
def rendered(trained):
  exp = trained[0]
  args = ['--exp_dir', str(exp), '--device', 'cpu', '--chunk', '256']
  val_dir, val_names = render_cli.main([*args, '--camera_path', 'val',
                                        '--out', str(exp / 'render_val')])
  path_dir, path_names = render_cli.main([
      *args, '--camera_path', 'camera-paths/orbit-novel', '--interval', '2',
      '--out', str(exp / 'render_novel'), '--save_raw'])
  return (val_dir, val_names), (path_dir, path_names)


def test_export_cli_writes_a_capture(capture):
  ids = json.loads((capture / 'dataset.json').read_text())
  assert ids['train_ids'] == [f'left_{i:04d}' for i in range(FRAMES)]
  assert ids['val_ids'] == [f'right_{i:04d}' for i in range(FRAMES)]
  scene = json.loads((capture / 'scene.json').read_text())
  np.testing.assert_allclose(scene['center'], [0.12, -0.08, 0.25],
                             rtol=1e-6)
  assert scene['scale'] == 0.85
  assert len(list((capture / 'rgb' / '1x').glob('*.png'))) == 2 * FRAMES
  assert len(list((capture / 'resized_mask' / '1x').glob('*.png.png'))) == (
      2 * FRAMES)
  assert len(list((capture / 'camera-paths' / 'orbit-novel').glob(
      '*.json'))) == PATH_FRAMES
  assert (capture / 'points.npy').exists()
  if not torch.cuda.is_available():
    # The default device is the card: no card, no export (nor a march on
    # the CPU).
    with pytest.raises(RuntimeError, match='CUDA'):
      export_synthetic.main(['--out_dir', str(capture.parent / 'x'),
                             '--frames', '1', '--image_size', '8'])
    assert not (capture.parent / 'x').exists()


@pytest.mark.parametrize('mode', ['split', 'orbit', 'lerp'])
def test_generate_test_cameras_match_jax(capture, tmp_path, mode):
  ours, theirs = tmp_path / 'ours', tmp_path / 'theirs'
  for d in (ours, theirs):
    shutil.copytree(capture, d, ignore=shutil.ignore_patterns('*.png'))
  argv = ['--mode', mode, '--name', f'{mode}-gen', '--frames', '7']
  generate_test_cameras.main(['--data_dir', str(ours), *argv])
  jax_gen = jax_script('generate_test_cameras')
  if mode == 'split':
    jax_gen.mode_split(theirs)
    subdirs = ('train_camera', 'vrig_camera')
  elif mode == 'orbit':
    jax_gen.mode_orbit(theirs, 'orbit-gen', frames=7, sweep_deg=60.0)
    subdirs = ('camera-paths/orbit-gen',)
  else:
    jax_gen.mode_lerp(theirs, 'lerp-gen', frames=7)
    subdirs = ('camera-paths/lerp-gen',)
  for sub in subdirs:
    names = sorted(p.name for p in (theirs / sub).glob('*.json'))
    assert names == sorted(p.name for p in (ours / sub).glob('*.json'))
    assert len(names) == {'train_camera': FRAMES, 'vrig_camera': FRAMES
                          }.get(sub, 7)
    for name in names:
      got = Camera.from_json(ours / sub / name).get_parameters()
      want = Camera.from_json(theirs / sub / name).get_parameters()
      for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=1e-6, err_msg=k)


def test_train_and_eval_clis_on_a_capture(trained):
  exp, state, metrics = trained
  assert state.step == 3
  assert CheckpointManager(exp / 'checkpoints').all_steps() == [3]
  saved = json.loads((exp / 'experiment.json').read_text())
  assert saved['datasource_type'] == 'nerfies'
  assert np.isfinite(list(metrics.values())).all()
  report = eval_cli.main(['--exp_dir', str(exp), '--device', 'cpu',
                          '--eval_once', '--num_val_eval', '1',
                          '--num_train_eval', '1', '--num_test_eval', '1',
                          '--chunk', '256', '--save_images'])
  assert list(report['val']['per_item']) == ['right_0000']
  assert list(report['train']['per_item']) == ['left_0000']
  # The test split: one camera of the orbit-mild trajectory (the val
  # cameras), with a train item's warp id.
  assert report['test']['per_item']['000']['finite']
  assert report['test']['metadata']['warp'] in range(FRAMES)
  assert json.loads((exp / 'metrics' / '3.json').read_text()) == json.loads(
      json.dumps(report))
  panels = sorted(p.relative_to(exp / 'renders' / '3').as_posix()
                  for p in (exp / 'renders' / '3').rglob('*.png'))
  assert panels == ['test/000.png', 'train/left_0000.png',
                    'val/right_0000.png']


def test_render_cli_on_val_and_a_camera_path(rendered):
  (val_dir, val_names), (path_dir, path_names) = rendered
  assert val_names == [f'right_{i:04d}' for i in range(FRAMES)]
  assert path_names == ['00000', '00001', '00002']  # every 2nd of 5
  for out_dir, names in rendered:
    frames = sorted(p.stem for p in (out_dir / 'frames').glob('*.png'))
    assert frames == names
    assert (out_dir / 'debug_frame0.png').read_bytes()[:4] == b'\x89PNG'
    assert any((out_dir / f).exists() for f in ('rgb.mp4', 'rgb.mp4.frames'))
    assert any((out_dir / f).exists()
               for f in ('debug.mp4', 'debug.mp4.frames'))
  from nerfds_torch.image_utils import load_image
  assert load_image(path_dir / 'debug_frame0.png').shape == (
      2 * SIZE, 3 * SIZE, 3)
  raw = np.load(path_dir / 'raw_00000.npy', allow_pickle=True).item()
  assert raw['rgb'].shape == (SIZE, SIZE, 3) and np.isfinite(raw['rgb']).all()


def test_metrics_pipeline_matches_jax(capture, rendered, tmp_path):
  (val_dir, _), _ = rendered
  dirs = (val_dir / 'frames', capture / 'rgb' / '1x',
          capture / 'resized_mask' / '1x')
  got = metrics_pipeline.evaluate_dir(*dirs, device='cpu')
  want = jax_script('metrics_pipeline').evaluate_dir(*dirs)
  assert [r['frame'] for r in got] == [r['frame'] for r in want] == [
      f'right_{i:04d}' for i in range(FRAMES)]
  # Tolerances: the masked metrics are the same numpy code on the same
  # decoded bytes, and MSE is within 1e-6. PSNR is float32 on both sides
  # and follows a float32 mean summed in another order than XLA's: a
  # float32 ulp of a 10 dB value is 9.5e-7 dB and one ulp of the MSE moves
  # it by 5e-7 dB (measured: up to 2.9e-6 dB), so 1e-5. SSIM and MS-SSIM
  # are float32 convolutions in another order, and E[x²]−µ² cancels on the
  # flat white background (measured: up to 1.9e-5 and 9.9e-6), so 3e-5.
  tolerance = dict(mse=1e-6, masked_mse=1e-6, masked_psnr=1e-6, psnr=1e-5,
                   ssim=3e-5, ms_ssim=3e-5)
  for g, w in zip(got, want):
    assert g.keys() == w.keys() == {'frame', *tolerance}
    for k, atol in tolerance.items():
      np.testing.assert_allclose(g[k], w[k], atol=atol, rtol=0, err_msg=k)
  out_csv = tmp_path / 'metrics.csv'
  means = metrics_pipeline.main(['--pred_dir', str(dirs[0]), '--gt_dir',
                                 str(dirs[1]), '--mask_dir', str(dirs[2]),
                                 '--out_csv', str(out_csv), '--use_lpips',
                                 '--device', 'cpu'])
  rows = list(csv.DictReader(out_csv.open()))
  assert [r['frame'] for r in rows][-1] == 'MEAN'
  assert float(rows[-1]['psnr']) == pytest.approx(means['psnr'])
  assert means['psnr'] == pytest.approx(np.mean([r['psnr'] for r in got]))
