"""The port's evaluation slice against the JAX package: image metrics, the
metric writer, checkpoints and resume, the experiment directory's config
files, ``Trainer.eval_psnr``, ``normal_fidelity``, and the train and eval
CLIs run in-process on the CPU.

The toy ``nerf_ds`` renders unstratified on both sides, so neither draws
random numbers; the JAX side renders through XLA compositing and the port
through ``use_pallas_compositing=True``, which on CPU tensors takes the
kernel's plain version.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

from nerfds_tpu import config as jconfig
from nerfds_tpu.datasets import synthetic as jsynthetic
from nerfds_tpu.evaluation import metrics as jmetrics
from nerfds_tpu.evaluation import normals as jnormals
from nerfds_tpu.models import NerfDSModel as JaxModel
from nerfds_tpu.models import default_extra_params as jax_extra
from nerfds_tpu.trainer import Trainer as JaxTrainer
from nerfds_tpu.training import step as jstep
from nerfds_torch import config as tconfig
from nerfds_torch import datasets as tdatasets
from nerfds_torch import eval as eval_cli
from nerfds_torch import train as train_cli
from nerfds_torch.convert import params_from_jax, train_state_from_jax
from nerfds_torch.datasets import synthetic as tsynthetic
from nerfds_torch.evaluation import metrics as tmetrics
from nerfds_torch.evaluation import normals as tnormals
from nerfds_torch.models import NerfDSModel as TorchModel
from nerfds_torch.models import default_extra_params as torch_extra
from nerfds_torch.trainer import Trainer
from nerfds_torch.training.checkpoints import CheckpointManager
from nerfds_torch.training import step as tstep
from nerfds_torch.training.logging import MetricWriter

torch.set_num_threads(1)

TOY = dict(num_coarse_samples=6, num_fine_samples=4, nerf_trunk_depth=3,
           nerf_trunk_width=32, nerf_skips=(2,), se3_trunk_depth=3,
           se3_trunk_width=16, se3_skips=(2,), hyper_sheet_depth=3,
           hyper_sheet_width=16, hyper_sheet_skips=(2,), mask_mlp_depth=3,
           mask_mlp_width=16, mask_skips=(2,), use_stratified_sampling=False,
           sigma_gradient_mode='vmap')
NUM_EMBEDS = 4


def toy_train_cfg(config_lib, **overrides):
  """The preset's schedules with a few that sit mid-way at step 10."""
  return dataclasses.replace(
      config_lib.nerf_ds_train_config(max_steps=200, batch_size=8),
      warp_alpha_schedule=('linear', 1.5, 4, 50),
      norm_input_alpha_schedule=('linear', 1.0, 4.0, 40),
      nerf_alpha_schedule=('linear', 3.0, 8.0, 40),
      lr_schedule=('exponential', 5e-3, 1e-4, 200), **overrides)


@pytest.fixture(scope='module')
def jax_toy():
  """A JAX toy nerf_ds, its params and a train state at step 10 whose Adam
  moments are seeded random trees."""
  jmodel = JaxModel(config=dataclasses.replace(jconfig.nerf_ds(), **TOY),
                    num_warp_embeds=NUM_EMBEDS, num_hyper_embeds=NUM_EMBEDS,
                    near=jsynthetic.SyntheticDataSource.NEAR,
                    far=jsynthetic.SyntheticDataSource.FAR)
  params = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
  rng = np.random.RandomState(7)
  leaves = lambda scale: jax.tree_util.tree_map(
      lambda p: (rng.rand(*p.shape) * scale).astype(np.float32), params)
  opt = jstep.TrainState.create(params).opt_state
  state = jstep.TrainState(
      step=np.asarray(10, np.int32), params=params,
      opt_state=opt._replace(count=np.asarray(10, np.int32), mu=leaves(0.1),
                             nu=leaves(0.01)))
  return jmodel, params, state


def torch_toy_model(**overrides):
  cfg = dataclasses.replace(tconfig.nerf_ds(), **{
      **TOY, 'use_pallas_compositing': True, **overrides})
  return TorchModel(cfg, num_warp_embeds=NUM_EMBEDS,
                    num_hyper_embeds=NUM_EMBEDS,
                    near=tsynthetic.SyntheticDataSource.NEAR,
                    far=tsynthetic.SyntheticDataSource.FAR, device='cpu')


# -- metrics ----------------------------------------------------------------


def image_pair(h, w, seed=0):
  """An image and a smoothed, noisy copy of it (the JAX metric tests')."""
  rng = np.random.RandomState(seed)
  a = rng.rand(h, w, 3).astype(np.float32)
  b = scipy.ndimage.gaussian_filter(a, sigma=(1.5, 1.5, 0))
  b = np.clip(b + rng.randn(h, w, 3) * 0.02, 0, 1).astype(np.float32)
  return a, b


@pytest.mark.parametrize('size', [96, 192])
def test_metrics_match_jax(size):
  a, b = image_pair(size, size, seed=size)
  want = jmetrics.compute_all(a, b)
  got = tmetrics.compute_all(a, b)
  assert set(got) == set(want) == {'mse', 'psnr', 'ssim', 'ms_ssim'}
  # Tolerance: float32 convolutions and means summed in another order by
  # XLA and by torch.
  np.testing.assert_allclose(got['mse'], want['mse'], rtol=1e-5)
  np.testing.assert_allclose(got['psnr'], want['psnr'], atol=1e-4)
  for k in ('ssim', 'ms_ssim'):
    np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
  ssim_map = tmetrics.compute_ssim(a, b, return_map=True)
  np.testing.assert_allclose(
      ssim_map.numpy(), np.asarray(jmetrics.compute_ssim(
          jnp.asarray(a), jnp.asarray(b), return_map=True)), atol=1e-5)


def test_metrics_match_jax_on_degenerate_patches():
  """Near-constant images with small structured patches, where E[x²]−µ²
  cancels: the clamps keep SSIM and MS-SSIM at most 1, as in JAX."""
  rng = np.random.RandomState(0)
  for _ in range(30):
    a = np.full((64, 64, 3), rng.uniform(0.5, 1.0), np.float32)
    h = rng.randint(4, 20)
    a[:h, :h] = rng.rand(h, h, 3)
    b = a + rng.randn(64, 64, 3).astype(np.float32) * rng.uniform(0, 0.02)
    s = float(tmetrics.compute_ssim(a, b)[0])
    v = float(tmetrics.compute_msssim(a, b))
    assert s <= 1.0 + 1e-6 and v <= 1.0 + 1e-6, (s, v)
    # Tolerance: E[x²]−µ² of a near-constant patch cancels to a variance of
    # about 1e-5 from terms of about 0.5, so the float32 rounding of the
    # two convolutions' sums (about 3e-8) moves σ by up to 1e-3 of itself:
    # measured up to 2.1e-4 of SSIM between XLA and torch.
    np.testing.assert_allclose(
        s, float(jmetrics.compute_ssim(jnp.asarray(a), jnp.asarray(b))[0]),
        atol=5e-4)
    np.testing.assert_allclose(
        v, float(jmetrics.compute_msssim(jnp.asarray(a), jnp.asarray(b))),
        atol=5e-4)


def test_lpips_prep_matches_reference_convention():
  img = np.random.RandomState(0).rand(8, 6, 3).astype(np.float32)
  got = tmetrics.LpipsMetric.prep(img)
  assert tuple(got.shape) == (1, 3, 8, 6)
  np.testing.assert_allclose(
      got.numpy(), jmetrics.LpipsMetric.prep(img, torch).numpy(), atol=0)
  np.testing.assert_allclose(got[0].permute(1, 2, 0).numpy(), img * 2 - 1,
                             atol=1e-7)
  np.testing.assert_allclose(
      tmetrics.LpipsMetric.prep(np.ones((2, 2, 3), np.float32)).numpy(), 1.0)


# -- the metric writer and checkpoints --------------------------------------


def test_metric_writer(tmp_path):
  w = MetricWriter(tmp_path, use_tensorboard=False)
  w.write_scalars(10, {'train': {'loss': torch.tensor(0.5),
                                 'nested': {'psnr': 21.0}}})
  w.write_scalars(20, {'train': {'loss': np.float32(0.25)},
                       'hist': np.zeros(4)})  # arrays are not scalars
  w.write_histogram(20, 'h', torch.zeros(3))  # no TensorBoard: nothing
  w.close()
  lines = [json.loads(line) for line in
           (tmp_path / 'metrics.jsonl').read_text().splitlines()]
  assert lines[0]['step'] == 10
  assert lines[0]['train/loss'] == 0.5
  assert lines[0]['train/nested/psnr'] == 21.0
  assert lines[1]['train/loss'] == 0.25 and 'hist' not in lines[1]


def assert_states_equal(got, want):
  assert got.step == want.step and got.opt_state.count == want.opt_state.count
  for name in ('params', 'mu', 'nu'):
    g = got.params if name == 'params' else getattr(got.opt_state, name)
    w = want.params if name == 'params' else getattr(want.opt_state, name)
    assert g.keys() == w.keys(), name
    for k in w:
      assert torch.equal(g[k], w[k]), (name, k)


def test_checkpoint_round_trip_of_a_jax_state(tmp_path, jax_toy):
  _, _, jstate = jax_toy
  state = train_state_from_jax(jstate)
  template = TorchModel(dataclasses.replace(tconfig.nerf_ds(), **TOY),
                        num_warp_embeds=NUM_EMBEDS,
                        num_hyper_embeds=NUM_EMBEDS, device='cpu')
  template_state = tstep.TrainState.create(dict(template.named_parameters()))
  mgr = CheckpointManager(tmp_path / 'ckpt', keep=2)
  assert mgr.restore(template_state) == (template_state, 0)
  for step in (5, 7, 9):
    mgr.save(step, state)
  assert mgr.all_steps() == [7, 9] and mgr.latest_step() == 9
  assert sorted(p.name for p in (tmp_path / 'ckpt').iterdir()) == [
      'ckpt_7.pt', 'ckpt_9.pt']  # no temporary file left behind
  restored, step = mgr.restore(template_state)
  assert step == 9
  assert_states_equal(restored, state)
  assert restored.params.keys() == template_state.params.keys()
  # The step of the file, not the state's: step 7 holds the same state.
  assert mgr.restore(template_state, step=7)[1] == 7
  mgr.close()


def tiny_source():
  return tsynthetic.SyntheticDataSource(num_frames=4, image_size=8,
                                        gt_samples=8)


def test_resumed_training_matches_an_unbroken_run(tmp_path):
  """4 steps straight against 2 steps, a checkpoint, and 2 more in a new
  trainer: the same parameters, bit for bit."""
  train_cfg = toy_train_cfg(tconfig, save_every=2)
  make = lambda exp_dir=None: Trainer(
      model=torch_toy_model(), train_cfg=train_cfg, datasource=tiny_source(),
      exp_dir=exp_dir)
  straight = make().train(num_steps=4)
  first = make(tmp_path).train(num_steps=2)
  assert first.step == 2
  assert CheckpointManager(tmp_path / 'checkpoints').all_steps() == [2]
  resumed = make(tmp_path).train(num_steps=4)
  assert_states_equal(resumed, straight)
  assert CheckpointManager(tmp_path / 'checkpoints').all_steps() == [2, 4]
  steps = [json.loads(line)['step'] for line in
           (tmp_path / 'summaries' / 'metrics.jsonl').read_text()
           .splitlines()]
  assert steps == [2, 4]  # logged at the last step of each run


def test_exp_dir_configs_load_in_the_jax_package(tmp_path):
  model = torch_toy_model()
  train_cfg = toy_train_cfg(tconfig, save_every=7)
  Trainer(model=model, train_cfg=train_cfg, datasource=tiny_source(),
          exp_dir=tmp_path)
  jmodel_cfg = jconfig.model_config_from_dict(
      json.loads((tmp_path / 'model_config.json').read_text()))
  jtrain_cfg = jconfig.TrainConfig(
      **json.loads((tmp_path / 'train_config.json').read_text()))
  assert dataclasses.asdict(jmodel_cfg) == dataclasses.asdict(model.config)
  assert json.loads(jconfig.to_json(jtrain_cfg)) == json.loads(
      tconfig.to_json(train_cfg))
  want = jstep.eval_schedules(jstep.build_schedules(jtrain_cfg), 30)
  got = tstep.eval_schedules(tstep.build_schedules(train_cfg), 30)
  for k in want:
    np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-6, err_msg=k)


# -- held-out evaluation ----------------------------------------------------


def test_eval_psnr_matches_jax(jax_toy):
  jmodel, params, jstate = jax_toy
  source_kw = dict(num_frames=4, image_size=16, gt_samples=32)
  jtrainer = JaxTrainer(model=jmodel, train_cfg=toy_train_cfg(jconfig),
                        datasource=jsynthetic.SyntheticDataSource(**source_kw),
                        use_mesh=False)
  want = jtrainer.eval_psnr(jstate, chunk=128, masked=True)
  model = torch_toy_model()
  trainer = Trainer(model=model, train_cfg=toy_train_cfg(tconfig),
                    datasource=tsynthetic.SyntheticDataSource(**source_kw))
  before = {k: v.clone() for k, v in model.state_dict().items()}
  got = trainer.eval_psnr(train_state_from_jax(jstate), chunk=128,
                          masked=True)
  assert set(got) == set(want) == {'mse', 'psnr', 'ssim', 'ms_ssim',
                                   'masked_psnr'}
  # Tolerance: float32 renders, XLA against torch, through two levels.
  for k, tol in (('psnr', 1e-3), ('masked_psnr', 1e-3), ('ssim', 1e-4),
                 ('ms_ssim', 1e-4)):
    np.testing.assert_allclose(got[k], want[k], atol=tol, err_msg=k)
  # The state's parameters rendered; the trainer's model kept its own.
  for k, v in model.state_dict().items():
    assert torch.equal(v, before[k]), k
  assert got['psnr'] != pytest.approx(trainer.eval_psnr(
      trainer.init_state(3), chunk=128)['psnr'], abs=1e-3)


def test_normal_fidelity_matches_jax():
  source_kw = dict(num_frames=4, image_size=16, gt_samples=48, specular=True)
  overrides = dict(num_coarse_samples=6, num_fine_samples=4,
                   nerf_trunk_depth=2, nerf_trunk_width=32, se3_trunk_depth=2,
                   se3_trunk_width=16, hyper_sheet_depth=2,
                   hyper_sheet_width=16, mask_mlp_depth=2, mask_mlp_width=16,
                   nerf_skips=(), se3_skips=(), hyper_sheet_skips=(),
                   mask_skips=(), use_stratified_sampling=False,
                   sigma_gradient_mode='vmap')
  jsrc = jsynthetic.SyntheticDataSource(**source_kw)
  jcfg = dataclasses.replace(jconfig.nerf_ds(), **overrides)
  jmodel = JaxModel(config=jcfg, num_warp_embeds=4, num_hyper_embeds=4,
                    near=jsrc.near, far=jsrc.far)
  params = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
  kw = dict(item_ids=jsrc.train_ids[:1], chunk=128, min_weight=0.0)
  want = jnormals.normal_fidelity(
      jmodel, params, jsrc, jax_extra(jcfg),
      jnormals.sphere_analytic_normal(jsynthetic._sphere_center),
      surface_filter=jnormals.sphere_surface_filter(
          jsynthetic._sphere_center), **kw)
  tsrc = tsynthetic.SyntheticDataSource(**source_kw)
  tcfg = dataclasses.replace(tconfig.nerf_ds(), **overrides)
  tmodel = TorchModel(tcfg, num_warp_embeds=4, num_hyper_embeds=4,
                      near=tsrc.near, far=tsrc.far, device='cpu')
  args = (tsrc, torch_extra(tcfg),
          tnormals.sphere_analytic_normal(tsynthetic._sphere_center))
  got = tnormals.normal_fidelity(
      tmodel, params_from_jax(params), *args,
      surface_filter=tnormals.sphere_surface_filter(
          tsynthetic._sphere_center), **kw)
  assert set(got) == set(want)
  assert got['num_pixels'] == want['num_pixels'] > 0
  assert got['surface_pixels'] == want['surface_pixels']
  np.testing.assert_allclose(got['frac_selected'], want['frac_selected'])
  # Tolerance: unit normals from float32 renders, XLA against torch.
  for k in ('cosine', 'surface_cosine'):
    np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
  # The model's own parameters give the same numbers.
  tmodel.load_state_dict(params_from_jax(params))
  again = tnormals.normal_fidelity(tmodel, None, *args, **kw)
  assert again['cosine'] == pytest.approx(got['cosine'], abs=1e-6)


# -- the CLIs ---------------------------------------------------------------


def test_train_and_eval_clis_on_cpu(tmp_path):
  exp = tmp_path / 'exp'
  args = ['--preset', 'synthetic_smoke', '--device', 'cpu', '--exp_dir',
          str(exp), '--batch_size', '32', '--set',
          'model.num_coarse_samples=4', '--set', 'model.num_fine_samples=4',
          '--set', 'train.save_every=2', '--set', 'train.print_every=1']
  state, metrics, _ = train_cli.main([*args, '--max_steps', '3'])
  assert state.step == 3
  assert CheckpointManager(exp / 'checkpoints').all_steps() == [2, 3]
  assert json.loads((exp / 'final_metrics.json').read_text()) == metrics
  assert np.isfinite(metrics['psnr'])
  saved = json.loads((exp / 'experiment.json').read_text())
  assert saved['datasource_type'] == 'synthetic'
  assert json.loads((exp / 'train_config.json').read_text())[
      'save_every'] == 2  # the --set override
  # Resumes at 3: only step 4 runs.
  state, _, _ = train_cli.main([*args, '--max_steps', '4'])
  lines = (exp / 'summaries' / 'metrics.jsonl').read_text().splitlines()
  assert [json.loads(x)['step'] for x in lines] == [1, 2, 3, 4]
  report = eval_cli.main(['--exp_dir', str(exp), '--device', 'cpu',
                          '--eval_once', '--num_val_eval', '1',
                          '--num_train_eval', '1', '--chunk', '1024',
                          '--save_images'])
  on_disk = json.loads((exp / 'metrics' / '4.json').read_text())
  assert on_disk == json.loads(json.dumps(report))
  for split in ('val', 'train'):
    for k in ('psnr', 'ssim', 'ms_ssim'):
      assert np.isfinite(on_disk[split]['mean'][k]), (split, k)
  assert 'test' not in on_disk  # the synthetic source has no test cameras
  panels = sorted((exp / 'renders' / '4').rglob('*.png'))
  assert [p.parent.name for p in panels] == ['train', 'val']
  assert panels[0].read_bytes()[:8] == b'\x89PNG\r\n\x1a\n'
  # --sampling host trains step 5 from the step-4 checkpoint.
  state, metrics, _ = train_cli.main([*args, '--max_steps', '5',
                                      '--sampling', 'host'])
  assert state.step == 5 and np.isfinite(metrics['psnr'])


def test_parse_value_and_every_source_from_config(tmp_path):
  assert train_cli.parse_value('(4,)') == (4,)
  assert train_cli.parse_value('[4, [5]]') == (4, (5,))
  assert train_cli.parse_value('null') is None
  assert train_cli.parse_value('fused') == 'fused'
  from nerfds_tpu import datasets as jdatasets
  jsynthetic.write_nerfies_dataset(
      jsynthetic.SyntheticDataSource(num_frames=8, image_size=8,
                                     gt_samples=8), tmp_path,
      scene_center=(0.1, 0.2, -0.3), scene_scale=0.9)
  for kind in ('synthetic', 'nerfies', 'interp'):
    kw = dict(datasource_type=kind, data_dir=str(tmp_path), random_seed=5,
              synthetic_frames=4, synthetic_image_size=8, interp_interval=3)
    src = tdatasets.from_config(tconfig.ExperimentConfig(**kw))
    want = jdatasets.from_config(jconfig.ExperimentConfig(**kw))
    assert type(src).__name__ == type(want).__name__, kind
    assert (src.train_ids, src.val_ids) == (want.train_ids, want.val_ids)
    assert (src.near, src.far) == (want.near, want.far)
    assert src.embeddings_dict == want.embeddings_dict
    points = src.load_points(shuffle=True)
    assert points is not None and points.shape[1] == 3, kind
    np.testing.assert_array_equal(points, want.load_points(shuffle=True))
    assert len(src.load_test_cameras()) == len(want.load_test_cameras())
  assert src.interval == 3 and len(src.load_test_cameras()) == 2
  synthetic = tdatasets.from_config(tconfig.ExperimentConfig(
      datasource_type='synthetic', synthetic_frames=4,
      synthetic_image_size=8))
  assert synthetic.num_frames == 4 and synthetic.image_size == 8
  assert synthetic.load_test_cameras() == []
  assert synthetic.frame_time('0002') == jsynthetic.SyntheticDataSource(
      num_frames=4).frame_time('0002')
  with pytest.raises(ValueError, match='Unknown datasource'):
    tdatasets.from_config(tconfig.ExperimentConfig(datasource_type='x'))
