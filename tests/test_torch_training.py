"""The port's training slice against the JAX package: schedules, loss math,
the loss families, the synthetic scene, one full training step, the
train-state conversion, and a CPU ``Trainer`` run.

The training step runs the toy ``nerf_ds`` of ``test_torch_render.py`` on
both sides from the same params and an explicit numpy batch, with
unstratified sampling and no σ noise, so neither side draws random numbers.
JAX runs ``sigma_gradient_mode='fused'`` (its Pallas trunk forward and
backward in interpret mode on the CPU) with XLA compositing; the port runs
``'fused'`` with ``use_pallas_compositing=True``, which on CPU tensors take
the kernels' plain versions. The normal loss weight is run at the preset's
0.001 and at 1.0, where a missing second-order term could not hide inside
the tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerfds_tpu import config as jconfig
from nerfds_tpu.datasets import synthetic as jsynthetic
from nerfds_tpu.models import NerfDSModel as JaxModel
from nerfds_tpu.ops import math as jmath
from nerfds_tpu.training import losses as jlosses
from nerfds_tpu.training import schedules as jschedules
from nerfds_tpu.training import step as jstep
from nerfds_torch import config as tconfig
from nerfds_torch.convert import (params_from_jax, train_state_from_jax,
                                  train_state_to_jax)
from nerfds_torch.datasets import synthetic as tsynthetic
from nerfds_torch.models import NerfDSModel as TorchModel
from nerfds_torch.ops import math as tmath
from nerfds_torch.trainer import Trainer
from nerfds_torch.training import losses as tlosses
from nerfds_torch.training import schedules as tschedules
from nerfds_torch.training import step as tstep

torch.set_num_threads(1)

TOY = dict(num_coarse_samples=6, num_fine_samples=4, nerf_trunk_depth=3,
           nerf_trunk_width=32, nerf_skips=(2,), se3_trunk_depth=3,
           se3_trunk_width=16, se3_skips=(2,), hyper_sheet_depth=3,
           hyper_sheet_width=16, hyper_sheet_skips=(2,), mask_mlp_depth=3,
           mask_mlp_width=16, mask_skips=(2,), use_stratified_sampling=False,
           sigma_gradient_mode='fused')
NUM_EMBEDS = 4


def t(x):
  return torch.from_numpy(np.array(x))


def to_torch(tree):
  return {k: to_torch(v) if isinstance(v, dict) else t(v)
          for k, v in tree.items()}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
  return float((got - want).norm() / want.norm().clamp_min(1e-12))


def toy_train_cfg(config_lib, norm_loss_weight=0.001, **overrides):
  """The preset's losses with schedules that sit mid-way at step 0."""
  return dataclasses.replace(
      config_lib.nerf_ds_train_config(max_steps=200, batch_size=8),
      warp_alpha_schedule=('linear', 1.5, 4, 50),
      norm_input_alpha_schedule=('constant', 2.5),
      sharp_mask_std_schedule=('constant', 0.5),
      lr_schedule=('exponential', 5e-3, 1e-4, 200),
      norm_loss_weight_schedule=('constant', norm_loss_weight), **overrides)


def toy_batch(n=8, seed=0):
  rng = np.random.RandomState(seed)
  directions = rng.randn(n, 3).astype(np.float32)
  directions /= np.linalg.norm(directions, axis=-1, keepdims=True)
  return {
      'origins': rng.randn(n, 3).astype(np.float32) * 0.1,
      'directions': directions,
      'rgb': rng.rand(n, 3).astype(np.float32),
      'mask': rng.rand(n, 1).astype(np.float32),
      'metadata': {'warp': rng.randint(0, NUM_EMBEDS, (n, 1)).astype(
          np.int32)},
  }


def torch_model(**overrides):
  cfg = dataclasses.replace(tconfig.nerf_ds(), **{
      **TOY, 'use_pallas_compositing': True, **overrides})
  return TorchModel(cfg, num_warp_embeds=NUM_EMBEDS,
                    num_hyper_embeds=NUM_EMBEDS, device='cpu')


@pytest.fixture(scope='module')
def jax_params():
  jmodel = JaxModel(config=dataclasses.replace(jconfig.nerf_ds(), **TOY),
                    num_warp_embeds=NUM_EMBEDS, num_hyper_embeds=NUM_EMBEDS)
  return jmodel, jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0)))


@pytest.fixture(scope='module', params=[0.001, 1.0], ids=['norm0.001',
                                                          'norm1'])
def jax_run(request, jax_params):
  """JAX: the gradients and stats at step 0, and the states after one and
  two steps of ``make_train_step`` on the same batch."""
  jmodel, params = jax_params
  train_cfg = toy_train_cfg(jconfig, request.param)
  batch = jax.tree_util.tree_map(jnp.asarray, toy_batch())
  scalars = jstep.eval_schedules(jstep.build_schedules(train_cfg), 0)
  loss_fn = jstep.make_loss_fn(jmodel, train_cfg)
  (_, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
      params, batch, jax.random.PRNGKey(1), scalars)
  step_fn = jstep.make_train_step(jmodel, train_cfg, donate=False)
  state1, _ = step_fn(jstep.TrainState.create(params), batch,
                      jax.random.PRNGKey(1))
  state2, stats2 = step_fn(state1, batch, jax.random.PRNGKey(2))
  return dict(norm_loss_weight=request.param, params=params,
              grads=jax.device_get(grads), stats=jax.device_get(stats),
              state1=jax.device_get(state1), state2=jax.device_get(state2),
              stats2=jax.device_get(stats2))


def test_train_step_matches_jax(jax_run):
  model = torch_model()
  train_cfg = toy_train_cfg(tconfig, jax_run['norm_loss_weight'])
  batch = to_torch(toy_batch())
  params = params_from_jax(jax_run['params'])
  scalars = tstep.eval_schedules(tstep.build_schedules(train_cfg), 0)
  grads, stats = tstep._grads(tstep.make_loss_fn(model, train_cfg), params,
                              batch, None, scalars)
  # Gradients, relative to each tensor's norm: float32 through two levels
  # and a second-order path, summed in another order by XLA and by torch
  # (measured: worst 3.8e-5 at weight 0.001, 1.4e-4 at 1.0). A missing
  # second-order term moves a grad by O(1) of its norm at weight 1.0.
  want = params_from_jax(jax_run['grads'])
  assert set(grads) == set(want)
  for name, w in want.items():
    assert rel_err(grads[name], w) < 1e-3, name
  for level in ('coarse', 'fine'):
    assert set(stats[level]) == set(jax_run['stats'][level])
    for k, w in jax_run['stats'][level].items():
      np.testing.assert_allclose(float(stats[level][k]), float(w), rtol=1e-4,
                                 atol=1e-6, err_msg=f'{level}/{k}')
  step_fn = tstep.make_train_step(model, train_cfg)
  state1, _ = step_fn(tstep.TrainState.create(params), batch)
  state2, stats2 = step_fn(state1, batch)
  assert state2.step == 2 and state2.opt_state.count == 2
  assert stats2['learning_rate'] == pytest.approx(
      float(jax_run['stats2']['learning_rate']), rel=1e-6)
  # Params after two Adam steps at lr 5e-3: Adam's first step is about
  # lr·sign(g), so the grads' rounding shows as about 1e-5 (measured
  # 2.1e-5 and 8.6e-6); a sign flip of a tiny grad would show as 1e-2.
  want_params = params_from_jax(jax_run['state2'].params)
  for name, w in want_params.items():
    torch.testing.assert_close(state2.params[name], w, rtol=0, atol=1e-4,
                               msg=name)


def test_step_from_mid_run_jax_state_matches(jax_run):
  """The port's step from the JAX state after one step gives JAX's second."""
  model = torch_model()
  train_cfg = toy_train_cfg(tconfig, jax_run['norm_loss_weight'])
  state1 = train_state_from_jax(jax_run['state1'])
  assert state1.step == 1 and state1.opt_state.count == 1
  state2, _ = tstep.make_train_step(model, train_cfg)(
      state1, to_torch(toy_batch()))
  want = jax_run['state2']
  for got_tree, want_tree in ((state2.params, want.params),
                              (state2.opt_state.mu, want.opt_state.mu),
                              (state2.opt_state.nu, want.opt_state.nu)):
    for name, w in params_from_jax(want_tree).items():
      # Same tolerance as the params above; the moments are smaller.
      torch.testing.assert_close(got_tree[name], w, rtol=1e-3, atol=1e-4,
                                 msg=name)


def test_train_state_round_trip(jax_run):
  jax_state = jax_run['state2']
  port = train_state_from_jax(jax_state)
  back = train_state_to_jax(port)
  assert back['step'] == 2 and back['opt_state']['count'] == 2
  leaves = lambda tree: jax.tree_util.tree_leaves(tree)
  for a, b in zip(leaves((back['params'], back['opt_state']['mu'],
                          back['opt_state']['nu'])),
                  leaves((jax_state.params, jax_state.opt_state.mu,
                          jax_state.opt_state.nu))):
    np.testing.assert_array_equal(a, np.asarray(b))
  # The JAX step takes the converted state back.
  rebuilt = jstep.TrainState(
      step=jnp.asarray(back['step']), params=back['params'],
      opt_state=optax.ScaleByAdamState(
          count=jnp.asarray(back['opt_state']['count']),
          mu=back['opt_state']['mu'], nu=back['opt_state']['nu']))
  assert int(rebuilt.step) == int(jax_state.step)


def test_fused_and_vmap_give_the_same_grads():
  fused = torch_model()
  plain = torch_model(sigma_gradient_mode='vmap',
                      use_pallas_compositing=False)
  plain.load_state_dict(fused.state_dict())
  train_cfg = toy_train_cfg(tconfig, 1.0)
  scalars = tstep.eval_schedules(tstep.build_schedules(train_cfg), 0)
  batch = to_torch(toy_batch(seed=3))
  params = {k: v.detach() for k, v in fused.named_parameters()}
  got, _ = tstep._grads(tstep.make_loss_fn(fused, train_cfg), params, batch,
                        None, scalars)
  want, _ = tstep._grads(tstep.make_loss_fn(plain, train_cfg), params,
                         batch, None, scalars)
  # Relative to each grad's norm: the same products summed in another
  # order (measured below 1e-4).
  for name, w in want.items():
    assert rel_err(got[name], w) < 1e-3, name


def test_accum_steps_matches_monolithic_batch():
  model = torch_model()
  train_cfg = toy_train_cfg(tconfig)
  batch = to_torch(toy_batch(n=16, seed=4))
  state = tstep.TrainState.create(dict(model.named_parameters()))
  mono, stats_mono = tstep.make_train_step(model, train_cfg)(state, batch)
  accum_cfg = dataclasses.replace(train_cfg, accum_steps=4)
  acc, stats_acc = tstep.make_train_step(model, accum_cfg)(state, batch)
  for name, w in mono.params.items():
    torch.testing.assert_close(acc.params[name], w, rtol=2e-4, atol=1e-6)
  np.testing.assert_allclose(float(stats_acc['fine']['loss/total']),
                             float(stats_mono['fine']['loss/total']),
                             rtol=1e-5)
  assert stats_acc['hist/spatial_points'].shape[-1] == 3
  bad_cfg = dataclasses.replace(train_cfg, accum_steps=3)
  with pytest.raises(ValueError, match='not divisible'):
    tstep.make_train_step(model, bad_cfg)(state, batch)


def test_disable_hyper_grads_freezes_the_hyper_sheet():
  model = torch_model()
  state = tstep.TrainState.create(dict(model.named_parameters()))
  train_cfg = toy_train_cfg(tconfig, disable_hyper_grads=True,
                            grad_max_norm=0.5)
  new, _ = tstep.make_train_step(model, train_cfg)(state,
                                                   to_torch(toy_batch()))
  frozen = [k for k in state.params if k.startswith('hyper_sheet.')]
  assert frozen
  for k, v in state.params.items():
    if k in frozen:
      assert torch.equal(new.params[k], v), k
      assert not new.opt_state.mu[k].any(), k
  assert not torch.equal(new.params['nerf.fine.trunk.hidden_0.kernel'],
                         state.params['nerf.fine.trunk.hidden_0.kernel'])


SCHEDULES = [
    None, 3, ('constant', 2.5), ('linear', 0, 4, 50), ('linear', 1, 2, 0),
    ('exponential', 1e-3, 1e-5, 250000), ('cosine_easing', 0.0, 1.0, 100),
    ('step', 1.0, 10, 0.5, 3),
    {'type': 'step', 'initial_value': 2.0, 'decay_interval': 7,
     'decay_factor': 0.3, 'max_decays': 2, 'final_value': 0.1},
    ('piecewise', ((10000, ('constant', 0.0)),
                   (0, ('linear', 0.0, 4.0, 2000)))),
    ('piecewise', ((30000, ('exponential', 1.0, 0.1, 30000)),
                   (220000, ('constant', 0.1)))),
    ('delayed', ('exponential', 1.0, 0.1, 100), 20, 0.01),
]
STEPS = [0, 1, 5, 49, 50, 99, 100, 2000, 9999, 10000, 10500, 12000, 29999,
         30000, 30001, 60000, 249999, 250000, 300000]


@pytest.mark.parametrize('config', SCHEDULES, ids=str)
def test_schedules_match_jax(config):
  want_fn, got_fn = jschedules.from_config(config), tschedules.from_config(
      config)
  for step in STEPS:
    # float32 on both sides.
    np.testing.assert_allclose(float(got_fn(step)), float(want_fn(step)),
                               rtol=1e-6, atol=1e-9, err_msg=str(step))


def test_train_config_schedules_match_jax():
  want = jstep.build_schedules(jconfig.nerf_ds_train_config())
  got = tstep.build_schedules(tconfig.nerf_ds_train_config())
  assert set(got) == set(want)
  for step in STEPS:
    w = jstep.eval_schedules(want, step)
    for k, v in tstep.eval_schedules(got, step).items():
      np.testing.assert_allclose(v, float(w[k]), rtol=1e-6, atol=1e-9)


def test_loss_math_matches_jax():
  rng = np.random.RandomState(0)
  x_sq = (rng.rand(50) * 4).astype(np.float32)
  for alpha in (-np.inf, -2.0, 0.0, 1.0, 2.0, np.inf):
    for scale in (0.001, 0.05, 1.0):
      np.testing.assert_allclose(
          tmath.general_loss_with_squared_residual(t(x_sq), alpha, scale),
          jmath.general_loss_with_squared_residual(jnp.asarray(x_sq), alpha,
                                                   scale),
          rtol=1e-5, atol=1e-7, err_msg=f'{alpha} {scale}')
  x = (rng.randn(50) * 0.1).astype(np.float32)
  np.testing.assert_allclose(tmath.shrinkage_loss(t(x)),
                             jmath.shrinkage_loss(jnp.asarray(x)), rtol=1e-5)
  np.testing.assert_allclose(tmath.l2_loss(t(x)), jmath.l2_loss(x))
  x0 = np.abs(x) * np.asarray([0, 1] * 25, np.float32)  # zeros, positives
  np.testing.assert_allclose(tmath.safe_sqrt(t(x0)),
                             jmath.safe_sqrt(jnp.asarray(x0)), rtol=1e-6)
  mse = np.float32(0.0123)
  np.testing.assert_allclose(float(tmath.compute_psnr(t(mse))),
                             float(jmath.compute_psnr(mse)), rtol=1e-6)
  grads = {'a': rng.randn(4, 3).astype(np.float32) * 3,
           'b': rng.randn(5).astype(np.float32)}
  for max_val, max_norm in ((0.0, 0.0), (1.0, 0.0), (0.0, 2.0), (2.0, 1.5)):
    want = jmath.clip_gradients(grads, max_val, max_norm)
    got = tmath.clip_gradients({k: t(v) for k, v in grads.items()}, max_val,
                               max_norm)
    for k in grads:
      np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7)


def model_outputs(num_rays=6, num_samples=5, seed=0):
  rng = np.random.RandomState(seed)
  r, s = num_rays, num_samples
  f = lambda *shape: rng.rand(*shape).astype(np.float32)
  out = {'rgb': f(r, 3), 'weights': f(r, s) / s, 'alpha': f(r, s),
         'points': f(r, s, 3), 'warped_points': f(r, s, 5),
         'predicted_norm': f(r, s, 3) - 0.5, 'target_norm': f(r, s, 3) - 0.5,
         'back_facing': f(r, s), 'predicted_mask': f(r, s, 1),
         'sharp_weights': f(r, s) / s}
  batch = {'rgb': f(r, 3), 'mask': f(r, 1)}
  return out, batch


@pytest.mark.parametrize('model_overrides,train_overrides,hyper_reg', [
    ({}, {}, False),                                        # nerf_ds, 3D mask
    ({}, {'use_mask_occlusion_reg_loss': True}, False),
    ({'use_mask_sharp_weights': False}, {'use_shrinkage_loss': True}, True),
    ({'use_3d_mask': False}, {'hyper_reg_loss_weight': 0.01}, True),  # 2D
    ({'use_3d_mask': False}, {'log_percentiles': False}, False),
])
def test_loss_branches_match_jax(model_overrides, train_overrides, hyper_reg):
  out, batch = model_outputs()
  jm = dataclasses.replace(jconfig.nerf_ds(), **model_overrides)
  tm = dataclasses.replace(tconfig.nerf_ds(), **model_overrides)
  jt = dataclasses.replace(jconfig.nerf_ds_train_config(), **train_overrides)
  tt = dataclasses.replace(tconfig.nerf_ds_train_config(), **train_overrides)
  scalars = {'norm_loss_weight': 0.3}
  want_loss, want = jlosses.compute_loss_and_stats(
      jm, jt, jax.tree_util.tree_map(jnp.asarray, out), batch, scalars,
      use_hyper_reg_loss=hyper_reg)
  got_loss, got = tlosses.compute_loss_and_stats(
      tm, tt, to_torch(out), to_torch(batch), scalars,
      use_hyper_reg_loss=hyper_reg)
  assert set(got) == set(want)
  for k in want:
    np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                               atol=1e-7, err_msg=k)
  np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)


def test_synthetic_source_matches_jax_numpy_backend():
  kwargs = dict(num_frames=4, image_size=16, gt_samples=32)
  want = jsynthetic.SyntheticDataSource(**kwargs, gt_backend='numpy')
  got = tsynthetic.SyntheticDataSource(**kwargs)
  assert got.train_ids == want.train_ids and got.val_ids == want.val_ids
  assert got.embeddings_dict == want.embeddings_dict
  for item in want.train_ids + want.val_ids:
    np.testing.assert_array_equal(got.load_rgb(item), want.load_rgb(item))
    np.testing.assert_array_equal(got.load_mask(item), want.load_mask(item))
  a, b = got.build_ray_store(got.train_ids), want.build_ray_store(
      want.train_ids)
  for k in ('origins', 'directions', 'rgb', 'mask'):
    np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
  np.testing.assert_array_equal(a.metadata['warp'], b.metadata['warp'])
  np.testing.assert_array_equal(got.load_item('0003')['metadata']['warp'],
                                want.load_item('0003')['metadata']['warp'])
  shaded = dict(kwargs, specular=True, field_kind='shaded',
                light_mode='camera', white_background=True)
  np.testing.assert_array_equal(
      tsynthetic.SyntheticDataSource(**shaded).load_rgb('0001'),
      jsynthetic.SyntheticDataSource(**shaded).load_rgb('0001'))


def test_trainer_loss_decreases_on_cpu():
  source = tsynthetic.SyntheticDataSource(num_frames=4, image_size=24,
                                          gt_samples=64)
  model_cfg = dataclasses.replace(
      tconfig.nerf_ds(), num_coarse_samples=8, num_fine_samples=8,
      nerf_trunk_depth=3, nerf_trunk_width=48, se3_trunk_depth=2,
      se3_trunk_width=16, hyper_sheet_depth=2, hyper_sheet_width=16,
      mask_mlp_depth=2, mask_mlp_width=16, nerf_skips=(), se3_skips=(),
      hyper_sheet_skips=(), mask_skips=(), sigma_gradient_mode='fused',
      use_pallas_compositing=True)
  train_cfg = dataclasses.replace(
      tconfig.nerf_ds_train_config(max_steps=200, batch_size=128),
      warp_alpha_schedule=('linear', 0, 4, 50),
      sharp_mask_std_schedule=('constant', 0.5),
      x_for_rgb_alpha_schedule=('constant', 4.0),
      norm_input_alpha_schedule=('constant', 4.0),
      lr_schedule=('exponential', 5e-3, 1e-4, 200), print_every=1)
  trainer = Trainer.from_experiment(model_cfg, train_cfg, source,
                                    device='cpu')
  losses = []
  state = trainer.train(num_steps=40, log_fn=lambda step, log: losses.append(
      log['stats']['fine']['loss/rgb']))
  assert state.step == 40 and len(losses) == 40
  assert np.isfinite(losses).all()
  assert np.mean(losses[-8:]) < 0.9 * np.mean(losses[:8]), losses
  assert trainer.build_store() is trainer.build_store()


def test_mesh_and_host_sampling_train_and_unported_options_raise():
  source = tsynthetic.SyntheticDataSource(num_frames=4, image_size=8,
                                          gt_samples=8)
  model = torch_model()
  train_cfg = toy_train_cfg(tconfig)
  # The two options that once raised here build and step now.
  for kwargs in ({'use_mesh': True}, {'sampling': 'host'}):
    logged = []
    state = Trainer(model=model, train_cfg=train_cfg, datasource=source,
                    **kwargs).train(num_steps=1, log_fn=lambda step, log: (
                        logged.append(log['stats']['fine']['loss/total'])))
    assert state.step == 1 and np.isfinite(logged).all(), kwargs
  with pytest.raises(NotImplementedError):
    tsynthetic.SyntheticDataSource(num_frames=4, gt_backend='jax')
  # The model options that once raised here build now, and the bone
  # field's background term is |moving mask| at the points.
  torch_model(norm_type='layer')
  bone = torch_model(use_bone=True)
  loss = tlosses.compute_background_loss(
      bone, dict(bone.named_parameters()), torch.zeros(4, 3), {}, 0.0,
      generator=torch.Generator().manual_seed(0))
  assert loss.shape == (4, 1) and bool((loss >= 0).all())
