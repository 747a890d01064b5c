"""The deformation family's losses and training against the JAX package:
the elastic loss (five residuals, two reductions), the background loss,
one whole training step of BASELINE config[2] (hypernerf with the elastic,
background and hyper-reg losses) and of the dual-quaternion ``nerf_ds``
with the elastic loss, and ``Trainer`` runs with the background loss.

Random draws: the background loss's warp ids and jitter come from a JAX
key in the JAX package and from a ``torch.Generator`` in the port, which
never agree, so the parity tests replay JAX's draws (the same key, split
as its step splits it) and hand them to the port. Sampling is unstratified
with no σ noise, so the renders draw nothing.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfds_tpu import config as jconfig
from nerfds_tpu.models import NerfDSModel as JaxModel
from nerfds_tpu.models import default_extra_params as jax_extra
from nerfds_tpu.training import losses as jlosses
from nerfds_tpu.training import step as jstep
from nerfds_torch import config as tconfig
from nerfds_torch.convert import params_from_jax
from nerfds_torch.datasets import synthetic as tsynthetic
from nerfds_torch.models import NerfDSModel as TorchModel
from nerfds_torch.models import default_extra_params as torch_extra
from nerfds_torch.trainer import Trainer
from nerfds_torch.training import losses as tlosses
from nerfds_torch.training import step as tstep

torch.set_num_threads(1)

NUM_EMBEDS = 4
TOY = dict(num_coarse_samples=6, num_fine_samples=4, nerf_trunk_depth=3,
           nerf_trunk_width=32, nerf_skips=(2,), se3_trunk_depth=3,
           se3_trunk_width=16, se3_skips=(2,), hyper_sheet_depth=3,
           hyper_sheet_width=16, hyper_sheet_skips=(2,), mask_mlp_depth=3,
           mask_mlp_width=16, mask_skips=(2,), use_stratified_sampling=False)
# BASELINE config[2]'s losses, at the JAX package's own test of them
# (tests/test_training.py, test_background_and_elastic_losses_run).
CONFIG2_LOSSES = dict(use_elastic_loss=True, use_background_loss=True,
                      background_loss_weight=1.0, use_hyper_reg_loss=True,
                      hyper_reg_loss_weight=0.001)
# (preset, model overrides, train overrides, the port's own overrides):
# the dual-quaternion nerf_ds takes ∇σ by 'vmap' in JAX and by 'fused' (K1's
# plain versions on the CPU) in the port, the same numbers by two paths.
STEPS = {
    'config2_ds': ('hypernerf', {}, CONFIG2_LOSSES, {}),
    'nerf_ds_dual_quaternion': (
        'nerf_ds', dict(warp_field_type='dual_quaternion'),
        dict(use_elastic_loss=True), dict(sigma_gradient_mode='fused')),
}


def t(x):
  return torch.from_numpy(np.array(x))


def to_torch(tree):
  return {k: to_torch(v) if isinstance(v, dict) else t(v)
          for k, v in tree.items()}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
  return float((got - want).norm() / want.norm().clamp_min(1e-12))


def randn(seed, *shape, scale=1.0):
  return (np.random.RandomState(seed).randn(*shape) * scale).astype(
      np.float32)


# -- the elastic loss ---------------------------------------------------------


def jacobians(num_rays=6, num_samples=5):
  """Near-identity Jacobians, and two rows of scaled rotations whose three
  singular values are equal (1.3), where an SVD's vectors are not unique."""
  jac = np.eye(3, dtype=np.float32) + randn(0, num_rays, num_samples, 3, 3,
                                            scale=0.15)
  q, _ = np.linalg.qr(randn(1, 2, 3, 3))
  jac[0, :2] = 1.3 * q
  return jac


@pytest.mark.parametrize('reduce', ['weight', 'median'])
@pytest.mark.parametrize('loss_type',
                         ['log_svals', 'svals', 'div', 'det', 'log_det'])
def test_elastic_loss_matches_jax(loss_type, reduce):
  jac = jacobians()
  # log_det clamps det at 1e-6; the dets here lie far from it.
  assert np.linalg.det(jac).min() > 0.1
  rng = np.random.RandomState(2)
  out = {'rgb': rng.rand(6, 3).astype(np.float32),
         'weights': rng.rand(6, 5).astype(np.float32) / 5,
         'warp_jacobian': jac}
  batch = {'rgb': rng.rand(6, 3).astype(np.float32)}
  scalars = {'elastic_loss_weight': 0.01}
  overrides = dict(use_elastic_loss=True, elastic_loss_type=loss_type,
                   elastic_reduce_method=reduce)
  jcfg = dataclasses.replace(jconfig.TrainConfig(), **overrides)
  tcfg = dataclasses.replace(tconfig.TrainConfig(), **overrides)

  def jax_loss(j):
    loss, stats = jlosses.compute_loss_and_stats(
        jconfig.hypernerf(), jcfg, dict(out, warp_jacobian=j), batch, scalars,
        use_elastic_loss=True)
    return loss, stats

  (want_loss, want), want_grad = jax.jit(jax.value_and_grad(
      jax_loss, has_aux=True))(jnp.asarray(jac))
  j = t(jac).requires_grad_()
  got_loss, got = tlosses.compute_loss_and_stats(
      tconfig.hypernerf(), tcfg, dict(to_torch(out), warp_jacobian=j),
      to_torch(batch), scalars, use_elastic_loss=True)
  (got_grad,) = torch.autograd.grad(got_loss, j)
  assert set(got) == set(want)
  for k in ('loss/elastic', 'residual/elastic', 'loss/total'):
    np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                               rtol=1e-5,
                               atol=1e-9, err_msg=k)
  np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
  scale = np.abs(np.asarray(want_grad)).max()
  np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad),
                             rtol=1e-5, atol=1e-5 * scale)


def test_elastic_loss_gradient_at_repeated_singular_values():
  """At J = cR (R a rotation) the three singular values are equal, and an
  SVD's vectors are not unique; d/dJ Σ(sᵢ − 1)² = 2(c − 1)R all the same,
  and ``svdvals`` gives it."""
  q, _ = np.linalg.qr(randn(3, 4, 3, 3))
  jac = t(1.3 * q).requires_grad_()
  svals = torch.linalg.svdvals(jac)
  (grad,) = torch.autograd.grad(((svals - 1.0) ** 2).sum(), jac)
  np.testing.assert_allclose(grad.numpy(), 2 * 0.3 * q, rtol=1e-5,
                             atol=1e-6)
  with pytest.raises(NotImplementedError, match='elastic loss type'):
    tlosses.compute_elastic_loss(jac, loss_type='curl')


# -- the background loss -------------------------------------------------------


def toy_pair(preset, port=None, **overrides):
  kw = {**TOY, **overrides}
  jmodel = JaxModel(config=dataclasses.replace(getattr(jconfig, preset)(),
                                               **kw),
                    num_warp_embeds=NUM_EMBEDS, num_hyper_embeds=NUM_EMBEDS)
  params = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
  tmodel = TorchModel(dataclasses.replace(getattr(tconfig, preset)(),
                                          **{**kw, **(port or {})},
                                          use_pallas_compositing=True),
                      num_warp_embeds=NUM_EMBEDS, num_hyper_embeds=NUM_EMBEDS,
                      device='cpu')
  tmodel.load_state_dict(params_from_jax(params))
  return jmodel, params, tmodel


def jax_background_draws(key, num_points, noise_std):
  """The draws of JAX's compute_background_loss for ``key``."""
  metadata = jax.random.randint(key, (num_points, 1), 0, NUM_EMBEDS)
  noise = noise_std * jax.random.normal(key, (num_points, 3))
  return np.asarray(metadata), np.asarray(noise)


@pytest.mark.parametrize('preset', ['hypernerf', 'nerf_ds'])
def test_background_loss_matches_jax_with_the_same_draws(preset):
  """nerf_ds conditions its warp on the mask, which is 0 for background
  points. The heads are scaled so that the warp moves the points by about
  the loss's scale."""
  jmodel, params, tmodel = toy_pair(preset)
  for head in ('w', 'v'):
    params['warp_field'][head]['kernel'] = (
        params['warp_field'][head]['kernel'] * 30.0)
  tmodel.load_state_dict(params_from_jax(params))
  pts = randn(4, 40, 3, scale=0.5)
  key = jax.random.PRNGKey(5)
  extra = jax_extra(jmodel.config)

  def jax_loss(p):
    loss = jlosses.compute_background_loss(jmodel, params, key, p, extra,
                                           noise_std=0.01)
    return loss.mean(), loss

  (_, want), want_grad = jax.jit(jax.value_and_grad(
      jax_loss, has_aux=True))(jnp.asarray(pts))
  draws = tuple(map(t, jax_background_draws(key, 40, 0.01)))
  p = t(pts).requires_grad_()
  got = tlosses.compute_background_loss(
      tmodel, dict(tmodel.named_parameters()), p, torch_extra(tmodel.config),
      noise_std=0.01, draws=draws)
  (got_grad,) = torch.autograd.grad(got.mean(), p)
  assert got.shape == (40,) and float(got.max()) > 1e-4
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                             rtol=1e-5, atol=1e-9)
  scale = np.abs(np.asarray(want_grad)).max()
  np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad),
                             rtol=1e-5, atol=1e-5 * scale)
  # Without draws the generator draws ids over the embeddings.
  ids, noise = tlosses.draw_background(
      1000, NUM_EMBEDS, 0.01, torch.Generator().manual_seed(0), 'cpu')
  assert ids.shape == (1000, 1) and set(ids.unique().tolist()) == {0, 1, 2, 3}
  assert abs(float(noise.std()) - 0.01) < 1e-3


# -- one whole step --------------------------------------------------------------


def toy_train_cfg(config_lib, **overrides):
  """Schedules that sit mid-way at step 0."""
  return dataclasses.replace(
      config_lib.nerf_ds_train_config(max_steps=200, batch_size=8),
      warp_alpha_schedule=('linear', 1.5, 4, 50),
      norm_input_alpha_schedule=('constant', 2.5),
      sharp_mask_std_schedule=('constant', 0.5),
      lr_schedule=('exponential', 5e-3, 1e-4, 200), **overrides)


def toy_batch(n=8, num_points=24, seed=0):
  rng = np.random.RandomState(seed)
  directions = rng.randn(n, 3).astype(np.float32)
  directions /= np.linalg.norm(directions, axis=-1, keepdims=True)
  batch = {
      'origins': rng.randn(n, 3).astype(np.float32) * 0.1,
      'directions': directions,
      'rgb': rng.rand(n, 3).astype(np.float32),
      'mask': rng.rand(n, 1).astype(np.float32),
      'metadata': {'warp': rng.randint(0, NUM_EMBEDS, (n, 1)).astype(
          np.int32)},
  }
  if num_points:
    batch['background_points'] = rng.uniform(
        -0.9, 0.9, (num_points, 3)).astype(np.float32)
  return batch


@pytest.fixture(scope='module', params=sorted(STEPS))
def jax_step(request):
  """JAX: the gradients and stats of the loss, and the state after one
  ``make_train_step`` step, on one batch and key; the port's batch with
  JAX's background draws replayed."""
  preset, model_overrides, train_overrides, port = STEPS[request.param]
  jmodel, params, tmodel = toy_pair(preset, port, **model_overrides)
  # A mid-training warp: larger heads give the Jacobian and the background
  # points a motion the losses see.
  for head in ('w', 'v', 'q', 't'):
    if head in params['warp_field']:
      params['warp_field'][head]['kernel'] = (
          params['warp_field'][head]['kernel'] * 30.0)
  train_cfg = toy_train_cfg(jconfig, **train_overrides)
  batch = toy_batch(num_points=24 if train_cfg.use_background_loss else 0)
  key = jax.random.PRNGKey(1)
  jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
  scalars = jstep.eval_schedules(jstep.build_schedules(train_cfg), 0)
  loss_fn = jstep.make_loss_fn(jmodel, train_cfg)
  (_, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
      params, jbatch, key, scalars)
  step_fn = jstep.make_train_step(jmodel, train_cfg, donate=False)
  state1, _ = step_fn(jstep.TrainState.create(params), jbatch, key)
  port_batch = to_torch(batch)
  if train_cfg.use_background_loss:
    _, key_bg = jax.random.split(key)
    ids, noise = jax_background_draws(key_bg, 24,
                                      train_cfg.background_noise_std)
    port_batch.update(background_metadata=t(ids), background_noise=t(noise))
  return dict(name=request.param, tmodel=tmodel, params=params,
              train_overrides=train_overrides, port_batch=port_batch,
              grads=jax.device_get(grads), stats=jax.device_get(stats),
              state1=jax.device_get(state1))


def test_train_step_matches_jax(jax_step):
  tmodel = jax_step['tmodel']
  train_cfg = toy_train_cfg(tconfig, **jax_step['train_overrides'])
  params = params_from_jax(jax_step['params'])
  scalars = tstep.eval_schedules(tstep.build_schedules(train_cfg), 0)
  grads, stats = tstep._grads(tstep.make_loss_fn(tmodel, train_cfg), params,
                              jax_step['port_batch'], None, scalars)
  # Relative to each tensor's norm: float32 through two levels and the
  # second order through the Jacobian (and ∇σ for nerf_ds), summed in
  # another order by XLA and by torch.
  want = params_from_jax(jax_step['grads'])
  assert set(grads) == set(want)
  for name, w in want.items():
    assert rel_err(grads[name], w) < 1e-3, name
  assert float(grads['warp_field.trunk.hidden_0.kernel'].abs().max()) > 0
  want_stats = jax_step['stats']
  assert set(stats) == set(want_stats)
  for level in ('coarse', 'fine'):
    assert set(stats[level]) == set(want_stats[level])
    for k, w in want_stats[level].items():
      np.testing.assert_allclose(float(stats[level][k]), float(w),
                                 rtol=1e-4, atol=1e-6, err_msg=f'{level}/{k}')
  assert 'loss/elastic' in stats['coarse']
  # The new losses within 1e-5, beside the 1e-4 of every stat above. The
  # elastic loss reads log sᵢ with sᵢ = 1 + O(1e-2), whose float32 rounding
  # alone is 1e-5 of it (measured: the two packages 1.3e-5 and 2.7e-5 of it
  # apart), so the bound is absolute.
  named = [('coarse', 'loss/elastic'), ('coarse', 'residual/elastic')]
  if jax_step['name'] == 'config2_ds':
    named += [('coarse', 'loss/hyper_reg'), (None, 'loss/background')]
  for level, k in named:
    got = stats[level][k] if level else stats[k]
    w = want_stats[level][k] if level else want_stats[k]
    np.testing.assert_allclose(float(got), float(w), rtol=0, atol=1e-5,
                               err_msg=k)
  # One step of the port's make_train_step against JAX's from the same
  # params: the Adam moments at the grads' tolerance; the params at 1e-4
  # where |g| > 1e-6. Adam's first update is g / (|g| + 1e-8), so where |g|
  # is near 1e-8 (here 1e-7 of the tensor's norm) a rounding of g moves the
  # update by O(1): such an element must still move by no more than lr.
  state0 = tstep.TrainState.create(params)
  state1, _ = tstep.make_train_step(tmodel, train_cfg)(
      state0, jax_step['port_batch'])
  want_state = jax_step['state1']
  for got_tree, want_tree in ((state1.opt_state.mu, want_state.opt_state.mu),
                              (state1.opt_state.nu, want_state.opt_state.nu)):
    for name, w in params_from_jax(want_tree).items():
      assert rel_err(got_tree[name], w) < 1e-3, name
  for name, w in params_from_jax(want_state.params).items():
    conditioned = want[name].abs() > 1e-6
    diff = (state1.params[name] - w).abs()
    assert float(torch.where(conditioned, diff, 0.0).max()) < 1e-4, name
    assert float((state1.params[name] - state0.params[name]).abs().max()
                 ) <= 5e-3 * (1 + 1e-6), name


# -- Trainer runs with the background loss ---------------------------------------


def tiny_source():
  return tsynthetic.SyntheticDataSource(num_frames=4, image_size=8,
                                        gt_samples=8)


def config2_trainer(exp_dir=None, source=None, **train_overrides):
  model_cfg = dataclasses.replace(tconfig.hypernerf(), **TOY,
                                  use_pallas_compositing=True)
  train_cfg = toy_train_cfg(tconfig, save_every=2, print_every=1,
                            background_points_batch_size=64,
                            **{**CONFIG2_LOSSES, **train_overrides})
  return Trainer.from_experiment(model_cfg, train_cfg, source or tiny_source(),
                                 exp_dir=exp_dir, device='cpu')


def test_resume_with_the_background_loss_matches_an_unbroken_run(tmp_path):
  """4 steps straight against 2, a checkpoint and 2 more in a new trainer:
  the same parameters, bit for bit, with the background points drawn on
  the device each step."""
  logs = []
  straight = config2_trainer().train(
      num_steps=4, log_fn=lambda step, log: logs.append(log['stats']))
  assert all(np.isfinite(s['loss/background']) for s in logs)
  assert all(np.isfinite(s['coarse']['loss/elastic']) for s in logs)
  assert config2_trainer(tmp_path).train(num_steps=2).step == 2
  resumed = config2_trainer(tmp_path).train(num_steps=4)
  assert resumed.step == straight.step == 4
  for name, w in straight.params.items():
    assert torch.equal(resumed.params[name], w), name
  for name, w in straight.opt_state.nu.items():
    assert torch.equal(resumed.opt_state.nu[name], w), name


def test_background_points_on_the_device_and_their_batch():
  trainer = config2_trainer()
  pts = trainer.background_points()
  assert pts is trainer.background_points()  # loaded once
  assert pts.shape[-1] == 3 and 64 < pts.shape[0] <= 2048
  # Rounded down to a multiple of accum_steps; none left raises.
  cfg = dataclasses.replace(trainer.train_cfg, accum_steps=2,
                            background_points_batch_size=1)
  with pytest.raises(ValueError, match='leave no point'):
    tstep.make_fused_train_step(trainer.model, cfg, trainer.build_store(),
                                pts)
  cfg = dataclasses.replace(cfg, background_points_batch_size=3)
  state = tstep.TrainState.create(dict(trainer.model.named_parameters()))
  new, stats = tstep.make_fused_train_step(
      trainer.model, cfg, trainer.build_store(), pts)(
          state, torch.Generator().manual_seed(0))
  assert new.step == 1 and np.isfinite(float(stats['loss/background']))


def test_a_source_without_points_trains_without_the_background_loss():
  class NoPoints(tsynthetic.SyntheticDataSource):
    def load_points(self, shuffle=False):
      return None

  source = NoPoints(num_frames=4, image_size=8, gt_samples=8)
  trainer = config2_trainer(source=source)
  assert trainer.background_points() is None
  logs = []
  trainer.train(num_steps=1, log_fn=lambda step, log: logs.append(
      log['stats']))
  assert 'loss/background' not in logs[0]
  assert np.isfinite(logs[0]['coarse']['loss/elastic'])

