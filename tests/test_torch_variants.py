"""The model variants outside ``nerf_ds()`` of the port against the JAX
package: the ``vanilla_nerf`` preset (BASELINE config[0]),
``concat_dense_inputs``, the appearance embedding as an rgb and an alpha
condition, the hidden norms, and ``remat_sigma`` / ``remat_feat``.

Inputs come from numpy seeds, weights from the JAX init through
``params_from_jax``; float32 on both sides. Sampling is unstratified with
no σ noise, so neither side draws random numbers. Where JAX runs
``sigma_gradient_mode='fused'`` its trunk kernel runs in Pallas interpret
mode on the CPU; the port's 'fused' takes K1's plain versions on CPU
tensors, and ``use_pallas_compositing`` K2's. JAX renders and steps are
cached a configuration at a time, so each compiles once.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfds_tpu import config as jconfig
from nerfds_tpu.models import NerfDSModel as JaxModel
from nerfds_tpu.models import default_extra_params as jax_extra
from nerfds_tpu.models import mlp as jmlp
from nerfds_tpu.training import step as jstep
from nerfds_torch import config as tconfig
from nerfds_torch.convert import params_from_jax, params_to_jax
from nerfds_torch.evaluation import render as trender
from nerfds_torch.kernels import fused_mlp
from nerfds_torch.models import NerfDSModel as TorchModel
from nerfds_torch.models import default_extra_params as torch_extra
from nerfds_torch.models import mlp as tmlp
from nerfds_torch.training import step as tstep

torch.set_num_threads(1)

NUM_EMBEDS = 4
TOY = dict(num_coarse_samples=6, num_fine_samples=4, nerf_trunk_depth=3,
           nerf_trunk_width=32, nerf_skips=(2,), se3_trunk_depth=3,
           se3_trunk_width=16, se3_skips=(2,), hyper_sheet_depth=3,
           hyper_sheet_width=16, hyper_sheet_skips=(2,), mask_mlp_depth=3,
           mask_mlp_width=16, mask_skips=(2,), use_stratified_sampling=False)
EMBED_RGB = dict(use_nerf_embed=True, use_rgb_condition=True)
# name -> (preset, flags)
CONFIGS = {
    'plain': ('nerf_ds', {}),
    # BASELINE config[0] as shipped (coarse only), and with a fine level.
    'vanilla_nerf': ('vanilla_nerf', {'num_fine_samples': 0}),
    'vanilla_nerf_fine': ('vanilla_nerf', {}),
    'concat': ('nerf_ds', dict(concat_dense_inputs=True)),
    'embed_rgb': ('nerf_ds', EMBED_RGB),
    'embed_alpha': ('nerf_ds', dict(**EMBED_RGB, use_alpha_condition=True)),
    'norm_layer': ('nerf_ds', dict(norm_type='layer')),
    # 128 channels in 32 groups of 4 (32 in 32 would give 0; in groups of
    # 2 a near-zero variance multiplies float32 rounding by up to 1e3).
    'norm_group': ('nerf_ds', dict(norm_type='group', nerf_trunk_width=128)),
    'norm_batch': ('nerf_ds', dict(norm_type='batch')),
    'remat_sigma_nothing': ('nerf_ds', dict(remat_sigma=True)),
    'remat_sigma_dots': ('nerf_ds', dict(remat_sigma=True,
                                         remat_policy='dots')),
    'remat_feat': ('nerf_ds', dict(remat_feat=True)),
    # The bench's reference execution pattern (bench.py:27-32).
    'naive_concat': ('nerf_ds', dict(sigma_gradient_mode='naive',
                                     concat_dense_inputs=True)),
}
ATOL, RTOL = 1e-5, 1e-4
TOLERANCE = {
    # As in test_torch_radiance: the normal head's raw outputs are O(10) at
    # init, and normalize(∇σ) amplifies rounding where |∇σ| is small.
    'predicted_norm': (1e-4, 1e-4),
    'back_facing': (1e-4, 1e-4),
    'target_norm': (1e-3, 1e-3),
    'norm_input': (1e-4, 1e-3),
}


def t(x):
  return torch.from_numpy(np.array(x))


def to_torch(tree):
  return {k: to_torch(v) if isinstance(v, dict) else t(v)
          for k, v in tree.items()}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
  return float((got - want).norm() / want.norm().clamp_min(1e-12))


def make_rays(num_rays, seed=0):
  rng = np.random.RandomState(seed)
  directions = rng.randn(num_rays, 3).astype(np.float32)
  directions /= np.linalg.norm(directions, axis=-1, keepdims=True)
  return {
      'origins': rng.randn(num_rays, 3).astype(np.float32) * 0.1,
      'directions': directions,
      'metadata': {
          'warp': rng.randint(0, NUM_EMBEDS, (num_rays, 1)).astype(np.int32),
          'appearance': rng.randint(0, NUM_EMBEDS,
                                    (num_rays, 1)).astype(np.int32)},
      'mask': rng.rand(num_rays, 1).astype(np.float32),
  }


def config(lib, name, **extra):
  preset, flags = CONFIGS[name]
  return dataclasses.replace(getattr(lib, preset)(),
                             **{**TOY, **flags, **extra})


def jax_model(name, **extra):
  return JaxModel(config=config(jconfig, name, **extra),
                  num_warp_embeds=NUM_EMBEDS, num_hyper_embeds=NUM_EMBEDS,
                  num_nerf_embeds=NUM_EMBEDS)


def torch_model(name, **extra):
  return TorchModel(config(tconfig, name, **extra,
                           use_pallas_compositing=True),
                    num_warp_embeds=NUM_EMBEDS, num_hyper_embeds=NUM_EMBEDS,
                    num_nerf_embeds=NUM_EMBEDS, device='cpu')


@functools.lru_cache(maxsize=None)
def jax_init(name):
  """The JAX model's init params, once per configuration. The warp heads
  are scaled so that the motion is far from the identity, and the
  appearance embedding so that it moves the colour and σ."""
  params = jax.device_get(jax.jit(jax_model(name).init)(
      jax.random.PRNGKey(0)))
  if 'warp_field' in params:
    for head in ('w', 'v'):
      params['warp_field'][head]['kernel'] = (
          params['warp_field'][head]['kernel'] * 30.0)
  if 'nerf_embed' in params:
    params['nerf_embed']['embedding'] = params['nerf_embed']['embedding'] * 40
  if name == 'norm_batch':
    # Per-point statistics zero the trunk in 'vmap' (see
    # test_batch_norm_in_vmap_sees_one_point), so the predicted normal is
    # the head's bias, and ∇σ is 0: at the init's zero bias the normal
    # loss differentiates ‖0‖, NaN in JAX and 0 in torch. A nonzero bias.
    for level in params['nerf'].values():
      bias = np.array(level['alpha']['logit']['bias'])
      bias[1:4] = [0.3, -0.2, 0.5]
      level['alpha']['logit']['bias'] = bias
  return params


def port(name, mode):
  tmodel = torch_model(name, sigma_gradient_mode=mode)
  tmodel.load_state_dict(params_from_jax(jax_init(name)))
  return tmodel


@functools.lru_cache(maxsize=None)
def jax_render(name, mode):
  """JAX's render of ``make_rays(8)`` in ``mode``, every key of both
  levels, with the points."""
  jmodel = jax_model(name, sigma_gradient_mode=mode)
  rays = jax.tree_util.tree_map(jnp.asarray, make_rays(8))
  render = jax.jit(lambda p, r: jmodel.render(
      p, r, jax.random.PRNGKey(1), jax_extra(jmodel.config),
      return_full=True, return_points=True))
  return jax.device_get(render(jax_init(name), rays))


def port_render(name, mode, grad=False):
  tmodel = port(name, mode)
  with torch.set_grad_enabled(grad):
    return tmodel.render(to_torch(make_rays(8)), torch_extra(tmodel.config),
                         return_full=True, return_points=True)


def assert_render_close(got, want, level, label):
  got, want = got[level], want[level]
  assert set(got) == set(want), label
  for k in sorted(want):
    atol, rtol = TOLERANCE.get(k, (ATOL, RTOL))
    np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]),
                               atol=atol, rtol=rtol,
                               err_msg=f'{label}/{level}/{k}')


# -- the MLP's hidden norm and concatenated inputs ----------------------------


@pytest.mark.parametrize('norm', ['layer', 'group', 'batch'])
def test_apply_norm_matches_jax(norm):
  x = np.random.RandomState(0).randn(7, 64).astype(np.float32) * 3 + 1
  want = jmlp.apply_norm(jnp.asarray(x), norm)
  got = tmlp.apply_norm(t(x), norm)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                             rtol=1e-5)


@pytest.mark.parametrize('norm', [None, 'layer', 'batch'])
def test_mlp_concat_input_and_hidden_norm_match_jax(norm):
  """Two input blocks, a skip, a hidden norm: the materialised concat of
  ``concat_input`` against JAX's, and against the port's split form (the
  same numbers up to the order of summation)."""
  kw = dict(depth=3, width=16, skips=(2,), output_channels=4,
            hidden_norm=norm)
  jm = jmlp.MLP(**kw, concat_input=True)
  params = jax.device_get(jm.init(jax.random.PRNGKey(3), 13))
  rng = np.random.RandomState(1)
  a, b = rng.randn(9, 8).astype(np.float32), rng.randn(9, 5).astype(
      np.float32)
  want = jm.apply(params, [jnp.asarray(a), jnp.asarray(b)])
  for concat in (True, False):
    tm = tmlp.MLP(13, 3, 16, (2,), output_channels=4, hidden_norm=norm,
                  concat_input=concat)
    tm.load_state_dict(params_from_jax(params))
    got = tm([t(a), t(b)])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-4, err_msg=str(concat))


def test_pointwise_batch_norm_is_zero_with_zero_gradient():
  """A batch of one point: its 'batch' statistics are its own, so the
  norm's output and its derivative are 0, as under JAX's vmap."""
  x = t(np.random.RandomState(2).randn(5, 8).astype(np.float32))
  x.requires_grad_()
  y = tmlp.apply_norm(x, 'batch', pointwise=True)
  assert float(y.detach().abs().max()) == 0.0
  (g,) = torch.autograd.grad((y * 3).sum(), x)
  assert float(g.abs().max()) == 0.0
  want = jax.vmap(lambda r: jmlp.apply_norm(r[None], 'batch')[0])(
      jnp.asarray(x.detach().numpy()))
  np.testing.assert_array_equal(np.asarray(want), y.detach().numpy())


def test_fused_apply_refuses_a_hidden_norm():
  mlp = tmlp.MLP(6, 2, 8, hidden_norm='layer', output_channels=2)
  with pytest.raises(ValueError, match='hidden norm'):
    fused_mlp.fused_apply(mlp, None, torch.zeros(3, 6))


# -- the param trees ------------------------------------------------------------


@pytest.mark.parametrize('name', ['vanilla_nerf', 'embed_rgb', 'embed_alpha',
                                  'concat', 'norm_group'])
def test_init_matches_param_tree_and_round_trips(name):
  """The port's init has JAX's param tree and shapes (the appearance
  table, the α head widened by the alpha condition, the rgb branch by the
  rgb condition), and the tree converts both ways bit for bit."""
  params = jax_init(name)
  fresh = params_to_jax(torch_model(name).state_dict())
  jflat = jax.tree_util.tree_flatten_with_path(params)[0]
  tflat = jax.tree_util.tree_flatten_with_path(fresh)[0]
  assert [p for p, _ in jflat] == [p for p, _ in tflat]
  for (path, a), (_, b) in zip(jflat, tflat):
    assert a.shape == b.shape, path
  assert ('nerf_embed' in fresh) == ('embed' in name)
  back = params_to_jax(params_from_jax(params))
  jax.tree_util.tree_map(np.testing.assert_array_equal, params, back)


# -- both render levels ----------------------------------------------------------

# (configuration, the port's mode, JAX's mode). Under an alpha condition both
# packages take 'vmap' for 'fused'; under a hidden norm the port does, and
# JAX's 'fused' drops the norm (test_jax_fused_drops_the_trunk_norm).
RENDERS = [
    ('vanilla_nerf', 'vmap', 'vmap'),
    ('vanilla_nerf_fine', 'fused', 'fused'),
    ('concat', 'vmap', 'vmap'),
    ('embed_rgb', 'fused', 'fused'),
    ('embed_alpha', 'fused', 'fused'),
    ('embed_alpha', 'jvp', 'jvp'),
    ('norm_layer', 'fused', 'vmap'),
    ('norm_group', 'naive', 'naive'),
    ('norm_batch', 'vmap', 'vmap'),
    ('norm_batch', 'vjp', 'vjp'),
    ('naive_concat', 'naive', 'naive'),
]


@pytest.fixture(scope='module', params=RENDERS,
                ids=lambda p: '-'.join(p[:2]))
def renders(request):
  name, mode, jmode = request.param
  return f'{name}-{mode}', jax_render(name, jmode), port_render(name, mode)


@pytest.mark.parametrize('level', ['coarse', 'fine'])
def test_render_matches_jax_on_every_key(renders, level):
  label, want, got = renders
  if level not in want:  # vanilla_nerf as shipped has no fine level
    assert level not in got and label.startswith('vanilla_nerf-')
    return
  assert_render_close(got, want, level, label)


def test_jax_fused_drops_the_trunk_norm():
  """The known deviation: JAX's 'fused' runs the trunk kernel without the
  hidden norm (its TrunkSpec has none), so its σ is the σ of the same
  weights without a norm, far from its own 'vmap''s; the port's 'fused'
  takes 'vmap' (its render is held above)."""
  fused = jax_render('norm_layer', 'fused')['coarse']['sigma']
  vmap = jax_render('norm_layer', 'vmap')['coarse']['sigma']
  jmodel = jax_model('plain')
  no_norm = jax.device_get(jax.jit(lambda p, r: jmodel.render(
      p, r, jax.random.PRNGKey(1), jax_extra(jmodel.config)))(
          jax_init('norm_layer'),
          jax.tree_util.tree_map(jnp.asarray, make_rays(8))))
  np.testing.assert_allclose(fused, no_norm['coarse']['sigma'], rtol=1e-4,
                             atol=1e-5)
  assert np.abs(fused - vmap).max() > 1e-2 * np.abs(vmap).max()
  got = port_render('norm_layer', 'fused')['coarse']['sigma']
  np.testing.assert_allclose(got.numpy(), vmap, atol=ATOL, rtol=RTOL)


def test_batch_norm_in_vmap_sees_one_point():
  """What JAX computes under ``norm_type='batch'``: its 'vmap' takes σ and
  ∇σ by ``vmap(value_and_grad)`` of single points, whose batch statistics
  zero every trunk layer, so σ is one value at every sample and ∇σ is 0;
  its 'vjp' takes the whole batch's statistics. The port gives both (the
  renders are held above)."""
  for mode in ('vmap', 'vjp'):
    want = jax_render('norm_batch', mode)['fine']
    got = port_render('norm_batch', mode)['fine']
    spread = np.ptp(np.asarray(want['sigma']))
    if mode == 'vmap':
      assert spread == 0.0
      assert float(np.abs(want['target_norm']).max()) == 0.0
      assert float(got['target_norm'].abs().max()) == 0.0
      assert float(np.ptp(got['sigma'].numpy())) == 0.0
    else:
      assert spread > 1e-3


def test_chunked_render_of_the_appearance_embedding_matches_jax():
  """The chunked renderer encodes the appearance embedding once an image
  (``encoded_nerf``); its padded chunks agree with JAX's render of the
  same rays."""
  rays = make_rays(10, seed=6)
  rays['metadata']['warp'][:] = 2
  rays['metadata']['appearance'][:] = 3
  jmodel = jax_model('embed_alpha', sigma_gradient_mode='vmap')
  want = jax.device_get(jax.jit(lambda p, r: jmodel.render(
      p, r, jax.random.PRNGKey(1), jax_extra(jmodel.config),
      return_full=True, compute_sigma_gradient=False))(
          jax_init('embed_alpha'),
          jax.tree_util.tree_map(jnp.asarray, rays)))['fine']
  tmodel = port('embed_alpha', 'fused')
  image = {k: v.reshape(2, 5, -1) for k, v in rays.items() if k != 'metadata'}
  image['metadata'] = {k: v.reshape(2, 5, 1)
                       for k, v in rays['metadata'].items()}
  got = trender.render_image(tmodel, image, torch_extra(tmodel.config),
                             chunk=4)
  assert set(got) == set(trender.DEFAULT_KEYS)
  for k, v in got.items():
    np.testing.assert_allclose(v.reshape(10, -1),
                               np.asarray(want[k]).reshape(10, -1),
                               atol=ATOL, rtol=RTOL, err_msg=k)


# -- one training step ------------------------------------------------------------


def toy_train_cfg(config_lib):
  """Schedules that sit mid-way at step 0."""
  return dataclasses.replace(
      config_lib.nerf_ds_train_config(max_steps=200, batch_size=8),
      warp_alpha_schedule=('linear', 1.5, 4, 50),
      norm_input_alpha_schedule=('constant', 2.5),
      sharp_mask_std_schedule=('constant', 0.5),
      lr_schedule=('exponential', 5e-3, 1e-4, 200))


def toy_batch(n=8, seed=0):
  batch = make_rays(n, seed)
  batch['rgb'] = np.random.RandomState(seed + 7).rand(n, 3).astype(
      np.float32)
  return batch


@functools.lru_cache(maxsize=None)
def jax_step(name):
  """JAX's state and stats after one ``make_train_step`` step of ``name``
  from its init on ``toy_batch()``: in the configuration's own ∇σ mode
  where it names one, else 'vmap'."""
  mode = CONFIGS[name][1].get('sigma_gradient_mode', 'vmap')
  step_fn = jstep.make_train_step(
      jax_model(name, sigma_gradient_mode=mode), toy_train_cfg(jconfig),
      donate=False)
  return jax.device_get(step_fn(
      jstep.TrainState.create(jax_init(name)),
      jax.tree_util.tree_map(jnp.asarray, toy_batch()),
      jax.random.PRNGKey(1)))


# configuration -> (the port's mode, JAX's configuration). remat changes
# no number, so JAX's step without it is the reference (the remat tests
# below hold the port's remat to its run without remat within 1e-6).
STEPS = {
    'vanilla_nerf_fine': ('fused', 'vanilla_nerf_fine'),
    'concat': ('fused', 'concat'),
    'embed_rgb': ('fused', 'embed_rgb'),
    'embed_alpha': ('fused', 'embed_alpha'),
    'norm_layer': ('fused', 'norm_layer'),
    'norm_group': ('vmap', 'norm_group'),
    'norm_batch': ('vmap', 'norm_batch'),
    'remat_sigma_dots': ('vmap', 'plain'),
    'remat_sigma_nothing': ('naive', 'plain'),
    'remat_feat': ('fused', 'plain'),
    'naive_concat': ('naive', 'naive_concat'),
}


@pytest.mark.parametrize('name', sorted(STEPS))
def test_train_step_matches_jax(name):
  """One ``make_train_step`` step against JAX's from the same params and
  batch: Adam's first moment (0.1 of the gradient) within 1e-3 of each
  tensor's norm, the second moment, the params where the gradient is not
  near 0, and the stats."""
  tmode, jname = STEPS[name]
  tmodel = port(name, tmode)
  params = jax_init(jname)
  tmodel.load_state_dict(params_from_jax(params))
  batch = toy_batch()
  tcfg = toy_train_cfg(tconfig)
  want_state, want_stats = jax_step(jname)
  state1, stats = tstep.make_train_step(tmodel, tcfg)(
      tstep.TrainState.create(params_from_jax(params)), to_torch(batch))
  want_mu = params_from_jax(want_state.opt_state.mu)
  assert set(state1.opt_state.mu) == set(want_mu)
  for k, w in want_mu.items():
    if float(w.norm()) < 1e-8:
      # A gradient that is 0 but for rounding: the bottleneck's under a
      # 'batch' rgb norm, which no constant shift of its input moves.
      assert float(state1.opt_state.mu[k].norm()) < 1e-8, k
    else:
      assert rel_err(state1.opt_state.mu[k], w) < 1e-3, k
  for k, w in params_from_jax(want_state.params).items():
    conditioned = want_mu[k].abs() > 1e-7
    diff = (state1.params[k] - w).abs()
    assert float(torch.where(conditioned, diff, 0.0).max()) < 1e-4, k
  for level in want_stats:
    if not isinstance(want_stats[level], dict):
      continue
    assert set(stats[level]) == set(want_stats[level])
    for k, w in want_stats[level].items():
      np.testing.assert_allclose(float(stats[level][k]), float(w),
                                 rtol=1e-4, atol=1e-6, err_msg=f'{level}/{k}')
  mu = state1.opt_state.mu
  if 'embed' in name:  # the loss reaches the appearance table
    assert float(mu['nerf_embed.embedding'].abs().max()) > 0
  if name == 'norm_batch':  # JAX's per-point statistics zero the trunk
    assert float(mu['nerf.fine.trunk.hidden_0.kernel'].abs().max()) == 0


# -- remat: the gradients of the run without it ------------------------------------


def port_grads(name, mode, **extra):
  tmodel = torch_model(name, sigma_gradient_mode=mode, **extra)
  params = params_from_jax(jax_init('plain'))
  tcfg = toy_train_cfg(tconfig)
  scalars = tstep.eval_schedules(tstep.build_schedules(tcfg), 0)
  grads, _ = tstep._grads(tstep.make_loss_fn(tmodel, tcfg), params,
                          to_torch(toy_batch(seed=3)), None, scalars)
  return grads


@pytest.mark.parametrize('flags', [
    dict(remat_sigma=True, remat_policy='nothing'),
    dict(remat_sigma=True, remat_policy='dots'),
    dict(remat_feat=True),
    dict(remat_sigma=True, remat_feat=True, remat_policy='dots'),
], ids=['sigma_nothing', 'sigma_dots', 'feat', 'both'])
@pytest.mark.parametrize('mode', ['vmap', 'jvp', 'naive', 'fused'])
def test_remat_grads_equal_the_run_without_it(mode, flags):
  """Recomputing the σ path (or its feature part) in the backward, the
  second order included, gives the gradients of the run without remat
  within 1e-6 of each tensor's norm ('fused' runs ``remat_feat`` only:
  its trunk is the kernel)."""
  want = port_grads('plain', mode)
  got = port_grads('plain', mode, **flags)
  assert set(got) == set(want)
  for k, w in want.items():
    if float(w.norm()) == 0:
      assert float(got[k].norm()) == 0, k
    else:
      assert rel_err(got[k], w) < 1e-6, k


def test_remat_keeps_the_sigma_gradient():
  """∇σ (the normal target) and every output under remat equal the run
  without it, with grad mode on (remat acts only there)."""
  for name, mode in (('remat_sigma_dots', 'vmap'), ('remat_feat', 'fused'),
                     ('remat_sigma_nothing', 'jvp')):
    want = port_render('plain', mode, grad=True)
    tmodel = torch_model(name, sigma_gradient_mode=mode)
    tmodel.load_state_dict(params_from_jax(jax_init('plain')))
    got = tmodel.render(to_torch(make_rays(8)), torch_extra(tmodel.config),
                        return_full=True, return_points=True)
    for level in ('coarse', 'fine'):
      for k, w in want[level].items():
        np.testing.assert_allclose(got[level][k].detach().numpy(),
                                   w.detach().numpy(), atol=1e-6, rtol=1e-5,
                                   err_msg=f'{name}/{level}/{k}')


def test_unknown_remat_policy_and_norm_raise():
  with pytest.raises(ValueError, match='remat_policy'):
    torch_model('remat_sigma_nothing', remat_policy='everything')
  with pytest.raises(ValueError, match='norm type'):
    torch_model('plain', norm_type='instance')
