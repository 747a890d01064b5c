"""The radiance branch's variants of the port against the JAX package: ∇σ
as the colour's normal, the reflected view direction, the hyper-c sheet,
the screw-axis, window, Δx, hyper and mask rgb conditions, the mask flags,
each normal supervision type, the ``hyper_point`` override and the ∇σ
modes 'jvp', 'vjp' and 'naive'.

Inputs come from numpy seeds, weights from the JAX init through
``params_from_jax``; float32 on both sides. Sampling is unstratified with
no σ noise, so neither side draws random numbers. Where JAX runs
``sigma_gradient_mode='fused'`` its trunk kernel runs in Pallas interpret
mode on the CPU; the port's 'fused' takes K1's plain versions on CPU
tensors, and ``use_pallas_compositing`` K2's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from nerfds_tpu import config as jconfig
from nerfds_tpu.models import NerfDSModel as JaxModel
from nerfds_tpu.models import default_extra_params as jax_extra
from nerfds_tpu.models import hyper as jhyper
from nerfds_tpu.ops import math as jmath
from nerfds_tpu.training import step as jstep
from nerfds_torch import config as tconfig
from nerfds_torch.convert import params_from_jax, params_to_jax
from nerfds_torch.evaluation import render as trender
from nerfds_torch.models import NerfDSModel as TorchModel
from nerfds_torch.models import default_extra_params as torch_extra
from nerfds_torch.models import hyper as thyper
from nerfds_torch.ops import math as tmath
from nerfds_torch.training import step as tstep

torch.set_num_threads(1)

NUM_EMBEDS = 4
TOY = dict(num_coarse_samples=6, num_fine_samples=4, nerf_trunk_depth=3,
           nerf_trunk_width=32, nerf_skips=(2,), se3_trunk_depth=3,
           se3_trunk_width=16, se3_skips=(2,), hyper_sheet_depth=3,
           hyper_sheet_width=16, hyper_sheet_skips=(2,), mask_mlp_depth=3,
           mask_mlp_width=16, mask_skips=(2,), use_stratified_sampling=False)

# The three configurations that carry the slice.
SIGMA_NORMALS = dict(predict_norm=False, use_predicted_norm=False,
                     use_sigma_gradient=True, stop_norm_gradient=False,
                     use_ref_radiance=True)
HYPER_C_CANONICAL = dict(use_hyper_c=True, hyper_c_hyper_input=True,
                         use_ref_radiance=True,
                         norm_supervision_type='canonical')
DIRECT_CONDITIONS = dict(
    norm_supervision_type='direct', screw_input_mode='full',
    window_x_in_rgb_condition=True, use_delta_x_in_rgb_condition=True,
    use_hyper_for_rgb=True, use_mask_in_rgb=True,
    use_coarse_depth_for_mask=True, clamp_predicted_mask=True,
    use_mask_sharp_weights=False, use_mask_scaled_weights=True)
# Each flag family of the radiance branch, on nerf_ds().
CONFIGS = {
    'sigma_normals': SIGMA_NORMALS,
    # ∇σ as the colour's normal beside a supervised predicted normal, the
    # ∇σ input stop-gradiented.
    'sigma_normals_predicted': dict(use_sigma_gradient=True,
                                    use_predicted_norm=False),
    'hyper_c_canonical': HYPER_C_CANONICAL,
    # Hyper-c over the observation points without its embedding, and
    # without the reflection.
    'hyper_c_plain': dict(use_hyper_c=True, use_hyper_c_embed=False),
    'direct_conditions': DIRECT_CONDITIONS,
    'canonical_unwarped': dict(norm_supervision_type='canonical_unwarped',
                               use_ref_radiance=True),
    'screw_rotation': dict(screw_input_mode='rotation'),
    # The mask rgb condition's 2D-mask branch, with the sharp weights.
    'mask_in_rgb_2d': dict(use_mask_in_rgb=True, use_3d_mask=False),
}
MODES = ('vmap', 'fused')
ATOL, RTOL = 1e-5, 1e-4
TOLERANCE = {
    # As in test_torch_render and test_torch_deformation: the normal head's
    # raw outputs are O(10) at init, and normalize(∇σ) amplifies rounding
    # where |∇σ| is small (here one coarse sample of 144, 9e-5 apart).
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


def randn(seed, *shape, scale=1.0):
  return (np.random.RandomState(seed).randn(*shape) * scale).astype(
      np.float32)


def make_rays(num_rays, seed=0):
  rng = np.random.RandomState(seed)
  directions = rng.randn(num_rays, 3).astype(np.float32)
  directions /= np.linalg.norm(directions, axis=-1, keepdims=True)
  return {
      'origins': rng.randn(num_rays, 3).astype(np.float32) * 0.1,
      'directions': directions,
      'metadata': {'warp': rng.randint(0, NUM_EMBEDS, (num_rays, 1)).astype(
          np.int32)},
      'mask': rng.rand(num_rays, 1).astype(np.float32),
  }


@functools.lru_cache(maxsize=None)
def jax_init(name):
  """The JAX model's init params, once per configuration. The warp heads
  are scaled so that the motion is far from the identity, and the normal
  transport, the screw axis and Δx see it."""
  jmodel = JaxModel(config=dataclasses.replace(
      jconfig.nerf_ds(), **{**TOY, **CONFIGS[name]}),
                    num_warp_embeds=NUM_EMBEDS, num_hyper_embeds=NUM_EMBEDS)
  params = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
  for head in ('w', 'v'):
    params['warp_field'][head]['kernel'] = (
        params['warp_field'][head]['kernel'] * 30.0)
  return params


def model_pair(name, mode, **extra):
  kw = {**TOY, **CONFIGS[name], 'sigma_gradient_mode': mode, **extra}
  jmodel = JaxModel(config=dataclasses.replace(jconfig.nerf_ds(), **kw),
                    num_warp_embeds=NUM_EMBEDS, num_hyper_embeds=NUM_EMBEDS)
  tmodel = TorchModel(dataclasses.replace(tconfig.nerf_ds(), **kw,
                                          use_pallas_compositing=True),
                      num_warp_embeds=NUM_EMBEDS, num_hyper_embeds=NUM_EMBEDS,
                      device='cpu')
  params = jax_init(name)
  tmodel.load_state_dict(params_from_jax(params))
  return jmodel, params, tmodel


def jax_render(jmodel, params, rays, **kw):
  render = jax.jit(lambda p, r: jmodel.render(
      p, r, jax.random.PRNGKey(1), jax_extra(jmodel.config), **kw))
  return jax.device_get(render(params, jax.tree_util.tree_map(jnp.asarray,
                                                              rays)))


# -- L0 and L3: reflect, the safe norm's forward rule, the hyper-c sheet ------


def test_reflect_matches_jax():
  d, n = randn(0, 7, 3), randn(1, 7, 3, scale=3.0)
  want = jmath.reflect(jnp.asarray(d), jnp.asarray(n))
  got = tmath.reflect(t(d), t(n))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                             rtol=1e-6)
  # A reflection keeps the length of the (normalised) direction.
  np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                             rtol=1e-6)


def test_safe_norm_forward_rule_is_differentiable():
  """The forward-mode tangent of ``safe_norm`` is the directional
  derivative, 0 below ``tol``, and a reverse pass through it (reverse over
  forward) gives the same second derivative as reverse over reverse."""
  x = randn(2, 6, 4)
  x[0] = 0.0
  w = t(randn(3, 4, 4)).requires_grad_()
  v = t(randn(4, 6, 4))
  with fwAD.dual_level():
    y = tmath.safe_norm(fwAD.make_dual(t(x) @ w, v), keepdims=True)
    y_dot = fwAD.unpack_dual(y).tangent
  xw = (t(x) @ w).detach()
  want = (xw * v).sum(-1, keepdim=True) / xw.norm(dim=-1, keepdim=True)
  np.testing.assert_allclose(y_dot[1:].detach().numpy(), want[1:].numpy(),
                             rtol=1e-5, atol=1e-6)
  assert float(y_dot[0].detach().abs().max()) == 0.0
  (fwd,) = torch.autograd.grad((y_dot ** 2).sum(), w)
  p = (t(x) @ w)
  (g,) = torch.autograd.grad(tmath.safe_norm(p, keepdims=True).sum(), p,
                             create_graph=True)
  (rev,) = torch.autograd.grad((((g * v).sum(-1)) ** 2).sum(), w)
  np.testing.assert_allclose(fwd.numpy(), rev.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('point_dim', [6, 9, 12])
@pytest.mark.parametrize('embed_dim', [0, 8])
def test_hyper_c_sheet_matches_jax(point_dim, embed_dim):
  """The hyper-c sheet posencs the whole input vector; JAX sizes its first
  layer from that width."""
  jsheet = jhyper.HyperSheetMLP(min_deg=0, max_deg=6, depth=3, width=16,
                                skips=(2,))
  extra = (jmath.posenc_dim(point_dim, 0, 6) - jmath.posenc_dim(3, 0, 6))
  params = jax.device_get(jsheet.init(jax.random.PRNGKey(2),
                                      extra + embed_dim))
  params['mlp']['logit']['kernel'] = params['mlp']['logit']['kernel'] * 1e4
  tsheet = thyper.HyperSheetMLP(embed_dim, min_deg=0, max_deg=6, depth=3,
                                width=16, skips=(2,), point_dim=point_dim)
  tsheet.load_state_dict(params_from_jax(params))
  x, e = randn(3, 10, point_dim), randn(4, 10, embed_dim)
  want = jsheet.apply(params, jnp.asarray(x), jnp.asarray(e))
  got = tsheet(t(x), t(e) if embed_dim else None)
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                             atol=1e-6, rtol=1e-5)


# -- the model's widths, its param tree and the converter ---------------------


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_init_matches_param_tree_and_round_trips(name):
  """The port's init has JAX's param tree and shapes (hyper-c's embedding
  and sheet, the rgb branch widened by the screw, window, Δx, hyper, mask
  and reflection conditions), and the trees convert both ways bit for
  bit."""
  _, params, tmodel = model_pair(name, 'vmap')
  fresh = params_to_jax(TorchModel(tmodel.config, num_warp_embeds=NUM_EMBEDS,
                                   num_hyper_embeds=NUM_EMBEDS,
                                   device='cpu').state_dict())
  jflat = jax.tree_util.tree_flatten_with_path(params)[0]
  tflat = jax.tree_util.tree_flatten_with_path(fresh)[0]
  assert [p for p, _ in jflat] == [p for p, _ in tflat]
  for (path, a), (_, b) in zip(jflat, tflat):
    assert a.shape == b.shape, path
  assert ('hyper_c_mlp' in fresh) == ('hyper_c' in name)
  assert ('bottleneck' in fresh['nerf']['fine']) == ('hyper_c' not in name)
  back = params_to_jax(params_from_jax(params))
  jax.tree_util.tree_map(np.testing.assert_array_equal, params, back)


def test_convert_round_trip_hyper_c_and_screw_branch():
  """A JAX param tree with hyper_c_embed, hyper_c_mlp and a
  screw-conditioned rgb branch goes to the port's model and back bit for
  bit."""
  kw = {**TOY, **HYPER_C_CANONICAL}
  jmodel = JaxModel(config=dataclasses.replace(
      jconfig.nerf_ds(), **kw, screw_input_mode='full'),
                    num_warp_embeds=NUM_EMBEDS, num_hyper_embeds=NUM_EMBEDS)
  params = jax.device_get(jmodel.init(jax.random.PRNGKey(3)))
  screwed = JaxModel(config=dataclasses.replace(
      jconfig.nerf_ds(), **TOY, screw_input_mode='full'),
                     num_warp_embeds=NUM_EMBEDS, num_hyper_embeds=NUM_EMBEDS)
  screw_params = jax.device_get(screwed.init(jax.random.PRNGKey(4)))
  for tree, cfg in ((params, jmodel.config), (screw_params, screwed.config)):
    tmodel = TorchModel(tconfig.ModelConfig(**dataclasses.asdict(cfg)),
                        num_warp_embeds=NUM_EMBEDS,
                        num_hyper_embeds=NUM_EMBEDS, device='cpu')
    tmodel.load_state_dict(params_from_jax(tree))
    back = params_to_jax(tmodel.state_dict())
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    jax.tree_util.tree_map(np.testing.assert_array_equal, tree, back)
  assert {'hyper_c_embed', 'hyper_c_mlp'} <= set(params)
  # The screw's six channels widen the rgb branch's first layer.
  rows = lambda p: p['nerf']['fine']['rgb']['hidden_0']['kernel'].shape[0]
  plain = JaxModel(config=dataclasses.replace(jconfig.nerf_ds(), **TOY),
                   num_warp_embeds=NUM_EMBEDS, num_hyper_embeds=NUM_EMBEDS)
  assert rows(screw_params) == rows(jax.device_get(
      plain.init(jax.random.PRNGKey(4)))) + 6


@pytest.mark.parametrize('flags', [
    SIGMA_NORMALS, HYPER_C_CANONICAL, DIRECT_CONDITIONS,
    *(dict(norm_supervision_type=kind) for kind in (
        'warped', 'canonical', 'direct', 'canonical_unwarped')),
    *(dict(sigma_gradient_mode=mode) for mode in (
        'vmap', 'fused', 'jvp', 'vjp', 'naive')),
    # The flags that came after this slice, on the radiance branch's (a).
    *(dict(SIGMA_NORMALS, **{flag: value}) for flag, value in dict(
        use_bone=True, use_nerf_embed=True, remat_sigma=True,
        remat_feat=True, norm_type='layer',
        concat_dense_inputs=True).items()),
], ids=lambda f: '-'.join(f'{k}={v}' for k, v in f.items()))
def test_the_radiance_branch_builds_with_every_flag(flags):
  """Each configuration builds at toy widths (the widths of JAX's param
  tree, held above), and an unknown ∇σ mode raises."""
  model = TorchModel(dataclasses.replace(tconfig.nerf_ds(), **TOY, **flags),
                     num_warp_embeds=NUM_EMBEDS, device='cpu')
  assert model.config.use_bone == flags.get('use_bone', False)
  with pytest.raises(ValueError, match='sigma_gradient_mode'):
    TorchModel(dataclasses.replace(tconfig.nerf_ds(), **TOY, **dict(
        flags, sigma_gradient_mode='other')), device='cpu')


# -- both render levels of each flag family -----------------------------------


@pytest.fixture(scope='module',
                params=[(n, m) for n in sorted(CONFIGS) for m in MODES],
                ids=lambda p: f'{p[0]}-{p[1]}')
def renders(request):
  name, mode = request.param
  jmodel, params, tmodel = model_pair(name, mode)
  rays = make_rays(8)
  kw = dict(return_full=True, return_points=True, x_for_rgb_alpha=2.5)
  want = jax_render(jmodel, params, rays, **kw)
  with torch.no_grad():
    got = tmodel.render(to_torch(rays), torch_extra(tmodel.config), **kw)
  return name, want, got


@pytest.mark.parametrize('level', ['coarse', 'fine'])
def test_render_matches_jax_on_every_key(renders, level):
  name, jax_out, torch_out = renders
  want, got = jax_out[level], torch_out[level]
  assert set(got) == set(want)
  for k in sorted(want):
    atol, rtol = TOLERANCE.get(k, (ATOL, RTOL))
    np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                               atol=atol, rtol=rtol,
                               err_msg=f'{name}/{level}/{k}')


def test_hyper_point_override_matches_jax():
  """A ``hyper_point`` in the metadata replaces the bendy sheet's hyper
  coordinates at every sample."""
  jmodel, params, tmodel = model_pair('direct_conditions', 'fused')
  rays = make_rays(6, seed=5)
  rays['metadata']['hyper_point'] = randn(6, 6, 2, scale=0.3)
  want = jax_render(jmodel, params, rays, return_full=True,
                    return_points=True)
  with torch.no_grad():
    got = tmodel.render(to_torch(rays), torch_extra(tmodel.config),
                        return_full=True, return_points=True)
  for level in ('coarse', 'fine'):
    hyper = got[level]['warped_points'][..., 3:]
    np.testing.assert_array_equal(
        hyper.numpy(), np.broadcast_to(rays['metadata']['hyper_point'][:, None],
                                       hyper.shape))
    assert set(got[level]) == set(want[level])
    for k in want[level]:
      atol, rtol = TOLERANCE.get(k, (ATOL, RTOL))
      np.testing.assert_allclose(got[level][k].numpy(),
                                 np.asarray(want[level][k]), atol=atol,
                                 rtol=rtol, err_msg=f'{level}/{k}')


def test_chunked_render_of_hyper_c_matches_jax():
  """The chunked renderer encodes hyper-c's embedding once an image
  (``encoded_hyper_c``) and assembles ``ray_hyper_c``; its padded chunks
  agree with JAX's render of the same rays."""
  jmodel, params, tmodel = model_pair('hyper_c_canonical', 'fused')
  rays = make_rays(10, seed=6)
  rays['metadata']['warp'][:] = 2
  want = jax_render(jmodel, params, rays, return_full=True,
                    compute_sigma_gradient=False)['fine']
  image = {k: v.reshape(2, 5, -1) for k, v in rays.items() if k != 'metadata'}
  image['metadata'] = {'warp': rays['metadata']['warp'].reshape(2, 5, 1)}
  got = trender.render_image(tmodel, image, torch_extra(tmodel.config),
                             chunk=4)
  assert set(got) == set(trender.DEFAULT_KEYS) | {'ray_hyper_c'}
  for k, v in got.items():
    np.testing.assert_allclose(v.reshape(10, -1),
                               np.asarray(want[k]).reshape(10, -1),
                               atol=ATOL, rtol=RTOL, err_msg=k)


# -- one training step each of (a), (b) and (c) -------------------------------


def toy_train_cfg(config_lib):
  """Schedules that sit mid-way at step 0."""
  return dataclasses.replace(
      config_lib.nerf_ds_train_config(max_steps=200, batch_size=8),
      warp_alpha_schedule=('linear', 1.5, 4, 50),
      norm_input_alpha_schedule=('constant', 2.5),
      sharp_mask_std_schedule=('constant', 0.5),
      x_for_rgb_alpha_schedule=('constant', 2.5),
      lr_schedule=('exponential', 5e-3, 1e-4, 200))


def toy_batch(n=8, seed=0):
  rng = np.random.RandomState(seed)
  batch = make_rays(n, seed)
  batch['rgb'] = rng.rand(n, 3).astype(np.float32)
  return batch


STEPS = {'sigma_normals': 'fused', 'hyper_c_canonical': 'fused',
         'direct_conditions': 'fused'}


@pytest.mark.parametrize('name', sorted(STEPS))
def test_train_step_matches_jax(name):
  """One ``make_train_step`` step of each configuration against JAX's from
  the same params and batch: Adam's first moment (0.1 of the gradient)
  within 1e-3 of each tensor's norm, the second moment, the stats, and
  the params where the gradient is not near 0. JAX takes ∇σ by 'vmap',
  the port by 'fused' (K1's plain versions on the CPU)."""
  jmodel, params, _ = model_pair(name, 'vmap')
  _, _, tmodel = model_pair(name, STEPS[name])
  batch = toy_batch()
  jcfg, tcfg = toy_train_cfg(jconfig), toy_train_cfg(tconfig)
  step_fn = jstep.make_train_step(jmodel, jcfg, donate=False)
  want_state, want_stats = jax.device_get(step_fn(
      jstep.TrainState.create(params),
      jax.tree_util.tree_map(jnp.asarray, batch), jax.random.PRNGKey(1)))
  state0 = tstep.TrainState.create(params_from_jax(params))
  state1, stats = tstep.make_train_step(tmodel, tcfg)(state0,
                                                      to_torch(batch))
  want_mu = params_from_jax(want_state.opt_state.mu)
  assert set(state1.opt_state.mu) == set(want_mu)
  for k, w in want_mu.items():
    assert rel_err(state1.opt_state.mu[k], w) < 1e-3, k
  for k, w in params_from_jax(want_state.opt_state.nu).items():
    assert rel_err(state1.opt_state.nu[k], w) < 1e-3, k
  for k, w in params_from_jax(want_state.params).items():
    conditioned = want_mu[k].abs() > 1e-7
    diff = (state1.params[k] - w).abs()
    assert float(torch.where(conditioned, diff, 0.0).max()) < 1e-4, k
  for level in ('coarse', 'fine'):
    assert set(stats[level]) == set(want_stats[level])
    for k, w in want_stats[level].items():
      np.testing.assert_allclose(float(stats[level][k]), float(w),
                                 rtol=1e-4, atol=1e-6, err_msg=f'{level}/{k}')
  # The rgb loss reaches the colour's own inputs: the warp (through ∇σ in
  # (a), the screw and Δx in (c)) and hyper-c's sheet in (b).
  mu = state1.opt_state.mu
  assert float(mu['warp_field.trunk.hidden_0.kernel'].abs().max()) > 0
  if 'hyper_c' in name:
    assert float(mu['hyper_c_mlp.mlp.hidden_0.kernel'].abs().max()) > 0


# -- the ∇σ modes 'jvp', 'vjp' and 'naive' ------------------------------------


@pytest.mark.parametrize('mode', ['jvp', 'vjp', 'naive'])
@pytest.mark.parametrize('name', ['sigma_normals', 'hyper_c_canonical'])
def test_sigma_gradient_mode_grads_match_jax(name, mode):
  """The loss's gradients of each ∇σ mode on one toy batch, against JAX's
  same mode, within 1e-3 of each tensor's norm; the port's 'jvp' reaches
  every parameter that 'vmap' reaches."""
  jmodel, params, tmodel = model_pair(name, mode)
  batch = toy_batch(seed=2)
  jcfg, tcfg = toy_train_cfg(jconfig), toy_train_cfg(tconfig)
  scalars = jstep.eval_schedules(jstep.build_schedules(jcfg), 0)
  (_, _), want = jax.jit(jax.value_and_grad(
      jstep.make_loss_fn(jmodel, jcfg), has_aux=True))(
          params, jax.tree_util.tree_map(jnp.asarray, batch),
          jax.random.PRNGKey(1), scalars)
  want = params_from_jax(jax.device_get(want))
  tscalars = tstep.eval_schedules(tstep.build_schedules(tcfg), 0)
  got, _ = tstep._grads(tstep.make_loss_fn(tmodel, tcfg),
                        params_from_jax(params), to_torch(batch), None,
                        tscalars)
  assert set(got) == set(want)
  for k, w in want.items():
    if float(w.norm()) == 0:
      assert float(got[k].norm()) == 0, k
    else:
      assert rel_err(got[k], w) < 1e-3, k
