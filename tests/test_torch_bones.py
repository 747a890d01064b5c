"""The bone warp field, ``NormVoxels``, the remaining math and rigid ops and
the differentiable projection of the port against the JAX package.

Inputs come from numpy seeds, weights from the JAX init through
``params_from_jax``; float32 on both sides. The model cases render and
step ``nerf_ds()`` with ``use_bone`` at toy widths with unstratified
samples and no σ noise; the background loss's draws are JAX's, replayed.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfds_tpu import camera as jcamera
from nerfds_tpu import config as jconfig
from nerfds_tpu.models import NerfDSModel as JaxModel
from nerfds_tpu.models import bones as jbones
from nerfds_tpu.models import default_extra_params as jax_extra
from nerfds_tpu.models import norm_voxels as jvoxels
from nerfds_tpu.ops import math as jmath
from nerfds_tpu.ops import rigid as jrigid
from nerfds_tpu.training import losses as jlosses
from nerfds_tpu.training import step as jstep
from nerfds_torch import camera as tcamera
from nerfds_torch import config as tconfig
from nerfds_torch.convert import params_from_jax, params_to_jax
from nerfds_torch.models import NerfDSModel as TorchModel
from nerfds_torch.models import bones as tbones
from nerfds_torch.models import default_extra_params as torch_extra
from nerfds_torch.models import norm_voxels as tvoxels
from nerfds_torch.ops import math as tmath
from nerfds_torch.ops import rigid as trigid
from nerfds_torch.training import losses as tlosses
from nerfds_torch.training import step as tstep

torch.set_num_threads(1)

NUM_EMBEDS = 4
TOY = dict(num_coarse_samples=6, num_fine_samples=4, nerf_trunk_depth=3,
           nerf_trunk_width=32, nerf_skips=(2,), hyper_sheet_depth=3,
           hyper_sheet_width=16, hyper_sheet_skips=(2,), mask_mlp_depth=3,
           mask_mlp_width=16, mask_skips=(2,), use_stratified_sampling=False,
           use_bone=True, num_bones=3, bone_trunk_depth=3,
           bone_trunk_width=16, bone_moving_mlp_depth=3,
           bone_moving_mlp_width=16)
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


def randn(seed, *shape, scale=1.0):
  return (np.random.RandomState(seed).randn(*shape) * scale).astype(
      np.float32)


def close(got, want, atol=1e-6, rtol=1e-5, msg=''):
  if isinstance(got, torch.Tensor):
    got = got.detach().numpy()
  np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol,
                             err_msg=msg)


def moving_bones(params):
  """A bone field far from its init: screws of O(1) angle and offset, bones
  of O(0.1) variance, and a moving mask that varies over space."""
  params = jax.tree_util.tree_map(np.array, params)
  for head in ('w', 'v'):
    params[head]['kernel'] = params[head]['kernel'] * 3e3
  params['bone_scales'] = np.abs(params['bone_scales']) * 0.3 + 0.05
  params['moving_mlp']['logit']['kernel'] = (
      params['moving_mlp']['logit']['kernel'] * 3e4)
  return params


# -- L0: math and rigid ops -------------------------------------------------------


def test_gm_loss_and_matmul_hp_match_jax():
  x, s = randn(0, 5, 7, scale=3.0), 0.7
  close(tmath.gm_loss(t(x), s), jmath.gm_loss(jnp.asarray(x), s))
  a, b = randn(1, 6, 9), randn(2, 9, 4)
  close(tmath.matmul_hp(t(a), t(b)), jmath.matmul_hp(jnp.asarray(a),
                                                     jnp.asarray(b)))


@pytest.mark.parametrize('spread', [0.5, 1.3], ids=['inside', 'clamped'])
def test_grid_sample_matches_jax(spread):
  """Bilinear samples of a 5x7 image; 'clamped' puts coordinates past
  every edge (clamped to [0, H] x [0, W], the padded border)."""
  image = randn(3, 5, 7)
  rng = np.random.RandomState(4)
  coord = (rng.uniform(-spread, spread, (4, 6, 2)) * [7, 5]
           + [3.5, 2.5]).astype(np.float32)
  coord[0, 0] = [7.0, 5.0]   # exactly on the clamp bound
  close(tmath.grid_sample(t(image), t(coord)),
        jmath.grid_sample(jnp.asarray(image), jnp.asarray(coord)))


def test_trilinear_coefficient_matches_jax():
  pos = np.random.RandomState(5).rand(9, 3).astype(np.float32)
  got = tmath.get_trilinear_coefficient(t(pos))
  close(got, jmath.get_trilinear_coefficient(jnp.asarray(pos)))
  close(got.sum(-1), np.ones(9))


def screws(seed, shape=(7,)):
  w = randn(seed, *shape, 3)
  v = randn(seed + 1, *shape, 3)
  return (jrigid.screw_from_raw(jnp.asarray(w), jnp.asarray(v)),
          trigid.screw_from_raw(t(w), t(v)))


@pytest.mark.parametrize('name', ['transform_point_inverse', 'rotation_matrix',
                                  'skew', 'exp_so3', 'exp_se3_matrix',
                                  'exp_se3_matrix_inverse',
                                  'exp_se3_matrix_rotation_only',
                                  'homogenous'])
def test_rigid_op_matches_jax(name):
  js, ts = screws(6, (4, 3))
  x = randn(8, 4, 3, 3)
  if name == 'transform_point_inverse':
    got = trigid.transform_point_inverse(ts, t(x))
    close(got, jrigid.transform_point_inverse(js, jnp.asarray(x)))
    close(trigid.transform_point(ts, got), x, atol=1e-5)  # the round trip
  elif name == 'rotation_matrix':
    got = trigid.rotation_matrix(ts)
    close(got, jrigid.rotation_matrix(js))
    close(got @ got.transpose(-1, -2), np.broadcast_to(np.eye(3), got.shape),
          atol=1e-5)
  elif name == 'skew':
    close(trigid.skew(t(x)), jrigid.skew(jnp.asarray(x)))
  elif name == 'exp_so3':
    close(trigid.exp_so3(ts.w, ts.theta), jrigid.exp_so3(js.w, js.theta))
    # The matrix form agrees with the closed form.
    close(trigid.exp_so3(ts.w, ts.theta), trigid.rotation_matrix(ts),
          atol=1e-5)
  elif name.startswith('exp_se3_matrix'):
    kw = dict(inverse=name.endswith('inverse'),
              rotation_only=name.endswith('only'))
    axis = torch.cat([ts.w, ts.v], -1)
    got = trigid.exp_se3_matrix(axis, ts.theta, **kw)
    close(got, jrigid.exp_se3_matrix(js.axis, js.theta, **kw), atol=1e-5)
    if not any(kw.values()):
      # Applied to a homogeneous point it is the closed-form transform.
      hom = trigid.to_homogenous(t(x))
      moved = trigid.from_homogenous((got @ hom[..., None])[..., 0])
      close(moved, trigid.transform_point(ts, t(x)), atol=1e-4, rtol=1e-4)
  else:
    hom = trigid.to_homogenous(t(x)) * 2.5
    close(hom, jrigid.to_homogenous(jnp.asarray(x)) * 2.5)
    close(trigid.from_homogenous(hom), jrigid.from_homogenous(
        jnp.asarray(hom.numpy())))


# -- the differentiable projection ---------------------------------------------------


def distorted_camera(module):
  rot = np.linalg.qr(np.random.RandomState(9).randn(3, 3))[0]
  if np.linalg.det(rot) < 0:
    rot[:, 0] *= -1
  return module.Camera(
      orientation=rot.T, position=np.asarray([0.2, -0.1, -2.5]),
      focal_length=120.0, principal_point=np.asarray([31.0, 25.0]),
      image_size=np.asarray([64, 48]), skew=0.3, pixel_aspect_ratio=1.1,
      radial_distortion=np.asarray([0.05, -0.02, 0.003]),
      tangential_distortion=np.asarray([0.001, -0.002]))


def test_project_torch_matches_project_jnp_and_its_gradient():
  jcam, tcam = distorted_camera(jcamera), distorted_camera(tcamera)
  pts = randn(10, 2, 5, 3, scale=0.4)
  want = jcam.project_jnp(jnp.asarray(pts))
  p = t(pts).requires_grad_()
  got = tcam.project_torch(p)
  assert got.shape == (2, 5, 2)
  close(got, want, atol=1e-4, rtol=1e-5)
  close(got, tcam.project(pts), atol=1e-3, rtol=1e-5)  # the numpy form
  (grad,) = torch.autograd.grad((got ** 2).sum(), p)
  want_grad = jax.grad(lambda x: (jcam.project_jnp(x) ** 2).sum())(
      jnp.asarray(pts))
  close(grad, want_grad, atol=1e-3, rtol=1e-4)


# -- the bone field --------------------------------------------------------------------


def test_bone_probs_match_jax():
  rng = np.random.RandomState(11)
  points = randn(12, 6, 3, scale=0.5)
  centers = randn(13, 6, 3, 3, scale=0.5)
  scales = (rng.rand(3, 3) * 0.3 - 0.15).astype(np.float32)
  rot = np.stack([np.linalg.qr(rng.randn(3, 3))[0] for _ in range(18)]
                 ).reshape(6, 3, 3, 3).astype(np.float32)
  got = tbones.bone_probs(t(points), t(centers), t(scales), t(rot))
  close(got, jbones.bone_probs(*map(jnp.asarray, (points, centers, scales,
                                                   rot))), rtol=1e-5)


@pytest.fixture(scope='module')
def bone_field():
  jfield = jbones.BoneSE3Field(num_bones=3, trunk_depth=3, trunk_width=16,
                               moving_mlp_depth=3, moving_mlp_width=16)
  params = moving_bones(jax.device_get(jfield.init(jax.random.PRNGKey(0),
                                                   9)))
  tfield = tbones.BoneSE3Field(9, num_bones=3, trunk_depth=3,
                               trunk_width=16, moving_mlp_depth=3,
                               moving_mlp_width=16)
  tfield.load_state_dict(params_from_jax(params))
  return jfield, params, tfield


def test_bone_field_warp_and_moving_mask_match_jax(bone_field):
  jfield, params, tfield = bone_field
  points, embed = randn(14, 20, 3, scale=0.5), randn(15, 20, 9, scale=0.3)
  want = jax.jit(jfield.warp)(params, jnp.asarray(points),
                              jnp.asarray(embed))
  got = tfield.warp(t(points), t(embed))
  assert set(got) == set(want)
  for k in want:
    close(got[k], want[k], atol=1e-5, rtol=1e-4, msg=k)
  # Far from the identity, with a mask that varies and weights that blend.
  assert float((got['warped_points'] - t(points)).abs().max()) > 0.05
  assert float(got['moving_mask'].std()) > 0.01
  assert float(got['bone_weights'].max()) < 1.0
  close(tfield.moving_mask(t(points), t(embed)),
        jfield.moving_mask(params, jnp.asarray(points), jnp.asarray(embed)),
        atol=1e-6, rtol=1e-5)
  # The gradients of the warped points reach every bone leaf, as JAX's do.
  loss = lambda w: (w['warped_points'] ** 2).sum()
  want_g = params_from_jax(jax.device_get(jax.jit(jax.grad(lambda p: loss(
      jfield.warp(p, jnp.asarray(points), jnp.asarray(embed)))))(params)))
  got_g = dict(zip(dict(tfield.named_parameters()), torch.autograd.grad(
      loss(tfield.warp(t(points), t(embed))), list(tfield.parameters()))))
  assert set(got_g) == set(want_g)
  for k, w in want_g.items():
    assert rel_err(got_g[k], w) < 1e-4, k


# -- nerf_ds() with the bone field ----------------------------------------------------


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


def jax_model(mode='vmap'):
  return JaxModel(config=dataclasses.replace(
      jconfig.nerf_ds(), **TOY, sigma_gradient_mode=mode),
                  num_warp_embeds=NUM_EMBEDS, num_hyper_embeds=NUM_EMBEDS)


def port(mode):
  tmodel = TorchModel(dataclasses.replace(
      tconfig.nerf_ds(), **TOY, sigma_gradient_mode=mode,
      use_pallas_compositing=True), num_warp_embeds=NUM_EMBEDS,
                      num_hyper_embeds=NUM_EMBEDS, device='cpu')
  tmodel.load_state_dict(params_from_jax(jax_init()))
  return tmodel


@functools.lru_cache(maxsize=None)
def jax_init():
  params = jax.device_get(jax.jit(jax_model().init)(jax.random.PRNGKey(0)))
  params['bone_warp_field'] = moving_bones(params['bone_warp_field'])
  return params


def test_init_matches_param_tree_and_round_trips():
  """The bone field's leaves (its trunk, heads, moving-mask MLP and the
  bone centres, scales and quaternions) have JAX's tree and shapes, and
  convert both ways bit for bit."""
  params = jax_init()
  assert 'bone_warp_field' in params and 'warp_field' not in params
  fresh = params_to_jax(port('vmap').state_dict())
  jflat = jax.tree_util.tree_flatten_with_path(params)[0]
  tflat = jax.tree_util.tree_flatten_with_path(fresh)[0]
  assert [p for p, _ in jflat] == [p for p, _ in tflat]
  for (path, a), (_, b) in zip(jflat, tflat):
    np.testing.assert_array_equal(a, b, err_msg=str(path))
  back = params_to_jax(params_from_jax(params))
  jax.tree_util.tree_map(np.testing.assert_array_equal, params, back)
  init = params_to_jax(TorchModel(port('vmap').config,
                                  num_warp_embeds=NUM_EMBEDS,
                                  num_hyper_embeds=NUM_EMBEDS,
                                  device='cpu').state_dict())
  for (path, a), (_, b) in zip(jflat, jax.tree_util.tree_flatten_with_path(
      init)[0]):
    assert a.shape == b.shape, path


def test_voxel_tree_round_trips():
  grid = randn(16, 2, 3, 4, 5, 3)
  tree = {'norm_voxels': {'voxel_array': grid}}
  vox = tvoxels.NormVoxels((2, 3, 4, 5))
  vox.load_state_dict(params_from_jax(tree['norm_voxels']))
  back = params_to_jax({f'norm_voxels.{k}': v
                        for k, v in vox.state_dict().items()})
  jax.tree_util.tree_map(np.testing.assert_array_equal, tree, back)


@pytest.fixture(scope='module', params=['vmap', 'fused'])
def renders(request):
  mode = request.param
  jmodel = jax_model(mode)
  rays = make_rays(8)
  want = jax.device_get(jax.jit(lambda p, r: jmodel.render(
      p, r, jax.random.PRNGKey(1), jax_extra(jmodel.config),
      return_full=True, return_points=True))(
          jax_init(), jax.tree_util.tree_map(jnp.asarray, rays)))
  tmodel = port(mode)
  with torch.no_grad():
    got = tmodel.render(to_torch(rays), torch_extra(tmodel.config),
                        return_full=True, return_points=True)
  return mode, want, got


@pytest.mark.parametrize('level', ['coarse', 'fine'])
def test_render_matches_jax_on_every_key(renders, level):
  """Every key of both levels, ``moving_mask`` and ``ray_moving_mask``
  among them; in 'fused' JAX's trunk kernel runs in interpret mode and the
  port's K1 plain versions."""
  mode, want, got = renders
  want, got = want[level], got[level]
  assert set(got) == set(want)
  assert {'moving_mask', 'ray_moving_mask'} <= set(got)
  for k in sorted(want):
    atol, rtol = TOLERANCE.get(k, (ATOL, RTOL))
    np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                               atol=atol, rtol=rtol,
                               err_msg=f'{mode}/{level}/{k}')
  moved = got['warped_points'][..., :3] - got['points']
  assert float(moved.abs().max()) > 0.01


def jax_background_draws(key, num_points, noise_std):
  """The draws of JAX's compute_background_loss for ``key``."""
  metadata = jax.random.randint(key, (num_points, 1), 0, NUM_EMBEDS)
  noise = noise_std * jax.random.normal(key, (num_points, 3))
  return np.asarray(metadata), np.asarray(noise)


def test_bone_background_loss_matches_jax():
  """|moving mask| at the jittered static points, and its gradient with
  respect to the points, with JAX's draws."""
  jmodel, params, tmodel = jax_model(), jax_init(), port('vmap')
  pts = randn(17, 30, 3, scale=0.5)
  key = jax.random.PRNGKey(5)
  extra = jax_extra(jmodel.config)

  def jax_loss(p):
    loss = jlosses.compute_background_loss(jmodel, params, key, p, extra,
                                           noise_std=0.01)
    return loss.mean(), loss

  (_, want), want_grad = jax.jit(jax.value_and_grad(
      jax_loss, has_aux=True))(jnp.asarray(pts))
  p = t(pts).requires_grad_()
  got = tlosses.compute_background_loss(
      tmodel, dict(tmodel.named_parameters()), p, torch_extra(tmodel.config),
      noise_std=0.01, draws=tuple(map(t, jax_background_draws(key, 30,
                                                              0.01))))
  (got_grad,) = torch.autograd.grad(got.mean(), p)
  assert got.shape == (30, 1) and float(got.std()) > 1e-3
  close(got, want, rtol=1e-5, atol=1e-7)
  close(got_grad, want_grad, rtol=1e-4,
        atol=1e-5 * float(np.abs(np.asarray(want_grad)).max()))


def test_train_step_with_the_bone_background_loss_matches_jax():
  """One ``make_train_step`` step of ``nerf_ds()`` with the bone field and
  its background term, the port's 'fused' (K1's and K2's plain versions)
  against JAX's 'vmap': Adam's first moment (0.1 of the gradient) within
  1e-3 of each tensor's norm, and the stats."""
  jmodel, params = jax_model(), jax_init()
  tmodel = port('fused')
  train_cfg = dataclasses.replace(
      jconfig.nerf_ds_train_config(max_steps=200, batch_size=8),
      warp_alpha_schedule=('linear', 1.5, 4, 50),
      norm_input_alpha_schedule=('constant', 2.5),
      sharp_mask_std_schedule=('constant', 0.5),
      lr_schedule=('exponential', 5e-3, 1e-4, 200),
      use_background_loss=True, background_loss_weight=1.0)
  tcfg = tconfig.TrainConfig(**dataclasses.asdict(train_cfg))
  rng = np.random.RandomState(0)
  batch = make_rays(8)
  batch['rgb'] = rng.rand(8, 3).astype(np.float32)
  batch['background_points'] = rng.uniform(-0.9, 0.9, (24, 3)).astype(
      np.float32)
  key = jax.random.PRNGKey(1)
  jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
  state1_want, want_stats = jax.device_get(jstep.make_train_step(
      jmodel, train_cfg, donate=False)(jstep.TrainState.create(params),
                                       jbatch, key))
  port_batch = to_torch(batch)
  _, key_bg = jax.random.split(key)
  ids, noise = jax_background_draws(key_bg, 24, train_cfg.background_noise_std)
  port_batch.update(background_metadata=t(ids), background_noise=t(noise))
  state1, stats = tstep.make_train_step(tmodel, tcfg)(
      tstep.TrainState.create(params_from_jax(params)), port_batch)
  want = params_from_jax(state1_want.opt_state.mu)
  got = state1.opt_state.mu
  assert set(got) == set(want)
  for k, w in want.items():
    assert rel_err(got[k], w) < 1e-3, k
  np.testing.assert_allclose(float(stats['loss/background']),
                             float(want_stats['loss/background']),
                             rtol=1e-5, atol=1e-7)
  assert float(want_stats['loss/background']) > 1e-3
  for level in ('coarse', 'fine'):
    for k, w in want_stats[level].items():
      np.testing.assert_allclose(float(stats[level][k]), float(w),
                                 rtol=1e-4, atol=1e-6, err_msg=f'{level}/{k}')
  # The background term reaches the moving-mask MLP; the colour reaches
  # the bones.
  assert float(got['bone_warp_field.moving_mlp.hidden_0.kernel'].abs().max()
               ) > 0
  assert float(got['bone_warp_field.bone_centers'].abs().max()) > 0


def test_bone_field_refuses_the_warp_jacobian():
  with pytest.raises(ValueError, match='Jacobian'):
    port('vmap').render(to_torch(make_rays(2)),
                        torch_extra(port('vmap').config),
                        return_warp_jacobian=True)


# -- NormVoxels, the four cases of tests/test_norm_voxels.py against JAX -----------


def voxel_pair(shape, seed=None):
  jv = jvoxels.NormVoxels(voxel_shape=shape)
  params = jv.init()
  if seed is not None:  # a grid that is not uniform
    params = {'voxel_array': jnp.asarray(randn(seed, *shape, 3))}
  tv = tvoxels.NormVoxels(shape)
  tv.load_state_dict(params_from_jax(jax.device_get(params)))
  return jv, params, tv


def test_norm_voxels_init_and_lookup_match_jax():
  jv, params, tv = voxel_pair((2, 4, 4, 4))
  np.testing.assert_array_equal(tv.voxel_array.detach().numpy(),
                                np.asarray(params['voxel_array']))
  pos = np.random.RandomState(0).uniform(-1.2, 1.2, (5, 3)).astype(
      np.float32)
  t_idx = np.asarray([0, 1, 1, 0, 1])
  for seed in (None, 18):  # the uniform grid, then a random one
    jv, params, tv = voxel_pair((2, 4, 4, 4), seed)
    want = jv.lookup(params, jnp.asarray(t_idx), jnp.asarray(pos))
    got = tv.lookup(t(t_idx), t(pos))
    for g, w in zip(got, want):
      close(g, w, atol=1e-6)
    np.testing.assert_array_equal(
        tv.vertex_indices(t(t_idx), t(pos)).numpy(),
        np.asarray(jv.vertex_indices(jnp.asarray(t_idx), jnp.asarray(pos))))
  close(got[2].sum(-1), np.ones(5))


def test_norm_voxels_update_moves_toward_target_as_jax():
  jv, params, tv = voxel_pair((1, 4, 4, 4))
  pos = np.asarray([[0.2, -0.3, 0.4]], np.float32)
  target = np.asarray([[1.0, 0.0, 0.0]], np.float32)
  args = dict(lr=10.0, sigma=np.full((1,), 5.0, np.float32),
              target_norm=target)
  want_v, want_p = jv.lookup_and_update(
      params, jnp.zeros(1, jnp.int32), jnp.asarray(pos),
      **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
         for k, v in args.items()})
  got_v, got_p = tv.lookup_and_update(
      torch.zeros(1, dtype=torch.long), t(pos),
      **{k: t(v) if isinstance(v, np.ndarray) else v for k, v in args.items()})
  close(got_v, want_v)
  close(got_p['voxel_array'], want_p['voxel_array'])
  # The parameter itself is left as it was (the update is functional).
  assert float((tv.voxel_array - np.sqrt(1 / 3)).abs().max()) < 1e-7
  tv2 = tvoxels.NormVoxels((1, 4, 4, 4))
  tv2.load_state_dict(got_p)
  value1, _, _ = tv2.lookup(torch.zeros(1, dtype=torch.long), t(pos))
  assert float((value1 - t(target)).norm()) < float((got_v - t(target)).norm())


def test_norm_voxels_zero_sigma_update_matches_jax():
  """Four points, some sharing vertices (their moves add), σ = 0."""
  jv, params, tv = voxel_pair((1, 4, 4, 4), seed=19)
  pos = np.random.RandomState(2).uniform(-1.0, 1.0, (4, 3)).astype(
      np.float32)
  target = np.tile(np.asarray([[0.0, 1.0, 0.0]], np.float32), (4, 1))
  sigma = np.zeros((4,), np.float32)
  _, want = jv.lookup_and_update(params, jnp.zeros(4, jnp.int32),
                                 jnp.asarray(pos), lr=10.0,
                                 sigma=jnp.asarray(sigma),
                                 target_norm=jnp.asarray(target))
  _, got = tv.lookup_and_update(torch.zeros(4, dtype=torch.long), t(pos),
                                lr=10.0, sigma=t(sigma),
                                target_norm=t(target))
  close(got['voxel_array'], want['voxel_array'], atol=1e-6)
  assert torch.isfinite(got['voxel_array']).all()


def test_norm_voxels_out_of_range_clamps_as_jax():
  jv, params, tv = voxel_pair((1, 4, 4, 4), seed=20)
  pos = np.asarray([[5.0, -5.0, 0.0], [-1.6, 1.49, 3.0]], np.float32)
  want = jv.lookup(params, jnp.zeros(2, jnp.int32), jnp.asarray(pos))
  got = tv.lookup(torch.zeros(2, dtype=torch.long), t(pos))
  for g, w in zip(got, want):
    close(g, w, atol=1e-6)
  assert torch.isfinite(got[0]).all()
