"""The deformation family of the port against the JAX package: the warp
Jacobian's helpers, quaternion and dual-quaternion math, the SE(3),
dual-quaternion and translation fields with their ``warp_jacobian``, and
both render levels of the hypernerf configurations (bendy sheet and
axis-aligned plane) and of each warp type.

Inputs come from numpy seeds, weights from the JAX init through
``params_from_jax``; float32 on both sides. The render tests sample
unstratified with no σ noise, so neither side draws random numbers.
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
from nerfds_tpu.models import warp as jwarp
from nerfds_tpu.ops import dual_quaternion as jdq
from nerfds_tpu.ops import math as jmath
from nerfds_tpu.ops import quaternion as jquat
from nerfds_tpu.ops import rigid as jrigid
from nerfds_torch import config as tconfig
from nerfds_torch.convert import params_from_jax, params_to_jax
from nerfds_torch.models import NerfDSModel as TorchModel
from nerfds_torch.models import default_extra_params as torch_extra
from nerfds_torch.models import warp as twarp
from nerfds_torch.ops import dual_quaternion as tdq
from nerfds_torch.ops import math as tmath
from nerfds_torch.ops import quaternion as tquat
from nerfds_torch.ops import rigid as trigid

torch.set_num_threads(1)

NUM_EMBEDS = 4


def t(x):
  return torch.from_numpy(np.array(x))


def close(got, want, atol=1e-6, rtol=1e-6, msg=''):
  if isinstance(got, torch.Tensor):
    got = got.detach().numpy()
  np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol,
                             err_msg=msg)


def randn(seed, *shape, scale=1.0):
  return (np.random.RandomState(seed).randn(*shape) * scale).astype(
      np.float32)


# -- L0: the Jacobian's helpers ----------------------------------------------


def test_jacobian_to_div_and_curl():
  jac = randn(0, 5, 7, 3, 3)
  close(tmath.jacobian_to_div(t(jac)), jmath.jacobian_to_div(jac))
  close(tmath.jacobian_to_curl(t(jac)), jmath.jacobian_to_curl(jac))


def _analytic(lib):
  """A pointwise map whose Jacobian mixes every coordinate."""
  def fn(p):
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return lib.stack([lib.sin(x) * y, x * z ** 2 + y, lib.exp(0.5 * y) * z],
                     -1)
  return fn


def test_batched_jacobian_of_an_analytic_function():
  pts = randn(1, 4, 6, 3)
  want = jrigid.batched_jacobian(_analytic(jnp), jnp.asarray(pts))
  got = trigid.batched_jacobian(_analytic(torch), t(pts))
  assert got.shape == (4, 6, 3, 3)
  close(got, want, atol=1e-6, rtol=1e-6)
  x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
  zero = np.zeros_like(x)
  exact = np.stack([
      np.stack([np.cos(x) * y, np.sin(x), zero], -1),
      np.stack([z ** 2, np.ones_like(x), 2 * x * z], -1),
      np.stack([zero, 0.5 * np.exp(0.5 * y) * z, np.exp(0.5 * y)], -1)], -2)
  close(got, exact, atol=1e-5, rtol=1e-5)


def test_batched_jacobian_keeps_a_graph_to_the_parameters():
  """With grad on, a loss on J reaches what ``fn`` closes over (the step's
  second order), as JAX's JVP-based Jacobian does."""
  pts, scale = randn(2, 9, 3), randn(3, 3)

  def jax_loss(s):
    jac = jrigid.batched_jacobian(
        lambda p: jnp.sin(p * s) * s[::-1], jnp.asarray(pts))
    return jnp.sum(jac ** 2)

  s = t(scale).requires_grad_()
  jac = trigid.batched_jacobian(lambda p: torch.sin(p * s) * s.flip(0),
                                t(pts))
  (grad,) = torch.autograd.grad((jac ** 2).sum(), s)
  close(grad, jax.grad(jax_loss)(jnp.asarray(scale)), atol=1e-5, rtol=1e-5)
  with torch.no_grad():
    assert trigid.batched_jacobian(
        lambda p: torch.sin(p * s), t(pts)).grad_fn is None


# -- L0: quaternions and dual quaternions ------------------------------------


def _quats(seed, n=6):
  q = randn(seed, n, 4)
  q[0] = [0.0, 0.0, 0.0, 1.0]  # the identity: zero vector part
  return q


QUATERNION_CASES = {
    'im': lambda lib, q, q2, v, u: lib.im(q),
    're': lambda lib, q, q2, v, u: lib.re(q),
    'conjugate': lambda lib, q, q2, v, u: lib.conjugate(q),
    'norm': lambda lib, q, q2, v, u: lib.norm(q),
    'normalize': lambda lib, q, q2, v, u: lib.normalize(q),
    'inverse': lambda lib, q, q2, v, u: lib.inverse(q),
    'multiply': lambda lib, q, q2, v, u: lib.multiply(q, q2),
    'rotate': lambda lib, q, q2, v, u: lib.rotate(lib.normalize(q), v),
    'log': lambda lib, q, q2, v, u: lib.log(q),
    'exp': lambda lib, q, q2, v, u: lib.exp(q * 0.5),
    'from_axis_angle': lambda lib, q, q2, v, u: lib.from_axis_angle(
        u, q[..., 3]),
    'to_rotation_matrix': lambda lib, q, q2, v, u: lib.to_rotation_matrix(
        lib.normalize(q)),
    'from_rotation_matrix': lambda lib, q, q2, v, u: (
        lib.from_rotation_matrix(lib.to_rotation_matrix(lib.normalize(q)))),
}


@pytest.mark.parametrize('name', sorted(QUATERNION_CASES))
def test_quaternion_function_matches_jax(name):
  q, q2, v = _quats(4), _quats(5), randn(6, 6, 3)
  u = v / np.linalg.norm(v, axis=-1, keepdims=True)
  fn = QUATERNION_CASES[name]
  want = fn(jquat, *map(jnp.asarray, (q, q2, v, u)))
  got = fn(tquat, *map(t, (q, q2, v, u)))
  close(got, want, atol=1e-6, rtol=1e-6, msg=name)


def test_quaternion_identity_and_gradients():
  close(tquat.identity(), jquat.identity())
  q = _quats(6)
  want = jax.grad(lambda x: jnp.sum(jquat.log(jquat.normalize(x))
                                    * jnp.arange(4.0)))(jnp.asarray(q))
  x = t(q).requires_grad_()
  (got,) = torch.autograd.grad(
      (tquat.log(tquat.normalize(x)) * torch.arange(4.0)).sum(), x)
  close(got, want, atol=1e-6, rtol=1e-5)


def _dqs(seed, n=5):
  return randn(seed, n, 8)


DUAL_QUATERNION_CASES = {
    'real_part': lambda lib, a, b: lib.real_part(a),
    'dual_part': lambda lib, a, b: lib.dual_part(a),
    'multiply': lambda lib, a, b: lib.multiply(a, b),
    'quaternion_conjugate': lambda lib, a, b: lib.quaternion_conjugate(a),
    'dual_conjugate': lambda lib, a, b: lib.dual_conjugate(a),
    'quaternion_dual_conjugate':
        lambda lib, a, b: lib.quaternion_dual_conjugate(a),
    'normalize': lambda lib, a, b: lib.normalize(a),
    'get_rotation': lambda lib, a, b: lib.get_rotation(lib.normalize(a)),
    'get_translation': lambda lib, a, b: lib.get_translation(
        lib.normalize(a)),
    'from_rotation_translation': lambda lib, a, b: (
        lib.from_rotation_translation(lib.normalize(a)[..., :4], b[..., :3])),
    'transform_point': lambda lib, a, b: lib.transform_point(
        lib.normalize(a), b[..., 5:]),
}


@pytest.mark.parametrize('name', sorted(DUAL_QUATERNION_CASES))
def test_dual_quaternion_function_matches_jax(name):
  a, b = _dqs(7), _dqs(8)
  fn = DUAL_QUATERNION_CASES[name]
  got = fn(tdq, t(a), t(b))
  want = fn(jdq, jnp.asarray(a), jnp.asarray(b))
  close(got, want, atol=1e-6, rtol=1e-6, msg=name)
  close(tdq.identity(), jdq.identity())


@pytest.mark.parametrize('scale', [1e-4, 0.7], ids=['init_angles', 'large'])
def test_dual_quat_motion_matches_jax(scale):
  """Every method of the motion surface, through the ``rigid`` dispatch;
  θ ~ 1e-4 takes the Taylor branch of ``axis``."""
  raw = randn(9, 6, 4)
  raw[:, :3] *= scale
  q, tr, x = raw, randn(10, 6, 3), randn(11, 6, 3)
  build = lambda lib, dq_lib, q, tr: dq_lib.DualQuatMotion(
      dq_lib.from_rotation_translation(lib.normalize(q), tr))
  jm = build(jquat, jdq, jnp.asarray(q), jnp.asarray(tr))
  tm = build(tquat, tdq, t(q), t(tr))
  for fn in ('rotate', 'rotate_inverse', 'transform_point'):
    close(getattr(trigid, fn)(tm, t(x)), getattr(jrigid, fn)(jm, x),
          atol=1e-6, rtol=1e-5, msg=fn)
  close(trigid.translation(tm), jrigid.translation(jm), atol=1e-6, rtol=1e-5)
  close(tm.axis, jm.axis, atol=1e-5, rtol=1e-5)


# -- L3: the warp fields and their Jacobians ----------------------------------

FIELD_KW = dict(min_deg=0, max_deg=4)
RIGID_KW = dict(trunk_depth=3, trunk_width=16, skips=(2,))


def _fields():
  """(JAX field, port field class, port kwargs, head names) per type."""
  return {
      'se3': (jwarp.SE3Field(**FIELD_KW, **RIGID_KW), twarp.SE3Field,
              dict(FIELD_KW, **RIGID_KW), ('w', 'v')),
      'dual_quaternion': (jwarp.DualQuaternionField(**FIELD_KW, **RIGID_KW),
                          twarp.DualQuaternionField,
                          dict(FIELD_KW, **RIGID_KW), ('q', 't')),
      'translation': (jwarp.TranslationField(**FIELD_KW, depth=3, width=16,
                                             skips=(2,)),
                      twarp.TranslationField,
                      dict(FIELD_KW, depth=3, width=16, skips=(2,)), ()),
  }


@pytest.mark.parametrize('kind', ['se3', 'dual_quaternion', 'translation'])
@pytest.mark.parametrize('head_scale', [1.0, 1e3], ids=['init', 'far'])
def test_warp_and_warp_jacobian_match_jax(kind, head_scale):
  """At the JAX init the warp is near the identity (J ≈ I); with the heads
  scaled the motion is far from it and J is not."""
  jfield, tcls, kw, heads = _fields()[kind]
  params = jax.device_get(jfield.init(jax.random.PRNGKey(3), 9))
  for head in heads:
    params[head]['kernel'] = params[head]['kernel'] * head_scale
  if kind == 'translation':
    params['mlp']['logit']['kernel'] = (params['mlp']['logit']['kernel']
                                        * head_scale)
  tfield = tcls(9, **kw)
  tfield.load_state_dict(params_from_jax(params))
  pts, embed = randn(12, 20, 3, scale=0.5), randn(13, 20, 9, scale=0.1)
  for alpha in (None, 2.5):
    want_j = jfield.warp_jacobian(params, jnp.asarray(pts),
                                  jnp.asarray(embed), alpha)
    got_j = tfield.warp_jacobian(t(pts), t(embed), alpha)
    assert got_j.shape == (20, 3, 3)
    close(got_j, want_j, atol=1e-5, rtol=1e-5, msg=f'{kind} {alpha}')
    close(tfield.warp(t(pts), t(embed), alpha),
          jfield.warp(params, jnp.asarray(pts), jnp.asarray(embed), alpha),
          atol=1e-5, rtol=1e-5)
  if head_scale == 1.0:
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (20, 3, 3))
    close(got_j, eye, atol=6e-2, rtol=0)
  else:
    assert float((got_j.detach() - torch.eye(3)).abs().max()) > 0.1
  if kind == 'dual_quaternion':
    jm = jfield.motion(params, jnp.asarray(pts), jnp.asarray(embed))
    tm = tfield.motion(t(pts), t(embed))
    close(tm.dq, jm.dq, atol=1e-6, rtol=1e-5)
    assert tfield.screw == tfield.motion


# -- L3: the model's render, both levels --------------------------------------

TOY = dict(num_coarse_samples=6, num_fine_samples=4, nerf_trunk_depth=3,
           nerf_trunk_width=32, nerf_skips=(2,), se3_trunk_depth=3,
           se3_trunk_width=16, se3_skips=(2,), hyper_sheet_depth=3,
           hyper_sheet_width=16, hyper_sheet_skips=(2,), mask_mlp_depth=3,
           mask_mlp_width=16, mask_skips=(2,), use_stratified_sampling=False)
# Axis-aligned-plane slicing reads the hyper embedding as the coordinates,
# so the embedding is hyper_num_dims wide: a table of its own.
AP = dict(hyper_slice_method='axis_aligned_plane', hyper_use_warp_embed=False,
          hyper_embed_dims=2)
CONFIGS = {
    'hypernerf_ds': ('hypernerf', {}),
    'hypernerf_ap': ('hypernerf', AP),
    'hypernerf_dual_quaternion': ('hypernerf',
                                  dict(warp_field_type='dual_quaternion')),
    'hypernerf_translation': ('hypernerf',
                              dict(warp_field_type='translation')),
    'nerf_ds_dual_quaternion': ('nerf_ds', dict(
        warp_field_type='dual_quaternion', sigma_gradient_mode='fused')),
}
ATOL, RTOL = 1e-5, 1e-4
TOLERANCE = {
    # As in test_torch_render: the normal head's raw outputs are O(10) at
    # init, and normalize(∇σ) amplifies rounding where |∇σ| is small.
    'predicted_norm': (1e-4, 1e-4),
    'back_facing': (1e-4, 1e-4),
    'target_norm': (1e-3, 1e-3),
    'norm_input': (1e-4, 1e-4),
}


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


def to_torch(rays):
  return {k: ({m: torch.from_numpy(a) for m, a in v.items()}
              if isinstance(v, dict) else torch.from_numpy(v))
          for k, v in rays.items()}


@functools.lru_cache(maxsize=None)
def jax_init(name, **extra):
  """The JAX model and its init params, once per configuration."""
  preset, overrides = CONFIGS[name]
  jmodel = JaxModel(config=dataclasses.replace(
      getattr(jconfig, preset)(), **{**TOY, **overrides, **extra}),
                    num_warp_embeds=NUM_EMBEDS, num_hyper_embeds=NUM_EMBEDS)
  return jmodel, jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0)))


def model_pair(name, **extra):
  preset, overrides = CONFIGS[name]
  kw = {**TOY, **overrides, **extra}
  jmodel, params = jax_init(name, **extra)
  tmodel = TorchModel(dataclasses.replace(getattr(tconfig, preset)(), **kw,
                                          use_pallas_compositing=True),
                      num_warp_embeds=NUM_EMBEDS, num_hyper_embeds=NUM_EMBEDS,
                      device='cpu')
  tmodel.load_state_dict(params_from_jax(params))
  return jmodel, params, tmodel


@pytest.fixture(scope='module', params=sorted(CONFIGS))
def renders(request):
  jmodel, params, tmodel = model_pair(request.param)
  rays = make_rays(8)
  render = jax.jit(lambda p, r: jmodel.render(
      p, r, jax.random.PRNGKey(1), jax_extra(jmodel.config),
      return_full=True, return_points=True, return_warp_jacobian=True))
  jax_out = jax.device_get(render(params, jax.tree_util.tree_map(
      jnp.asarray, rays)))
  with torch.no_grad():
    torch_out = tmodel.render(to_torch(rays), torch_extra(tmodel.config),
                              return_full=True, return_points=True,
                              return_warp_jacobian=True)
  return request.param, jax_out, torch_out


@pytest.mark.parametrize('level', ['coarse', 'fine'])
def test_render_matches_jax_on_every_key(renders, level):
  name, jax_out, torch_out = renders
  want, got = jax_out[level], torch_out[level]
  assert set(got) == set(want)
  assert got['warp_jacobian'].shape == (8, got['points'].shape[1], 3, 3)
  if name.startswith('nerf_ds'):
    assert 'target_norm' in got
  for k in sorted(want):
    atol, rtol = TOLERANCE.get(k, (ATOL, RTOL))
    np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                               atol=atol, rtol=rtol,
                               err_msg=f'{name}/{level}/{k}')


def test_warp_jacobian_levels_and_apply_warp():
  """``return_warp_jacobian`` names the levels; ``apply_warp`` warps
  background points with the mask channel at 0, as JAX's."""
  jmodel, params, tmodel = model_pair('nerf_ds_dual_quaternion')
  rays = to_torch(make_rays(4, seed=2))
  with torch.no_grad():
    out = tmodel.render(rays, torch_extra(tmodel.config),
                        return_warp_jacobian=('coarse',))
  assert 'warp_jacobian' in out['coarse']
  assert 'warp_jacobian' not in out['fine']
  pts = randn(14, 10, 3, scale=0.5)
  ids = np.random.RandomState(15).randint(0, NUM_EMBEDS, (10, 1))
  want = jmodel.apply_warp(params, jnp.asarray(pts), jnp.asarray(ids),
                           jax_extra(jmodel.config))
  with torch.no_grad():
    got = tmodel.apply_warp(t(pts), t(ids), torch_extra(tmodel.config))
  close(got, want, atol=1e-5, rtol=1e-5)


def test_axis_aligned_plane_width_mismatch_raises_as_in_jax():
  """With the warp embedding (8 wide) as the hyper coordinates and
  hyper_num_dims=2, both packages refuse at the trunk's first layer: JAX
  where it slices the kernel's rows, the port before it."""
  jmodel, params, tmodel = model_pair(
      'hypernerf_ap', hyper_use_warp_embed=True)
  rays = make_rays(2)
  with pytest.raises(TypeError, match='slice limit_indices'):
    jax.jit(lambda p, r: jmodel.render(p, r, jax.random.PRNGKey(1),
                                       jax_extra(jmodel.config)))(
        params, jax.tree_util.tree_map(jnp.asarray, rays))
  with pytest.raises(ValueError,
                     match='feature blocks sum to 64, kernel rows 52'):
    tmodel.render(to_torch(rays), torch_extra(tmodel.config))


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_init_matches_param_tree_and_round_trips(name):
  """The port's init has JAX's param tree (no hyper sheet under
  axis-aligned slicing; ``q``/``t`` and ``mlp`` heads), and the trees
  convert both ways."""
  jmodel, params, tmodel = model_pair(name)
  fresh = params_to_jax(TorchModel(tmodel.config, num_warp_embeds=NUM_EMBEDS,
                                   num_hyper_embeds=NUM_EMBEDS,
                                   device='cpu').state_dict())
  jflat = jax.tree_util.tree_flatten_with_path(params)[0]
  tflat = jax.tree_util.tree_flatten_with_path(fresh)[0]
  assert [p for p, _ in jflat] == [p for p, _ in tflat]
  for (path, a), (_, b) in zip(jflat, tflat):
    assert a.shape == b.shape, path
  assert ('hyper_sheet' in fresh) == (name != 'hypernerf_ap')
  back = params_to_jax(params_from_jax(params))
  jax.tree_util.tree_map(np.testing.assert_array_equal, params, back)
