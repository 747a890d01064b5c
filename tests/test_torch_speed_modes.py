"""The speed and precision modes of the port against the JAX package: bf16
storage and compute in the MLP stack, the zone table, every
``quality_ablate`` case rendered at both levels, ``norm_grad_topk`` through
one training step, the warning of an inactive top-k, and the eval render's
exact ∇σ.

The toy ``nerf_ds`` of ``tests/test_torch_render.py`` (every MLP 3 layers
with a skip, 6 + 4 samples, unstratified) in ``sigma_gradient_mode='vmap'``,
the preset's mode and the one where top-k acts. The JAX renders of the
cases are made in a child process with ``--xla_allow_excess_precision=false``:
by default XLA's CPU compiler keeps float32 where a jitted program casts a
value to bf16 and back, so jitted JAX does not round where the JAX
package's own code (and eager JAX, and the port) rounds, and in the trunk
zone's cases most elements of ``target_norm`` then differ from eager JAX's
beyond the float32 tolerance. With the flag, jitted JAX rounds as written.
"""
import dataclasses
import logging
import os
import pickle
import subprocess
import sys

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
from nerfds_torch.convert import params_from_jax
from nerfds_torch.evaluation import render as trender
from nerfds_torch.models import NerfDSModel as TorchModel
from nerfds_torch.models import default_extra_params as torch_extra
from nerfds_torch.models import mlp as tmlp
from nerfds_torch.models import nerfds as tnerfds
from nerfds_torch.quality_ablate import CASES
from nerfds_torch.training import step as tstep

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))

TOY = dict(num_coarse_samples=6, num_fine_samples=4, nerf_trunk_depth=3,
           nerf_trunk_width=32, nerf_skips=(2,), se3_trunk_depth=3,
           se3_trunk_width=16, se3_skips=(2,), hyper_sheet_depth=3,
           hyper_sheet_width=16, hyper_sheet_skips=(2,), mask_mlp_depth=3,
           mask_mlp_width=16, mask_skips=(2,), use_stratified_sampling=False,
           sigma_gradient_mode='vmap')
NUM_EMBEDS = 4
NUM_RAYS = 8
TOPK = 3  # below both levels' sample counts, so top-k selects
# Every quality_ablate case, and top-k at k = 3.
RENDER_CASES = {**CASES, 'topk3': {'norm_grad_topk': TOPK}}
BF16_CASES = {name for name, o in RENDER_CASES.items()
              if 'compute_dtype' in o or 'storage_dtype' in o}

# float32 tolerance per key, as tests/test_torch_render.py states them:
# XLA and torch sum in another order, through two levels.
ATOL, RTOL = 1e-5, 1e-4
TOLERANCE = {
    'predicted_norm': (1e-4, 1e-4),  # the normal head's outputs are O(1)
    'back_facing': (1e-4, 1e-4),
    'target_norm': (1e-3, 1e-3),     # normalize(∇σ) amplifies rounding
    'norm_input': (1e-4, 1e-4),
}
# bf16 cases: XLA and torch round the same bf16 values, but a sum that lies
# within float32 rounding of a bf16 rounding boundary may round the other
# way, one bf16 step, and carry on through the later layers. So every
# element must lie within BF16_RENDER_STEP of the key's largest magnitude
# (measured: at most 1.22e-3, storage_bf16's fine norm_input), and at most
# BF16_BAD_FRAC of a key's elements beyond the float32 tolerance (at most
# 4.2%, bf16_all's coarse ray_norm). With any one zone of a case left in
# float32 the port breaks one of the two at some level
# (test_bf16_tolerance_tells_the_modes_apart; nearest, where the step
# alone tells: 2.85e-3, storage_bf16 with its hyper zone left out).
BF16_RENDER_STEP = 2.0 ** -9
# One bf16 step of a tensor's largest magnitude (the MLP stack's test).
BF16_STEP = 2.0 ** -7
BF16_BAD_FRAC = 0.08
ZONES = ('warp', 'hyper', 'mask', 'trunk', 'rgb')


def make_rays(num_rays=NUM_RAYS, seed=0):
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


def to_torch(tree):
  return {k: to_torch(v) if isinstance(v, dict) else torch.from_numpy(
      np.array(v)) for k, v in tree.items()}


def jax_model(**overrides):
  return JaxModel(config=dataclasses.replace(jconfig.nerf_ds(),
                                             **{**TOY, **overrides}),
                  num_warp_embeds=NUM_EMBEDS, num_hyper_embeds=NUM_EMBEDS)


def torch_model(params, **overrides):
  model = TorchModel(dataclasses.replace(tconfig.nerf_ds(),
                                         **{**TOY, **overrides}),
                     num_warp_embeds=NUM_EMBEDS, num_hyper_embeds=NUM_EMBEDS,
                     device='cpu')
  model.load_state_dict(params_from_jax(params))
  return model


def train_batch():
  rng = np.random.RandomState(0)
  batch = make_rays(8, seed=4)
  batch['rgb'] = rng.rand(8, 3).astype(np.float32)
  return batch


def toy_train_cfg(lib):
  """The preset's losses with schedules mid-way at step 0 and the normal
  loss at weight 1, where a wrong top-k term could not hide."""
  return dataclasses.replace(
      lib.nerf_ds_train_config(max_steps=200, batch_size=8),
      warp_alpha_schedule=('linear', 1.5, 4, 50),
      norm_input_alpha_schedule=('constant', 2.5),
      sharp_mask_std_schedule=('constant', 0.5),
      lr_schedule=('exponential', 5e-3, 1e-4, 200),
      norm_loss_weight_schedule=('constant', 1.0))


def mlp_pair(seed=0):
  kw = dict(trunk_depth=3, trunk_width=32, skips=(2,), rgb_branch_depth=1,
            rgb_branch_width=16, predict_norm=True)
  jm = jmlp.NerfMLP(**kw)
  params = jax.device_get(jm.init(jax.random.PRNGKey(seed), 12, 0, 10, True))
  tm = tmlp.NerfMLP(12, 0, 10, True, **kw)
  tm.load_state_dict(params_from_jax(params))
  return jm, params, tm


def mlp_inputs():
  rng = np.random.RandomState(1)
  return (rng.randn(13, 12).astype(np.float32),
          rng.randn(13, 7).astype(np.float32),
          rng.randn(13, 3).astype(np.float32))


def jax_mlp_loss(jm, mode):
  """The staged NerfMLP queries in bf16 ``mode`` ('dtype' or
  'storage_dtype') and a loss on their outputs."""
  x_np, cond, norm = mlp_inputs()
  kw = {mode: jnp.bfloat16}
  sigma_kw = {'dtype': jnp.bfloat16} if mode == 'dtype' else {}

  def loss(p, x):
    t, b = jm.query_bottleneck(p, [x[:, :8], x[:, 8:]], **kw)
    s, n = jm.query_sigma(p, t, b, **sigma_kw)
    r = jm.query_rgb(p, t, b, [jnp.asarray(cond)], None, None,
                     jnp.asarray(norm), **kw)
    return jnp.sum(s ** 2) + jnp.sum(n * 0.5) + jnp.sum(jnp.sin(r)), (s, n, r)

  return loss


# The JAX side runs in JAX_PARTS child processes at once (tracing holds
# the interpreter, so threads would wait on each other): parts 0-2 render
# a third of the cases each, part 3 differentiates the top-k loss, part 4
# runs make_train_step, the MLP stack and quantize_storage.
JAX_PARTS = 5


def jax_reference_main(out_path, part):
  """A child process: part ``part`` of the JAX results, pickled to
  ``out_path``."""
  jax.config.update('jax_platforms', 'cpu')
  params = jax.device_get(jax.jit(jax_model().init)(jax.random.PRNGKey(0)))
  out = {'params': params}
  if part < 3:
    rays = jax.tree_util.tree_map(jnp.asarray, make_rays())
    out['renders'] = {}
    for name in list(RENDER_CASES)[part::3]:
      model = jax_model(**RENDER_CASES[name])
      fn = jax.jit(lambda p, r, m=model: m.render(
          p, r, jax.random.PRNGKey(1), jax_extra(m.config), return_full=True,
          return_points=True, compute_sigma_gradient=True))
      out['renders'][name] = jax.device_get(fn(params, rays))
  batch = jax.tree_util.tree_map(jnp.asarray, train_batch())
  jmodel, cfg = jax_model(norm_grad_topk=TOPK), toy_train_cfg(jconfig)
  if part == 3:
    scalars = jstep.eval_schedules(jstep.build_schedules(cfg), 0)
    (_, stats), grads = jax.jit(jax.value_and_grad(
        jstep.make_loss_fn(jmodel, cfg), has_aux=True))(
            params, batch, jax.random.PRNGKey(1), scalars)
    out['train'] = jax.device_get({'stats': stats, 'grads': grads})
  if part == 4:
    state, _ = jstep.make_train_step(jmodel, cfg, donate=False)(
        jstep.TrainState.create(params), batch, jax.random.PRNGKey(1))
    out['train_state_params'] = jax.device_get(state.params)
    jm, mparams, _ = mlp_pair()
    out['mlp'] = {}
    for mode in ('dtype', 'storage_dtype'):
      (_, outs), grads = jax.jit(jax.value_and_grad(
          jax_mlp_loss(jm, mode), argnums=(0, 1), has_aux=True))(
              mparams, jnp.asarray(mlp_inputs()[0]))
      out['mlp'][mode] = jax.device_get((outs, grads))
    x = jnp.asarray(quantize_input())
    f = lambda v: jnp.sum(jmlp.quantize_storage(v, jnp.bfloat16) ** 3)
    out['quantize'] = jax.device_get((
        jax.jit(lambda v: jmlp.quantize_storage(v, jnp.bfloat16))(x),
        jax.jit(jax.grad(f))(x),
        jax.jit(jax.grad(lambda v: jnp.sum(jax.grad(f)(v) ** 2)))(x)))
  with open(out_path, 'wb') as fp:
    pickle.dump(out, fp)


def quantize_input():
  return np.random.RandomState(0).randn(8, 16).astype(np.float32)


@pytest.fixture(scope='module')
def jax_ref(tmp_path_factory):
  """Every JAX result of this file, from the child processes."""
  tmp = tmp_path_factory.mktemp('speed_modes')
  env = dict(os.environ, JAX_PLATFORMS='cpu')
  env['XLA_FLAGS'] = (env.get('XLA_FLAGS', '')
                      + ' --xla_allow_excess_precision=false').strip()
  code = ('import sys; sys.path[:0] = sys.argv[1:3]; '
          'import test_torch_speed_modes as m; '
          'm.jax_reference_main(sys.argv[3], int(sys.argv[4]))')
  procs = [subprocess.Popen([sys.executable, '-c', code, HERE,
                             os.path.dirname(HERE), str(tmp / f'{part}.pkl'),
                             str(part)], env=env)
           for part in range(JAX_PARTS)]
  for proc in procs:
    assert proc.wait(timeout=600) == 0
  ref = {'renders': {}}
  for part in range(JAX_PARTS):
    with open(tmp / f'{part}.pkl', 'rb') as fp:
      got = pickle.load(fp)
    ref['renders'].update(got.pop('renders', {}))
    ref.update(got)
  return ref


def port_render(params, overrides, **kwargs):
  model = torch_model(params, **overrides)
  with torch.no_grad():
    return model.render(to_torch(make_rays()), torch_extra(model.config),
                        return_full=True, return_points=True,
                        compute_sigma_gradient=True, **kwargs)


def mismatches(got, want, bf16):
  """Keys of one level that break the case's tolerance (module constants)."""
  bad = []
  for k in sorted(want):
    w, g = np.asarray(want[k]), got[k].numpy()
    if k == 'norm_topk_idx':
      if not np.array_equal(g, w):
        bad.append(k)
      continue
    atol, rtol = TOLERANCE.get(k, (ATOL, RTOL))
    beyond = np.abs(g - w) > atol + rtol * np.abs(w)
    if not bf16:
      if beyond.any():
        bad.append(k)
    elif (np.abs(g - w).max() > BF16_RENDER_STEP * np.abs(w).max()
          or beyond.mean() > BF16_BAD_FRAC):
      bad.append(k)
  return bad


@pytest.mark.parametrize('case', list(RENDER_CASES))
def test_render_matches_jax_for_every_case(jax_ref, case):
  want = jax_ref['renders'][case]
  got = port_render(jax_ref['params'], RENDER_CASES[case])
  for level in ('coarse', 'fine'):
    assert set(got[level]) == set(want[level]), level
    if 'norm_grad_topk' in RENDER_CASES[case]:
      k = min(RENDER_CASES[case]['norm_grad_topk'],
              want[level]['sigma'].shape[1])
      assert got[level]['target_norm'].shape == (NUM_RAYS, k, 3)
    assert not mismatches(got[level], want[level], case in BF16_CASES), (
        level, mismatches(got[level], want[level], case in BF16_CASES))


def one_zone_in_f32(overrides):
  """(zone, overrides) of a bf16 case with each of its zones in turn left
  in float32 (the float32 model where that was its only zone)."""
  key = 'storage_zones' if 'storage_dtype' in overrides else 'bf16_zones'
  zones = overrides.get(key) or ZONES
  for zone in zones:
    rest = tuple(z for z in zones if z != zone)
    yield zone, ({**overrides, key: rest} if rest else {})


def test_bf16_tolerance_tells_the_modes_apart(jax_ref):
  """For every bf16 case, the port with any one of the case's zones left in
  float32 breaks the case's tolerance against JAX's render at one level at
  least, so the tolerance would catch a zone whose dtype is not threaded
  through its MLP."""
  for case in sorted(BF16_CASES):
    want = jax_ref['renders'][case]
    for zone, overrides in one_zone_in_f32(RENDER_CASES[case]):
      got = port_render(jax_ref['params'], overrides)
      assert any(mismatches(got[level], want[level], bf16=True)
                 for level in ('coarse', 'fine')), (case, zone)


def test_eval_render_takes_exact_gradient_under_topk(jax_ref):
  """With ∇σ asked for, the eval renderer of a top-k model returns the
  full-sample target_norm: JAX's exact (f32 case) render."""
  model = torch_model(jax_ref['params'], norm_grad_topk=TOPK)
  render_fn = trender.make_render_fn(model, compute_sigma_gradient=True)
  rays = to_torch(make_rays())
  rays['metadata'] = model.encode_metadata(rays['metadata'])
  got = render_fn(rays, torch_extra(model.config))
  want = jax_ref['renders']['f32']
  for level in ('coarse', 'fine'):
    assert 'norm_topk_idx' not in got[level]
    np.testing.assert_allclose(got[level]['target_norm'].numpy(),
                               want[level]['target_norm'], atol=1e-3,
                               rtol=1e-3, err_msg=level)


def test_inactive_topk_warns_and_runs_the_exact_path(jax_ref, caplog):
  params = jax_ref['params']
  exact = port_render(params, {'sigma_gradient_mode': 'fused'})
  with caplog.at_level(logging.WARNING, logger=tnerfds.__name__):
    got = port_render(params, {'sigma_gradient_mode': 'fused',
                               'norm_grad_topk': TOPK})
  assert 'INACTIVE' in caplog.text
  for level in ('coarse', 'fine'):
    assert set(got[level]) == set(exact[level])
    for k, v in exact[level].items():
      assert torch.equal(got[level][k], v), (level, k)


def test_topk_index_takes_the_lower_index_first_among_ties():
  """jax.lax.top_k's order among equal weights (zeros are common)."""
  rng = np.random.RandomState(3)
  w = rng.choice([0.0, 0.25, 0.5], size=(16, 10)).astype(np.float32)
  _, want = jax.lax.top_k(jnp.asarray(w), 4)
  got = tnerfds.topk_indices(torch.from_numpy(w), 4)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_topk_train_step_matches_jax(jax_ref):
  """norm_grad_topk at k = 3: the norm loss, every stat and every
  parameter's gradient of one training step against JAX's, then the
  params after a step of make_train_step."""
  params = jax_ref['params']
  model = torch_model(params, norm_grad_topk=TOPK)
  cfg = toy_train_cfg(tconfig)
  tparams = params_from_jax(params)
  batch = to_torch(train_batch())
  grads, stats = tstep._grads(
      tstep.make_loss_fn(model, cfg), tparams, batch, None,
      tstep.eval_schedules(tstep.build_schedules(cfg), 0))
  jstats = jax_ref['train']['stats']
  for level in ('coarse', 'fine'):
    assert set(stats[level]) == set(jstats[level])
    assert float(jstats[level]['loss/norm_diff']) > 0
    for k, w in jstats[level].items():
      np.testing.assert_allclose(float(stats[level][k]), float(w),
                                 rtol=1e-4, atol=1e-6, err_msg=f'{level}/{k}')
  # Gradients relative to each tensor's norm, as in
  # tests/test_torch_training.py: float32 through two levels and a second
  # order path, summed in another order.
  want = params_from_jax(jax_ref['train']['grads'])
  assert set(grads) == set(want)
  for name, w in want.items():
    rel = float((grads[name] - w).norm() / w.norm().clamp_min(1e-12))
    assert rel < 1e-3, (name, rel)
  # Adam's first step is about lr·sign(g): the grads' rounding shows as
  # about 1e-5, a sign flip of a tiny grad as 1e-2.
  state, _ = tstep.make_train_step(model, cfg)(tstep.TrainState.create(
      tparams), batch)
  for name, w in params_from_jax(jax_ref['train_state_params']).items():
    torch.testing.assert_close(state.params[name], w, rtol=0, atol=1e-4,
                               msg=name)


def test_quantize_storage_and_its_second_derivative_match_jax(jax_ref):
  want_q, want_g, want_h = jax_ref['quantize']
  xt = torch.from_numpy(quantize_input())
  q = tmlp.quantize_storage(xt, torch.bfloat16)
  np.testing.assert_array_equal(q.numpy(), want_q)
  assert float((q - xt).abs().max()) > 0 and q.dtype == torch.float32
  assert tmlp.quantize_storage(xt, None) is xt
  v = xt.clone().requires_grad_()
  (g,) = torch.autograd.grad(
      (tmlp.quantize_storage(v, torch.bfloat16) ** 3).sum(), v,
      create_graph=True)
  (h,) = torch.autograd.grad((g ** 2).sum(), v)
  # Each cast rounds its cotangent to bf16 on the way back in both
  # packages; the products around them are float32.
  np.testing.assert_allclose(g.detach().numpy(), want_g, rtol=1e-6)
  np.testing.assert_allclose(h.numpy(), want_h, rtol=1e-5)


@pytest.mark.parametrize('mode', ['dtype', 'storage_dtype'])
def test_mlp_stack_bf16_modes_match_jax(jax_ref, mode):
  """NerfMLP's staged queries (trunk with a skip and two feature blocks,
  bottleneck, σ/normal head, rgb branch) in bf16 compute or bf16 storage:
  the outputs and the grads of every parameter and of the input."""
  jouts, (jgp, jgx) = jax_ref['mlp'][mode]
  _, _, tm = mlp_pair()
  x, cond, norm = mlp_inputs()
  tkw = {mode: torch.bfloat16}
  sigma_kw = {'dtype': torch.bfloat16} if mode == 'dtype' else {}
  xt = torch.from_numpy(x).requires_grad_()
  t, b = tm.query_bottleneck([xt[:, :8], xt[:, 8:]], **tkw)
  s, n = tm.query_sigma(t, b, **sigma_kw)
  r = tm.query_rgb(t, b, [torch.from_numpy(cond)], None, None,
                   torch.from_numpy(norm), **tkw)
  assert s.dtype == n.dtype == r.dtype == torch.float32
  loss = (s ** 2).sum() + (n * 0.5).sum() + torch.sin(r).sum()
  names = [k for k, _ in tm.named_parameters()]
  got = dict(zip([*names, 'x'], torch.autograd.grad(
      loss, [*tm.parameters(), xt])))
  want = {**params_from_jax(jgp), 'x': torch.from_numpy(np.array(jgx))}
  assert set(got) == set(want)
  # Both sides round the same bf16 values; torch's CPU bf16 matmul and
  # XLA's may sum in another order, which moves a value by one bf16 step
  # where a sum lies at a rounding boundary. Tolerance: one bf16 step
  # (2^-7) of each tensor's largest magnitude.
  for g, w in zip((s, n, r), jouts):
    w = np.asarray(w, np.float32)
    np.testing.assert_allclose(g.detach().numpy(), w, rtol=0,
                               atol=BF16_STEP * np.abs(w).max())
  for k, w in want.items():
    np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                               atol=BF16_STEP * float(w.abs().max()),
                               err_msg=k)


@pytest.mark.parametrize('config', [
    {},
    {'compute_dtype': 'bfloat16'},
    {'compute_dtype': 'bfloat16', 'bf16_zones': ('trunk', 'rgb', 'mask')},
    {'storage_dtype': 'bfloat16'},
    {'storage_dtype': 'bfloat16', 'storage_zones': ('warp', 'trunk')},
    {'compute_dtype': 'bfloat16', 'bf16_zones': ('trunk',),
     'storage_dtype': 'bfloat16'},
])
def test_zone_dtypes_match_jax(config):
  jm = JaxModel(config=dataclasses.replace(jconfig.nerf_ds(), **config))
  tm = TorchModel(dataclasses.replace(tconfig.nerf_ds(), **TOY, **config),
                  device='cpu')
  as_name = lambda d: None if d is None else jnp.dtype(d).name
  for zone in ('warp', 'hyper', 'mask', 'trunk', 'rgb'):
    want = (as_name(jm.cdtype_for(zone)), as_name(jm.sdtype_for(zone)))
    got = tuple(None if d is None else str(d).replace('torch.', '')
                for d in (tm.cdtype_for(zone), tm.sdtype_for(zone)))
    assert got == want, zone


def test_unsupported_storage_dtype_raises_as_in_jax():
  cfg = dataclasses.replace(tconfig.nerf_ds(), **TOY, storage_dtype='float16')
  with pytest.raises(ValueError, match='storage_dtype'):
    TorchModel(cfg, device='cpu').sdtype_for('trunk')
  with pytest.raises(ValueError, match='storage_dtype'):
    JaxModel(config=dataclasses.replace(
        jconfig.nerf_ds(), storage_dtype='float16')).sdtype_for('trunk')
