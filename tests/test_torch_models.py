"""Modules, config, conversion and packaging of the PyTorch port against
the JAX package.

Each module test initialises the JAX module, copies its params into the
port with ``params_from_jax`` and feeds both the same numpy inputs, float32
on both sides. Tolerance atol 1e-5 / rtol 1e-4 unless stated: dense layers
sum in another order in XLA and in torch.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfds_tpu import config as jconfig
from nerfds_tpu.models import embeddings as jemb
from nerfds_tpu.models import hyper as jhyper
from nerfds_tpu.models import mlp as jmlp
from nerfds_tpu.models import warp as jwarp
from nerfds_tpu.models.nerfds import NerfDSModel as JaxModel
from nerfds_torch import config as tconfig
from nerfds_torch.convert import params_from_jax, params_to_jax
from nerfds_torch.models import embeddings as temb
from nerfds_torch.models import hyper as thyper
from nerfds_torch.models import mlp as tmlp
from nerfds_torch.models import warp as twarp
from nerfds_torch.models.nerfds import NerfDSModel as TorchModel

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def t(x):
  return torch.from_numpy(np.array(x))


def close(got, want, atol=1e-5, rtol=1e-4):
  if isinstance(got, torch.Tensor):
    got = got.detach().numpy()
  np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def load(module, jax_params):
  module.load_state_dict(params_from_jax(jax.device_get(jax_params)))
  return module


def randn(seed, *shape, scale=1.0):
  return (np.random.RandomState(seed).randn(*shape) * scale).astype(
      np.float32)


def test_mlp_with_skip_and_feature_blocks():
  jm = jmlp.MLP(depth=3, width=16, skips=(2,), output_channels=4,
                output_activation='softplus')
  params = jm.init(jax.random.PRNGKey(0), 11)
  tm = load(tmlp.MLP(11, 3, 16, (2,), output_channels=4,
                     output_activation='softplus'), params)
  a, b = randn(1, 9, 7), randn(2, 9, 4)
  close(tm([t(a), t(b)]), jm.apply(params, [jnp.asarray(a), jnp.asarray(b)]))
  x = np.concatenate([a, b], -1)
  close(tm(t(x)), jm.apply(params, jnp.asarray(x)))


def test_nerf_mlp_staged_queries():
  kw = dict(trunk_depth=3, trunk_width=32, skips=(2,), rgb_branch_depth=1,
            rgb_branch_width=16, predict_norm=True)
  jm = jmlp.NerfMLP(**kw)
  params = jm.init(jax.random.PRNGKey(1), 12, 0, 10, True)
  tm = load(tmlp.NerfMLP(12, 0, 10, True, **kw), params)
  x = [randn(3, 13, 8), randn(4, 13, 4)]
  cond, extra, norm = randn(5, 13, 4), randn(6, 13, 3), randn(7, 13, 3)
  jt, jb = jm.query_bottleneck(params, [jnp.asarray(v) for v in x])
  tt, tb = tm.query_bottleneck([t(v) for v in x])
  close(tt, jt)
  close(tb, jb)
  js, jn = jm.query_sigma(params, jt, jb)
  ts, tn = tm.query_sigma(tt, tb)
  close(ts, js)
  close(tn, jn)
  jr = jm.query_rgb(params, jt, jb, [jnp.asarray(cond)], [jnp.asarray(extra)],
                    None, jnp.asarray(norm))
  tr = tm.query_rgb(tt, tb, [t(cond)], [t(extra)], None, t(norm))
  close(tr, jr)


def test_se3_field_screw_and_warp():
  jf = jwarp.SE3Field(min_deg=0, max_deg=4, trunk_depth=3, trunk_width=16,
                      skips=(2,))
  params = jf.init(jax.random.PRNGKey(2), 9)
  # The tiny head init leaves θ ~ 1e-4; scale the heads so the rotation is
  # far from the identity and the test sees the Rodrigues terms.
  params = jax.tree_util.tree_map(lambda v: v, params)
  for head in ('w', 'v'):
    params[head]['kernel'] = params[head]['kernel'] * 1e3
  tf = load(twarp.SE3Field(9, min_deg=0, max_deg=4, trunk_depth=3,
                           trunk_width=16, skips=(2,)), params)
  pts, embed = randn(8, 20, 3, scale=0.5), randn(9, 20, 9, scale=0.1)
  for alpha in (None, 2.5):
    js = jf.screw(params, jnp.asarray(pts), jnp.asarray(embed), alpha)
    ts = tf.screw(t(pts), t(embed), alpha)
    # No zero row, where the norm's gradient differs (see test_torch_ops).
    assert float(ts.theta.detach().min()) > 0
    for a, b in zip(ts, js):
      close(a, b)
    close(tf.warp(t(pts), t(embed), alpha),
          jf.warp(params, jnp.asarray(pts), jnp.asarray(embed), alpha))


def test_hyper_sheet_and_mask_mlp():
  jh = jhyper.HyperSheetMLP(min_deg=0, max_deg=6, depth=3, width=16,
                            skips=(2,))
  hp = jh.init(jax.random.PRNGKey(3), 9)
  th = load(thyper.HyperSheetMLP(9, min_deg=0, max_deg=6, depth=3, width=16,
                                 skips=(2,)), hp)
  pts, embed = randn(10, 15, 3), randn(11, 15, 9, scale=0.1)
  close(th(t(pts), t(embed), alpha=3.0),
        jh.apply(hp, jnp.asarray(pts), jnp.asarray(embed), alpha=3.0),
        atol=1e-9)
  jmask = jhyper.MaskMLP(depth=3, width=16, skips=(2,))
  for embed_dim, use_embed in ((8, True), (0, False)):
    mp = jmask.init(jax.random.PRNGKey(4), embed_dim)
    # Larger output weights than the 1e-5 init, so the relu output is not 0.
    mp['mlp']['logit']['kernel'] = mp['mlp']['logit']['kernel'] * 1e5
    tmask = load(thyper.MaskMLP(embed_dim, depth=3, width=16, skips=(2,)),
                 mp)
    e = embed[:, :embed_dim]
    close(tmask(t(pts), t(e), alpha=4.0, use_embed=use_embed),
          jmask.apply(mp, jnp.asarray(pts), jnp.asarray(e), alpha=4.0,
                      use_embed=use_embed))


def test_glo_embed_clamp_and_interpolation():
  je = jemb.GLOEmbed(5, 4)
  params = je.init(jax.random.PRNGKey(5))
  te = load(temb.GLOEmbed(5, 4), params)
  ids = np.array([[0], [4], [7], [-2]], np.int32)  # 7 and -2 clamp
  close(te.encode(t(ids)), je.encode(params, jnp.asarray(ids)), atol=0)
  triple = np.array([[0, 3, 0.25], [4, 9, 0.5]], np.float32)
  close(te.encode(t(triple)), je.encode(params, jnp.asarray(triple)))


def small(cfg, **overrides):
  kw = dict(num_coarse_samples=6, num_fine_samples=4, nerf_trunk_depth=3,
            nerf_trunk_width=32, nerf_skips=(2,), se3_trunk_depth=3,
            se3_trunk_width=16, se3_skips=(2,), hyper_sheet_depth=3,
            hyper_sheet_width=16, hyper_sheet_skips=(2,), mask_mlp_depth=3,
            mask_mlp_width=16, mask_skips=(2,))
  kw.update(overrides)
  return dataclasses.replace(cfg, **kw)


@pytest.mark.parametrize('preset', ['nerf_ds', 'vanilla_nerf', 'hypernerf'])
def test_init_matches_param_tree(preset):
  jm = JaxModel(config=small(getattr(jconfig, preset)()), num_warp_embeds=4)
  jparams = jax.device_get(jm.init(jax.random.PRNGKey(0)))
  tm = TorchModel(small(getattr(tconfig, preset)()), num_warp_embeds=4,
                  device='cpu', generator=torch.Generator().manual_seed(0))
  tparams = params_to_jax(tm.state_dict())
  jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
  tflat = jax.tree_util.tree_flatten_with_path(tparams)[0]
  assert [p for p, _ in jflat] == [p for p, _ in tflat]
  for (path, a), (_, b) in zip(jflat, tflat):
    assert a.shape == b.shape, path
    if path[-1].key == 'bias':
      assert not b.any(), path
  # glorot bound of the NeRF trunk's first layer
  w0 = tparams['nerf']['coarse']['trunk']['hidden_0']['kernel']
  assert np.abs(w0).max() <= np.sqrt(6.0 / sum(w0.shape))


def test_convert_round_trip():
  jm = JaxModel(config=small(jconfig.nerf_ds()), num_warp_embeds=3)
  tree = jax.device_get(jm.init(jax.random.PRNGKey(1)))
  back = params_to_jax(params_from_jax(tree))
  jax.tree_util.tree_map(np.testing.assert_array_equal, tree, back)


# Every flag that the port once refused, each on nerf_ds() ('fused' ∇σ and
# K2 on their plain versions), and BASELINE config[0].
EVERY_FLAG = {
    'use_bone': dict(use_bone=True, bone_trunk_width=16,
                     bone_moving_mlp_width=16),
    'use_nerf_embed_rgb': dict(use_nerf_embed=True, use_rgb_condition=True),
    'use_nerf_embed_alpha': dict(use_nerf_embed=True, use_rgb_condition=True,
                                 use_alpha_condition=True),
    'norm_type_layer': dict(norm_type='layer'),
    'norm_type_group': dict(norm_type='group', nerf_trunk_width=64),
    'norm_type_batch': dict(norm_type='batch'),
    'remat_sigma_nothing': dict(remat_sigma=True),
    'remat_sigma_dots': dict(remat_sigma=True, remat_policy='dots'),
    'remat_feat': dict(remat_feat=True),
    'concat_dense_inputs': dict(concat_dense_inputs=True),
    'vanilla_nerf': None,
}


@pytest.mark.parametrize('flag', sorted(EVERY_FLAG))
def test_every_flag_builds_renders_and_steps(flag):
  """The model builds on the CPU, renders both levels and takes one training
  step with finite losses that moves the NeRF MLP, and the bone field or
  the appearance table where the flag adds one."""
  from nerfds_torch.models import default_extra_params
  from nerfds_torch.training import step as tstep
  if EVERY_FLAG[flag] is None:
    cfg = small(tconfig.vanilla_nerf(), use_pallas_compositing=True)
  else:
    cfg = small(tconfig.nerf_ds(), sigma_gradient_mode='fused',
                use_pallas_compositing=True, **EVERY_FLAG[flag])
  model = TorchModel(cfg, num_warp_embeds=3, num_hyper_embeds=3,
                     num_nerf_embeds=3, device='cpu')
  rng = np.random.RandomState(0)
  directions = rng.randn(6, 3).astype(np.float32)
  batch = {'origins': t(rng.randn(6, 3).astype(np.float32) * 0.1),
           'directions': t(directions / np.linalg.norm(
               directions, axis=-1, keepdims=True)),
           'metadata': {'warp': t(rng.randint(0, 3, (6, 1))),
                        'appearance': t(rng.randint(0, 3, (6, 1)))},
           'mask': t(rng.rand(6, 1).astype(np.float32)),
           'rgb': t(rng.rand(6, 3).astype(np.float32))}
  with torch.no_grad():
    out = model.render(batch, default_extra_params(cfg))
  assert set(out) == set(model.levels)
  for level in out.values():
    assert level['rgb'].shape == (6, 3)
    assert torch.isfinite(level['rgb']).all()
  train_cfg = tconfig.nerf_ds_train_config(max_steps=10, batch_size=6)
  state0 = tstep.TrainState.create(dict(model.named_parameters()))
  state1, stats = tstep.make_train_step(model, train_cfg)(state0, batch)
  assert np.isfinite(float(stats[model.levels[-1]]['loss/total']))
  moved = {name.split('.')[0] for name, p in state1.params.items()
           if float((p - state0.params[name]).abs().max()) > 0}
  assert 'nerf' in moved
  if cfg.use_bone:
    assert 'bone_warp_field' in moved
  if cfg.use_nerf_embed:
    assert 'nerf_embed' in moved


def test_entry_point_device_default():
  """Without device='cpu' the model goes to cuda, or raises with no card."""
  cfg = small(tconfig.nerf_ds())
  if torch.cuda.is_available():
    assert TorchModel(cfg).device.type == 'cuda'
  else:
    with pytest.raises(RuntimeError, match='CUDA'):
      TorchModel(cfg)


def _fields(cls):
  return [(f.name, f.default if f.default is not dataclasses.MISSING
           else f.default_factory()) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize('name', ['ModelConfig', 'TrainConfig', 'EvalConfig',
                                  'ExperimentConfig'])
def test_config_fields_and_defaults(name):
  assert _fields(getattr(tconfig, name)) == _fields(getattr(jconfig, name))


def test_config_presets_and_json_round_trip():
  for preset in ('vanilla_nerf', 'hypernerf', 'nerf_ds', 'nerf_ds_fast'):
    jc, tc = getattr(jconfig, preset)(), getattr(tconfig, preset)()
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc), preset
    # A model_config.json written by either package loads in the other.
    assert tconfig.model_config_from_dict(
        json.loads(jconfig.to_json(jc))) == tc
    assert jconfig.model_config_from_dict(
        json.loads(tconfig.to_json(tc))) == jc
  assert (dataclasses.asdict(jconfig.nerf_ds_train_config(1000, 256, True))
          == dataclasses.asdict(tconfig.nerf_ds_train_config(1000, 256, True)))
  jm, jt = jconfig.nerf_ds_pod(4)
  tm, tt = tconfig.nerf_ds_pod(4)
  assert dataclasses.asdict(jt) == dataclasses.asdict(tt)
  assert dataclasses.asdict(jm) == dataclasses.asdict(tm)


def test_port_imports_neither_jax_nor_the_jax_package():
  code = '''
import importlib, pkgutil, sys
sys.modules['jax'] = None
import nerfds_torch
for m in pkgutil.walk_packages(nerfds_torch.__path__, 'nerfds_torch.'):
  importlib.import_module(m.name)
bad = sorted(m for m in sys.modules
             if m.startswith(('nerfds_tpu', 'jax', 'jaxlib'))
             and sys.modules[m] is not None)
print('LOADED', bad)
assert not bad, bad
'''
  proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                        capture_output=True, text=True, timeout=300)
  assert proc.returncode == 0, proc.stderr
  assert 'LOADED []' in proc.stdout
