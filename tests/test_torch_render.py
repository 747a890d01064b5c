"""The slice as a whole: a toy ``nerf_ds`` rendered by the JAX package and by
the PyTorch port from the same weights and rays, with
``compute_sigma_gradient=True``.

JAX runs ``sigma_gradient_mode='fused'`` (its trunk kernel in Pallas
interpret mode on the CPU) with XLA compositing, under ``jax.jit``; the port
runs ``'fused'`` with ``use_pallas_compositing=True``, which on CPU tensors
take the kernels' plain versions. Sampling is unstratified, so neither side
draws random numbers. Every output key of both levels must agree.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfds_tpu import config as jconfig
from nerfds_tpu.evaluation import render as jrender
from nerfds_tpu.models import NerfDSModel as JaxModel
from nerfds_tpu.models import default_extra_params as jax_extra
from nerfds_torch import config as tconfig
from nerfds_torch.convert import params_from_jax
from nerfds_torch.evaluation import render as trender
from nerfds_torch.models import NerfDSModel as TorchModel
from nerfds_torch.models import default_extra_params as torch_extra

torch.set_num_threads(1)

# Every MLP keeps one skip; widths small enough for the CPU.
TOY = dict(num_coarse_samples=6, num_fine_samples=4, nerf_trunk_depth=3,
           nerf_trunk_width=32, nerf_skips=(2,), se3_trunk_depth=3,
           se3_trunk_width=16, se3_skips=(2,), hyper_sheet_depth=3,
           hyper_sheet_width=16, hyper_sheet_skips=(2,), mask_mlp_depth=3,
           mask_mlp_width=16, mask_skips=(2,), use_stratified_sampling=False,
           sigma_gradient_mode='fused')
NUM_EMBEDS = 4

# Default tolerance: float32 on both sides, matmuls and reductions summed
# in another order by XLA and by torch, through two levels.
ATOL, RTOL = 1e-5, 1e-4
TOLERANCE = {
    # The normal head's raw outputs are O(10) at init.
    'predicted_norm': (1e-4, 1e-4),
    'back_facing': (1e-4, 1e-4),
    # normalize(∇σ) amplifies rounding where |∇σ| is small.
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


@pytest.fixture(scope='module')
def models():
  jcfg = dataclasses.replace(jconfig.nerf_ds(), **TOY)
  tcfg = dataclasses.replace(tconfig.nerf_ds(), **TOY,
                             use_pallas_compositing=True)
  jmodel = JaxModel(config=jcfg, num_warp_embeds=NUM_EMBEDS,
                    num_hyper_embeds=NUM_EMBEDS)
  params = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
  tmodel = TorchModel(tcfg, num_warp_embeds=NUM_EMBEDS,
                      num_hyper_embeds=NUM_EMBEDS, device='cpu')
  tmodel.load_state_dict(params_from_jax(params))
  return jmodel, params, tmodel


@pytest.fixture(scope='module')
def renders(models):
  jmodel, params, tmodel = models
  rays = make_rays(8)
  render = jax.jit(lambda p, r: jmodel.render(
      p, r, jax.random.PRNGKey(1), jax_extra(jmodel.config), return_full=True,
      return_points=True, compute_sigma_gradient=True))
  jax_out = jax.device_get(render(params, jax.tree_util.tree_map(
      jnp.asarray, rays)))
  with torch.no_grad():
    torch_out = tmodel.render(to_torch(rays), torch_extra(tmodel.config),
                              return_full=True, return_points=True,
                              compute_sigma_gradient=True)
  return jax_out, torch_out


@pytest.mark.parametrize('level', ['coarse', 'fine'])
def test_render_matches_jax_on_every_key(renders, level):
  jax_out, torch_out = renders
  want, got = jax_out[level], torch_out[level]
  assert set(got) == set(want)
  assert 'target_norm' in got
  for k in sorted(want):
    atol, rtol = TOLERANCE.get(k, (ATOL, RTOL))
    np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                               atol=atol, rtol=rtol, err_msg=f'{level}/{k}')


def test_vmap_and_fused_agree_in_the_port(models, renders):
  _, _, tmodel = models
  _, fused = renders
  vmap_model = TorchModel(
      dataclasses.replace(tmodel.config, sigma_gradient_mode='vmap',
                          use_pallas_compositing=False),
      num_warp_embeds=NUM_EMBEDS, num_hyper_embeds=NUM_EMBEDS, device='cpu')
  vmap_model.load_state_dict(tmodel.state_dict())
  with torch.no_grad():
    vmap = vmap_model.render(to_torch(make_rays(8)),
                             torch_extra(tmodel.config), return_full=True,
                             return_points=True, compute_sigma_gradient=True)
  for level in ('coarse', 'fine'):
    for k, v in fused[level].items():
      atol, rtol = TOLERANCE.get(k, (ATOL, RTOL))
      torch.testing.assert_close(vmap[level][k], v, atol=atol, rtol=rtol,
                                 msg=f'{level}/{k}')


def test_toy_warp_has_no_zero_screw_row(models):
  """θ = ‖w_raw‖ has another gradient at 0 in JAX and torch; the toy
  widths must not produce such a row on the test's points."""
  _, _, tmodel = models
  rays = to_torch(make_rays(8))
  z = torch.linspace(0.2, 2.0, 6)
  pts = (rays['origins'][:, None] + z[:, None] * rays['directions'][:, None]
         ).reshape(-1, 3)
  embed = tmodel.warp_embed.encode(rays['metadata']['warp'])
  embed = embed.repeat_interleave(6, 0)
  with torch.no_grad():
    screw = tmodel.warp_field.screw(
        pts, torch.cat([embed, torch.zeros(len(pts), 1)], -1))
  assert float(screw.theta.min()) > 0


def test_fused_render_backpropagates_like_vmap(models):
  """Under autograd, 'fused' (the trunk Function, K1b's plain version)
  gives the parameter grads of 'vmap' for a loss that reads ∇σ."""
  _, _, tmodel = models
  vmap_model = TorchModel(
      dataclasses.replace(tmodel.config, sigma_gradient_mode='vmap',
                          use_pallas_compositing=False),
      num_warp_embeds=NUM_EMBEDS, num_hyper_embeds=NUM_EMBEDS, device='cpu')
  vmap_model.load_state_dict(tmodel.state_dict())
  rays = to_torch(make_rays(6, seed=5))

  def grads(model):
    out = model.render(rays, torch_extra(model.config),
                       compute_sigma_gradient=True)
    loss = sum((o['rgb'] ** 2).mean()
               + (o['target_norm'] * o['predicted_norm']).sum()
               for o in out.values())
    return dict(zip([n for n, _ in model.named_parameters()],
                    torch.autograd.grad(loss, list(model.parameters()))))

  got, want = grads(tmodel), grads(vmap_model)
  assert float(got['nerf.fine.trunk.hidden_0.kernel'].abs().max()) > 0
  # Tolerance relative to each tensor's norm: float32, the two modes sum
  # the same products in another order.
  for name, w in want.items():
    rel = float((got[name] - w).norm() / w.norm().clamp_min(1e-12))
    assert rel < 1e-4, (name, rel)


def test_render_image_padded_chunks_match_jax(models):
  jmodel, params, tmodel = models
  rays = make_rays(12, seed=3)
  image = {k: v.reshape(3, 4, -1) for k, v in rays.items()
           if k != 'metadata'}
  image['metadata'] = {'warp': np.full((3, 4, 1), 2, np.int32)}
  # 12 rays in chunks of 5: the last chunk is padded with 3 repeated rays.
  want = jrender.render_image(
      jmodel, params, image, jax.random.PRNGKey(0), jax_extra(jmodel.config),
      chunk=5, render_fn=jrender.make_render_fn(
          jmodel, compute_sigma_gradient=True))
  got = trender.render_image(
      tmodel, image, torch_extra(tmodel.config), chunk=5,
      render_fn=trender.make_render_fn(tmodel, compute_sigma_gradient=True))
  assert set(got) == set(want) == set(trender.DEFAULT_KEYS)
  for k in want:
    assert got[k].shape == want[k].shape and got[k].shape[:2] == (3, 4)
    np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=RTOL,
                               err_msg=k)
