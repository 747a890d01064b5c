"""Paired training runs of the port against the JAX package.

Both sides start from the same parameters (the JAX init copied into the
port with ``params_from_jax``) and take the same ray batches, drawn as
indices with numpy, through their explicit-batch steps
(``make_train_step``). Both run ``sigma_gradient_mode='vmap'`` with plain
compositing, so the JAX side runs no Pallas kernel in interpret mode.

* ``test_paired_steps_track_jax`` (tier 1): a few steps with
  unstratified sampling, where neither side draws a random number; the
  port's parameters must stay within a stated tolerance of JAX's.
* ``test_paired_val_psnr_400_steps`` (slow, minutes): the verify-skill
  drive (``synthetic_smoke``: trunk 4x64, 12 + 12 samples, batch 512, the
  64x64 synthetic scene, 400 steps) on both sides for ``VAL_PSNR_SEEDS``
  seeds, with the preset's stratified sampling (each side draws its own
  samples), then ``eval_psnr`` of the val views (unseen times) on each
  side. It prints the per-seed paired deltas, their mean, its 95%
  interval and so the smallest gap the seeds resolve, and asserts that the
  mean lies within their spread.

  JAX_PLATFORMS=cpu python -m pytest tests/test_torch_paired_ab.py \
      --runslow -s -k val_psnr
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfds_tpu import config as jconfig
from nerfds_tpu.datasets import synthetic as jsynthetic
from nerfds_tpu.trainer import Trainer as JaxTrainer
from nerfds_tpu.training import step as jstep
from nerfds_torch import config as tconfig
from nerfds_torch.convert import params_from_jax
from nerfds_torch.datasets import synthetic as tsynthetic
from nerfds_torch.trainer import Trainer as TorchTrainer
from nerfds_torch.training import step as tstep

torch.set_num_threads(1)

# Seeds of the slow val-PSNR run: its paired deltas spread by about 1.9 dB
# (std over 10 seeds), so 10 seeds place their mean within about ±1.3 dB
# (95%); 3 seeds could not resolve a gap under about 6 dB.
VAL_PSNR_SEEDS = 10

# The synthetic_smoke preset of both CLIs (nerfds_torch/train.py,
# scripts/train.py) with the verify skill's 12 + 12 samples.
SMOKE_MODEL = dict(
    num_coarse_samples=12, num_fine_samples=12, nerf_trunk_depth=4,
    nerf_trunk_width=64, se3_trunk_depth=3, se3_trunk_width=32,
    hyper_sheet_depth=2, hyper_sheet_width=16, mask_mlp_depth=2,
    mask_mlp_width=32, nerf_skips=(), se3_skips=(), hyper_sheet_skips=(),
    mask_skips=(), sigma_gradient_mode='vmap', use_pallas_compositing=False)
SMOKE_TRAIN = dict(
    lr_schedule=('exponential', 5e-3, 5e-4, 1000),
    warp_alpha_schedule=('linear', 0, 4, 200),
    sharp_mask_std_schedule=('constant', 0.3),
    norm_input_alpha_schedule=('constant', 4.0),
    x_for_rgb_alpha_schedule=('constant', 4.0))


def configs(config_lib, batch_size, **model_overrides):
  model = dataclasses.replace(config_lib.nerf_ds(),
                              **{**SMOKE_MODEL, **model_overrides})
  train = dataclasses.replace(
      config_lib.nerf_ds_train_config(max_steps=1000, batch_size=batch_size),
      **SMOKE_TRAIN)
  return model, train


class PairedRun:
  """The JAX and the port trainer on one synthetic scene, from one init."""

  def __init__(self, seed, batch_size, num_frames, image_size,
               **model_overrides):
    self.seed, self.batch_size = seed, batch_size
    kwargs = dict(num_frames=num_frames, image_size=image_size)
    jsource = jsynthetic.SyntheticDataSource(**kwargs, gt_backend='numpy')
    tsource = tsynthetic.SyntheticDataSource(**kwargs)
    self.jtrainer = JaxTrainer.from_experiment(
        *configs(jconfig, batch_size, **model_overrides), jsource,
        use_mesh=False, sampling='fused')
    self.ttrainer = TorchTrainer.from_experiment(
        *configs(tconfig, batch_size, **model_overrides), tsource,
        device='cpu')
    params = jax.device_get(
        jax.jit(self.jtrainer.model.init)(jax.random.PRNGKey(seed)))
    self.jstate = jstep.TrainState.create(params)
    self.tstate = tstep.TrainState.create(params_from_jax(params))
    self.jstep = jstep.make_train_step(self.jtrainer.model,
                                       self.jtrainer.train_cfg, donate=False)
    self.tstep = tstep.make_train_step(self.ttrainer.model,
                                       self.ttrainer.train_cfg)
    self.store = tsource.build_ray_store(tsource.train_ids).as_dict()
    self.rng = np.random.RandomState(1000 + seed)
    self.step = 0

  def batch(self):
    idx = self.rng.randint(0, self.store['origins'].shape[0],
                           self.batch_size)
    take = lambda tree: {k: take(v) if isinstance(v, dict) else v[idx]
                         for k, v in tree.items()}
    return take(self.store)

  def run(self, steps):
    for _ in range(steps):
      batch = self.batch()
      self.jstate, _ = self.jstep(
          self.jstate, jax.tree_util.tree_map(jnp.asarray, batch),
          jax.random.fold_in(jax.random.PRNGKey(self.seed + 17), self.step))
      gen = torch.Generator().manual_seed(((self.seed + 17) << 32)
                                          + self.step)
      self.tstate, stats = self.tstep(
          self.tstate, jax.tree_util.tree_map(torch.from_numpy, batch), gen)
      self.step += 1
    return stats


def test_paired_steps_track_jax():
  run = PairedRun(seed=0, batch_size=64, num_frames=4, image_size=16,
                  use_stratified_sampling=False)
  run.run(3)
  assert run.tstate.step == 3 and int(run.jstate.step) == 3
  want = params_from_jax(jax.device_get(run.jstate.params))
  assert set(run.tstate.params) == set(want)
  # Three Adam steps at lr 5e-3: each step moves a parameter by about
  # lr·sign(g), so the float32 rounding of the grads (two frameworks,
  # sums in another order) grows step by step (measured: 2.8e-5, 7.1e-5
  # and 1.2e-4 after steps 1-3); a wrong grad, or a sign flip of one,
  # shows as 5e-3 a step.
  for name, w in want.items():
    torch.testing.assert_close(run.tstate.params[name], w, rtol=0,
                               atol=2e-4, msg=name)


@pytest.mark.slow
def test_paired_val_psnr_400_steps():
  import scipy.stats
  rows = []
  for seed in range(VAL_PSNR_SEEDS):
    run = PairedRun(seed=seed, batch_size=512, num_frames=8, image_size=64)
    stats = run.run(400)
    jval = run.jtrainer.eval_psnr(run.jstate)['psnr']
    tval = run.ttrainer.eval_psnr(run.tstate)['psnr']
    rows.append((seed, float(stats['fine']['metric/psnr']), jval, tval))
    print(f'seed {seed}: port train-batch psnr {rows[-1][1]:.3f} dB; val '
          f'psnr JAX {jval:.3f} dB, port {tval:.3f} dB, delta '
          f'{tval - jval:+.3f} dB', flush=True)
  deltas = np.array([r[3] - r[2] for r in rows])
  spread = float(deltas.std(ddof=1))
  # Half the 95% interval of the mean (Student's t): a smaller mean gap is
  # not resolved by these seeds.
  half = float(scipy.stats.t.ppf(0.975, len(deltas) - 1)) * spread / np.sqrt(
      len(deltas))
  print(f'paired val-psnr deltas (port - JAX): {deltas.tolist()}, mean '
        f'{deltas.mean():+.3f} dB, spread (std over seeds) {spread:.3f} dB, '
        f'95% interval of the mean {deltas.mean() - half:+.3f} to '
        f'{deltas.mean() + half:+.3f} dB')
  assert all(r[1] >= 28.0 for r in rows), rows
  assert abs(deltas.mean()) <= spread, (deltas, spread)
