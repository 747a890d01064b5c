"""Paired training runs of the port against the JAX package.

Both sides start from the same parameters (the JAX init copied into the
port with ``params_from_jax``) and take the same ray batches, drawn as
indices with numpy, through their explicit-batch steps
(``make_train_step``). Both run ``sigma_gradient_mode='vmap'`` with plain
compositing, so the JAX side runs no Pallas kernel in interpret mode.
``PairedRun`` takes a pair of data sources over the same data: the
synthetic scene (one per package), or a vrig capture written once by the
port and read by both packages' ``NerfiesDataSource`` (train ids the left
camera, val ids the right camera at the same times).

* ``test_paired_steps_track_jax`` (tier 1), over ``synthetic`` and
  ``vrig``: a few steps with unstratified sampling, where neither side
  draws a random number; the port's parameters must stay within a stated
  tolerance of JAX's, and on the capture the right camera's
  ``eval_psnr(masked=True)`` within a stated tolerance of JAX's.
* ``test_paired_vrig_steps_from_init_float64`` (tier 1): on the capture,
  three steps from the init in float64 on both sides, each from JAX's
  state; every Adam first moment within a stated tolerance of JAX's.
* ``test_vrig_float32_step_from_init_parts_at_relu_kinks`` (tier 1): the
  port alone, one step from the init in float32 and in float64; with
  float64's relu decisions imposed, the float32 gradient lies within a
  stated tolerance of the float64 one.
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

* ``test_paired_vrig_val_600_steps`` (slow, about an hour on one CPU
  core): the same drive on a vrig capture (8 frames a camera at 48 px),
  600 steps a seed, then each side's right-camera val PSNR, masked PSNR
  and MS-SSIM, and its left-camera (train-view) PSNR. It prints the
  paired deltas of the three val metrics with their mean, spread and 95%
  interval, and asserts that the mean of the PSNR and of the MS-SSIM
  deltas lies within their spread and that the port's train-view PSNR
  reaches ``VRIG_TRAIN_PSNR_FLOOR`` at every seed. ``-k vrig`` also runs
  the tier-1 vrig tests:

  JAX_PLATFORMS=cpu python -m pytest tests/test_torch_paired_ab.py \
      --runslow -s -k vrig
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfds_tpu import config as jconfig
from nerfds_tpu import datasets as jdatasets
from nerfds_tpu.datasets import synthetic as jsynthetic
from nerfds_tpu.trainer import Trainer as JaxTrainer
from nerfds_tpu.training import step as jstep
from nerfds_torch import config as tconfig
from nerfds_torch import datasets as tdatasets
from nerfds_torch.convert import params_from_jax
from nerfds_torch.datasets import synthetic as tsynthetic
from nerfds_torch.trainer import Trainer as TorchTrainer
from nerfds_torch.training import step as tstep

torch.set_num_threads(1)

# Seeds of the slow val-PSNR run: its paired deltas spread by about 1.9 dB
# (std over 10 seeds), so 10 seeds place their mean within about ±1.3 dB
# (95%); 3 seeds could not resolve a gap under about 6 dB.
VAL_PSNR_SEEDS = 10

# JAX steps alone before the vrig case's paired steps (see the test).
VRIG_WARM_UP_STEPS = 20

# The vrig gate: 8 frames a camera at 48 px, 600 steps at batch 512 (about
# 6 minutes a seed on one CPU core for both sides).
VRIG_GATE_STEPS = 600
VRIG_GATE_FRAMES, VRIG_GATE_SIZE = 8, 48
# The port's train-view (left camera) PSNR at every seed must reach this
# (measured over seeds 0-9: the port 31.12-33.40 dB, JAX 30.77-32.87).
VRIG_TRAIN_PSNR_FLOOR = 30.0

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


def widen(tree):
  """``tree`` with its float32 arrays in float64."""
  return jax.tree_util.tree_map(
      lambda a: np.asarray(a, np.float64)
      if np.asarray(a).dtype == np.float32 else a, tree)


def flat(tree, prefix=''):
  """A nested dict of arrays as the port's flat dict of tensors, in the
  arrays' own dtype."""
  out = {}
  for key, value in tree.items():
    if isinstance(value, dict):
      out.update(flat(value, f'{prefix}{key}.'))
    else:
      out[prefix + key] = torch.from_numpy(np.array(value))
  return out


def synthetic_sources(num_frames, image_size):
  """(JAX source, port source) of one synthetic scene."""
  kwargs = dict(num_frames=num_frames, image_size=image_size)
  return (jsynthetic.SyntheticDataSource(**kwargs, gt_backend='numpy'),
          tsynthetic.SyntheticDataSource(**kwargs))


def write_vrig_capture(out_dir, num_frames, image_size, gt_samples):
  """One vrig capture written by the port (the torch march on the CPU),
  which both packages' loaders read: the two writers' frames differ by up
  to one 8-bit level, so the pair must share one export."""
  src = tsynthetic.VrigSyntheticDataSource(
      num_frames=num_frames, image_size=image_size, gt_samples=gt_samples,
      device='cpu')
  tsynthetic.write_nerfies_dataset(
      src, out_dir, scene_center=(0.12, -0.08, 0.25), scene_scale=0.85,
      camera_path_frames=0)
  return out_dir


def vrig_sources(data_dir):
  """(JAX source, port source) of one capture: train ids the left camera,
  val ids the right at the same times."""
  return (jdatasets.NerfiesDataSource(data_dir),
          tdatasets.NerfiesDataSource(data_dir))


class PairedRun:
  """The JAX and the port trainer on one scene (a pair of data sources
  over the same data), from one init. With ``x64`` both take their steps
  in float64 from that float32 init widened: JAX under
  ``jax.enable_x64``, the port with its model, state and batches in
  float64. Both warp fields still cast the screw's raw outputs to float32,
  each as the other does."""

  def __init__(self, seed, batch_size, sources, x64=False,
               **model_overrides):
    self.seed, self.batch_size, self.x64 = seed, batch_size, x64
    jsource, tsource = sources
    self.jtrainer = JaxTrainer.from_experiment(
        *configs(jconfig, batch_size, **model_overrides), jsource,
        use_mesh=False, sampling='fused')
    self.ttrainer = TorchTrainer.from_experiment(
        *configs(tconfig, batch_size, **model_overrides), tsource,
        device='cpu')
    params = jax.device_get(
        jax.jit(self.jtrainer.model.init)(jax.random.PRNGKey(seed)))
    if x64:
      params = widen(params)
      self.ttrainer.model.double()
    with jax.enable_x64(x64):
      self.jstate = jstep.TrainState.create(params)
    self.tstate = tstep.TrainState.create(flat(params))
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

  def jax_step(self, batch):
    with jax.enable_x64(self.x64):
      self.jstate, _ = self.jstep(
          self.jstate, jax.tree_util.tree_map(jnp.asarray, batch),
          jax.random.fold_in(jax.random.PRNGKey(self.seed + 17), self.step))

  def take_jax_state(self):
    """The port takes JAX's whole state (parameters and Adam's moments) in
    its dtype."""
    state = jax.device_get(self.jstate)
    opt = state.opt_state
    self.tstate = tstep.TrainState(
        step=int(state.step), params=flat(state.params),
        opt_state=tstep.AdamState(count=int(opt.count), mu=flat(opt.mu),
                                  nu=flat(opt.nu)))

  def warm_up(self, steps):
    """``steps`` steps of the JAX trainer alone; then the port takes its
    whole state."""
    for _ in range(steps):
      self.jax_step(self.batch())
      self.step += 1
    self.take_jax_state()

  def run(self, steps):
    for _ in range(steps):
      batch = widen(self.batch()) if self.x64 else self.batch()
      self.jax_step(batch)
      gen = torch.Generator().manual_seed(((self.seed + 17) << 32)
                                          + self.step)
      self.tstate, stats = self.tstep(
          self.tstate, jax.tree_util.tree_map(torch.from_numpy, batch), gen)
      self.step += 1
    return stats


@pytest.fixture(scope='module')
def vrig_capture(tmp_path_factory):
  """A 4-frame 32 px vrig capture, as tests/test_torch_datasets.py's."""
  return write_vrig_capture(tmp_path_factory.mktemp('vrig'), num_frames=4,
                            image_size=32, gt_samples=48)


@pytest.mark.parametrize('scene', ['synthetic', 'vrig'])
def test_paired_steps_track_jax(scene, request):
  if scene == 'synthetic':
    run = PairedRun(seed=0, batch_size=64, sources=synthetic_sources(4, 16),
                    use_stratified_sampling=False)
  else:
    # The capture's frames are composited on white, as the JAX run's
    # model config (artifacts/vrig_run/model_config.json) says. The pair
    # starts from JAX's state after VRIG_WARM_UP_STEPS steps. From the
    # init the two trajectories part even in float64 (2.1e-3 after step 3
    # at this seed): Adam's first steps move a parameter by about
    # lr·sign(g), so a gradient near 0 or a relu input within rounding of
    # 0 (test_vrig_float32_step_from_init_parts_at_relu_kinks) moves it by
    # ±lr on one side. test_paired_vrig_steps_from_init_float64 holds the
    # steps from the init themselves.
    run = PairedRun(seed=0, batch_size=64,
                    sources=vrig_sources(request.getfixturevalue(
                        'vrig_capture')),
                    use_stratified_sampling=False, use_white_background=True)
    run.warm_up(VRIG_WARM_UP_STEPS)
  start = run.step
  run.run(3)
  assert run.tstate.step == start + 3 and int(run.jstate.step) == start + 3
  want = params_from_jax(jax.device_get(run.jstate.params))
  assert set(run.tstate.params) == set(want)
  # Three Adam steps at lr 5e-3: each step moves a parameter by about
  # lr·sign(g), so the float32 rounding of the grads (two frameworks,
  # sums in another order) grows step by step (measured on the synthetic
  # scene: 2.8e-5, 7.1e-5 and 1.2e-4 after steps 1-3; on the capture,
  # from JAX's state at step 20: 5.1e-7 after step 3); a wrong grad, or a
  # sign flip of one, shows as 5e-3 a step.
  for name, w in want.items():
    torch.testing.assert_close(run.tstate.params[name], w, rtol=0,
                               atol=2e-4, msg=name)
  if scene == 'vrig':
    # The right camera at the trained times, through each side's loader,
    # renderer and metrics (measured: psnr 1.2e-6 dB, masked_psnr 1.9e-7
    # dB and ms_ssim 6.4e-6 apart).
    jval = run.jtrainer.eval_psnr(run.jstate, masked=True)
    tval = run.ttrainer.eval_psnr(run.tstate, masked=True)
    for key, atol in (('psnr', 1e-3), ('masked_psnr', 1e-3),
                      ('ms_ssim', 1e-4)):
      assert abs(tval[key] - jval[key]) <= atol, (key, tval, jval)


def test_paired_vrig_steps_from_init_float64(vrig_capture):
  """Three steps from the init on the capture, in float64 on both sides,
  each from JAX's state: every step's Adam first moment within 5e-5 of its
  tensor's largest, every parameter within the 2e-4 above (measured:
  4.6e-7, 9.8e-7 and 3.8e-6; parameters at most 3.7e-6 apart). The
  residue is the float32 screw that both warp fields cast to, whose angle
  is about 1e-5 at the init. It prints how far the port's parameters lie
  from JAX's on their own trajectory: within three steps the two part in
  float64 too (3.7e-6, 2.1e-4, 2.1e-3)."""
  run = PairedRun(seed=0, batch_size=64, sources=vrig_sources(vrig_capture),
                  x64=True, use_stratified_sampling=False,
                  use_white_background=True)
  free = run.tstate  # the port's own trajectory, for the printout
  for step in range(1, 4):
    run.take_jax_state()
    drawn = run.rng.get_state()
    run.run(1)
    state = jax.device_get(run.jstate)
    after = run.rng.get_state()
    run.rng.set_state(drawn)
    free, _ = run.tstep(free, jax.tree_util.tree_map(
        torch.from_numpy, widen(run.batch())), None)
    run.rng.set_state(after)
    assert run.tstate.step == step and int(state.step) == step
    params, mu = flat(state.params), flat(state.opt_state.mu)
    assert all(w.dtype == torch.float64 for w in params.values())
    apart = max(float((run.tstate.params[k] - w).abs().max())
                for k, w in params.items())
    moments = max(float((run.tstate.opt_state.mu[k] - m).abs().max()
                        / m.abs().max())
                  for k, m in mu.items() if m.abs().max() > 0)
    own = max(float((free.params[k] - w).abs().max())
              for k, w in params.items())
    print(f'step {step}: parameters at most {apart:.2e} apart, first '
          f'moments at most {moments:.2e} of their largest; the port on '
          f'its own trajectory {own:.2e} from JAX')
    for name, w in params.items():
      torch.testing.assert_close(run.tstate.params[name], w, rtol=0,
                                 atol=2e-4, msg=name)
    for name, m in mu.items():
      torch.testing.assert_close(
          run.tstate.opt_state.mu[name], m, rtol=0,
          atol=5e-5 * float(m.abs().max()), msg=f'step {step} mu {name}')


@pytest.mark.parametrize('seed', range(5))
def test_vrig_float32_step_from_init_parts_at_relu_kinks(seed, vrig_capture,
                                                        monkeypatch):
  """The port's float32 gradient of one step from the init on the capture
  lies up to 5.4e-3 of a tensor's largest from its float64 gradient, and
  the relu decisions are why: at seed 0 float32 puts one input of the rgb
  branch's first relu (float64: -6.4e-6, float32: +5.1e-7) on the other
  side of 0, and the gradient lies 1.45e-3 off. With each relu deciding as
  in float64, the float32 gradient lies within 1e-4 of the float64 one
  (measured: seed 1, with no input on the other side, 5.3e-6; the others
  1.4e-5 to 3.3e-5). Every such input lies within 1e-4 of 0."""
  run = PairedRun(seed=seed, batch_size=64,
                  sources=vrig_sources(vrig_capture),
                  use_stratified_sampling=False, use_white_background=True)
  batch = run.batch()
  relu = torch.relu
  inputs = {}

  def gradient(dtype, decide):
    """Each parameter's gradient of one step from the init in ``dtype``,
    with ``decide(k, x)`` as the k-th relu; the relu inputs are kept."""
    model = copy.deepcopy(run.ttrainer.model).to(dtype)
    seen = inputs[dtype] = []

    def patched(x):
      seen.append(x.detach().double())
      return decide(len(seen) - 1, x)

    monkeypatch.setattr(torch, 'relu', patched)
    try:
      state = tstep.TrainState.create(
          {k: v.to(dtype) for k, v in run.tstate.params.items()})
      step = tstep.make_train_step(model, run.ttrainer.train_cfg)
      state, _ = step(state, jax.tree_util.tree_map(
          torch.from_numpy, widen(batch) if dtype == torch.float64
          else batch), torch.Generator().manual_seed(0))
    finally:
      monkeypatch.setattr(torch, 'relu', relu)
    return {k: v.double() / (1 - tstep.ADAM_B1)
            for k, v in state.opt_state.mu.items()}

  want = gradient(torch.float64, lambda k, x: relu(x))
  as_f64 = lambda k, x: x * (inputs[torch.float64][k] > 0).to(x.dtype)

  def error(got):
    return max(float((got[k] - w).abs().max() / w.abs().max())
               for k, w in want.items() if w.abs().max() > 0)

  plain = error(gradient(torch.float32, lambda k, x: relu(x)))
  flips = [(k, float(wide[tuple(i)]), float(narrow[tuple(i)]))
           for k, (narrow, wide) in enumerate(zip(inputs[torch.float32],
                                                  inputs[torch.float64]))
           for i in ((narrow > 0) != (wide > 0)).nonzero().tolist()]
  imposed = error(gradient(torch.float32, as_f64))
  print(f'seed {seed}: float32 gradient from float64: {plain:.3e} of a '
        f'tensor\'s '
        f'largest; relu inputs on the other side of 0 (call, f64, f32): '
        f'{flips}; with float64\'s relu decisions: {imposed:.3e}')
  assert len(inputs[torch.float32]) == len(inputs[torch.float64])
  assert all(abs(wide) <= 1e-4 for _, wide, _ in flips), flips
  assert imposed <= 1e-4, (imposed, plain, flips)


def mean_interval(deltas):
  """(mean, std over seeds, half the 95% Student-t interval of the mean):
  a smaller mean gap is not resolved by these seeds."""
  import scipy.stats
  spread = float(deltas.std(ddof=1))
  half = float(scipy.stats.t.ppf(0.975, len(deltas) - 1)) * spread / np.sqrt(
      len(deltas))
  return float(deltas.mean()), spread, half


@pytest.mark.slow
def test_paired_val_psnr_400_steps():
  rows = []
  for seed in range(VAL_PSNR_SEEDS):
    run = PairedRun(seed=seed, batch_size=512,
                    sources=synthetic_sources(8, 64))
    stats = run.run(400)
    jval = run.jtrainer.eval_psnr(run.jstate)['psnr']
    tval = run.ttrainer.eval_psnr(run.tstate)['psnr']
    rows.append((seed, float(stats['fine']['metric/psnr']), jval, tval))
    print(f'seed {seed}: port train-batch psnr {rows[-1][1]:.3f} dB; val '
          f'psnr JAX {jval:.3f} dB, port {tval:.3f} dB, delta '
          f'{tval - jval:+.3f} dB', flush=True)
  deltas = np.array([r[3] - r[2] for r in rows])
  mean, spread, half = mean_interval(deltas)
  print(f'paired val-psnr deltas (port - JAX): {deltas.tolist()}, mean '
        f'{mean:+.3f} dB, spread (std over seeds) {spread:.3f} dB, '
        f'95% interval of the mean {mean - half:+.3f} to '
        f'{mean + half:+.3f} dB')
  assert all(r[1] >= 28.0 for r in rows), rows
  assert abs(mean) <= spread, (deltas, spread)


@pytest.mark.slow
def test_paired_vrig_val_600_steps(tmp_path):
  capture = write_vrig_capture(tmp_path / 'vrig', VRIG_GATE_FRAMES,
                               VRIG_GATE_SIZE, gt_samples=96)
  keys = ('psnr', 'masked_psnr', 'ms_ssim')
  rows = []
  for seed in range(VAL_PSNR_SEEDS):
    run = PairedRun(seed=seed, batch_size=512, sources=vrig_sources(capture),
                    use_white_background=True)
    run.run(VRIG_GATE_STEPS)
    # The right camera at the trained times (val), and the left camera
    # (the train views).
    jval = run.jtrainer.eval_psnr(run.jstate, masked=True)
    tval = run.ttrainer.eval_psnr(run.tstate, masked=True)
    train_ids = run.ttrainer.datasource.train_ids
    jtrain = run.jtrainer.eval_psnr(run.jstate, item_ids=train_ids)['psnr']
    ttrain = run.ttrainer.eval_psnr(run.tstate, item_ids=train_ids)['psnr']
    rows.append(dict(seed=seed, jax=jval, port=tval, jax_train=jtrain,
                     port_train=ttrain))
    print(f'seed {seed}: train-view psnr JAX {jtrain:.3f} dB, port '
          f'{ttrain:.3f} dB; val ' + ', '.join(
              f'{k} JAX {jval[k]:.4f} port {tval[k]:.4f} delta '
              f'{tval[k] - jval[k]:+.4f}' for k in keys), flush=True)
  deltas = {k: np.array([r['port'][k] - r['jax'][k] for r in rows])
            for k in keys}
  for k in keys:
    mean, spread, half = mean_interval(deltas[k])
    print(f'paired val {k} deltas (port - JAX): '
          f'{np.round(deltas[k], 4).tolist()}, mean {mean:+.4f}, spread '
          f'(std over seeds) {spread:.4f}, 95% interval of the mean '
          f'{mean - half:+.4f} to {mean + half:+.4f}')
  assert all(r['port_train'] >= VRIG_TRAIN_PSNR_FLOOR for r in rows), rows
  for k in ('psnr', 'ms_ssim'):
    mean, spread, _ = mean_interval(deltas[k])
    assert abs(mean) <= spread, (k, deltas[k])
