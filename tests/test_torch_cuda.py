"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test is marked ``cuda`` and skips without an NVIDIA GPU; the
file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed:

  python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: the suite's conftest configures JAX.)
"""
import numpy as np
import pytest
import torch

from nerfds_torch import kernels
from nerfds_torch.kernels import composite as tcomposite
from nerfds_torch.kernels import fused_mlp as tfm
from nerfds_torch.kernels import fused_trunk as tft
from nerfds_torch.models.mlp import MLP, NerfMLP


def t(x):
  return torch.from_numpy(np.array(x))


def composite_inputs(num_rays=37, num_samples=16, seed=0):
  rng = np.random.RandomState(seed)
  rgb = rng.rand(num_rays, num_samples, 3).astype(np.float32)
  sigma = (rng.rand(num_rays, num_samples) * 3).astype(np.float32)
  z = np.sort(rng.rand(num_rays, num_samples).astype(np.float32) * 3 + 1, -1)
  dirs = rng.randn(num_rays, 3).astype(np.float32)
  return rgb, sigma, z, dirs


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip('needs an NVIDIA GPU with nvcc')
  return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('sample_at_infinity', [True, False])
def test_composite_kernel_matches_plain_on_card(cuda, sample_at_infinity):
  args = [t(a).to(cuda) for a in composite_inputs(num_rays=1000,
                                                  num_samples=128)]
  before = kernels.launch_counts['composite_fwd']
  got = tcomposite.composite_forward(*args, sample_at_infinity)
  want = tcomposite.composite_reference(*args, sample_at_infinity)
  assert kernels.launch_counts['composite_fwd'] == before + 1
  for g, w in zip(got, want):
    torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


# Ray counts at the edges of K2's blocks (one warp a ray): one ray, a block
# edge either side, a training batch and a ragged render-sized count; sample
# counts of one, of synthetic_smoke's coarse level, of nerf_ds's two levels
# and one past a whole pass.
K2_RAYS = (1, tcomposite.KERNEL_RAYS_PER_BLOCK - 1,
           tcomposite.KERNEL_RAYS_PER_BLOCK + 1, 512, 4099)
K2_SAMPLES = (1, 12, 64, tcomposite.KERNEL_SAMPLE_CHUNK,
              tcomposite.KERNEL_SAMPLE_CHUNK + 1)


@pytest.mark.cuda
@pytest.mark.parametrize('sample_at_infinity', [True, False])
@pytest.mark.parametrize('num_samples', K2_SAMPLES)
def test_composite_kernel_at_block_and_chunk_edges(cuda, num_samples,
                                                   sample_at_infinity):
  for num_rays in K2_RAYS:
    args = [t(a).to(cuda) for a in composite_inputs(
        num_rays=num_rays, num_samples=num_samples, seed=num_rays)]
    got = tcomposite.composite_forward(*args, sample_at_infinity)
    want = tcomposite.composite_reference(*args, sample_at_infinity)
    # Tolerance: float32; the kernel's warp scan and sums associate
    # differently from torch.cumprod / torch.sum.
    for g, w in zip(got, want):
      torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5,
                                 msg=f'R={num_rays}')


def nerf_ds_trunk(cuda, gen, norm_dim=3, has_bottleneck=True):
  """The nerf_ds NeRF trunk (8x256, skip at 4, 52 inputs, σ + normal head,
  bottleneck) on the card; ``norm_dim=0`` gives a σ-only head
  (``use_sigma_gradient`` without ``predict_norm``), ``has_bottleneck=False``
  the trunk of ``use_hyper_c``."""
  tm = NerfMLP(52, 0, 0, has_bottleneck, trunk_depth=8, trunk_width=256,
               skips=(4,), predict_norm=norm_dim > 0, generator=gen).to(cuda)
  spec = tft.TrunkSpec(depth=8, width=256, skips=(4,), in_dim=52,
                       alpha_channels=1, norm_dim=norm_dim,
                       has_bottleneck=has_bottleneck)
  return spec, tm.trunk_weights()


# K1's head shapes: nerf_ds()'s, the σ-only head, no bottleneck, both.
HEADS = ((3, True), (0, True), (3, False), (0, False))


def check_trunk_forward(cuda, n, seed, norm_dim=3, has_bottleneck=True):
  gen = torch.Generator().manual_seed(seed)
  spec, weights = nerf_ds_trunk(cuda, gen, norm_dim, has_bottleneck)
  feat = torch.rand(n, 52, generator=gen).to(cuda) * 2 - 1
  with torch.no_grad():
    before = kernels.launch_counts['fused_trunk_fwd']
    got = tft.trunk_sigma_grad(feat, weights, spec)
    want = tft.trunk_sigma_grad_reference(feat, weights, spec)
  assert kernels.launch_counts['fused_trunk_fwd'] == before + 1
  for name, g, w in zip(('sigma', 'normal', 'trunk', 'bneck'), got, want):
    if w is None:  # no normal head
      assert g is None
      continue
    torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4, msg=name)
  # g follows the relu masks; a pre-activation within rounding of 0 may
  # fall on the other side of the kink in the two versions.
  bad = ((got[4] - want[4]).abs() > 1e-4 + 1e-4 * want[4].abs()).float()
  assert bad.mean().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize('norm_dim,has_bottleneck', HEADS)
def test_fused_trunk_kernel_matches_plain_on_card(cuda, norm_dim,
                                                  has_bottleneck):
  check_trunk_forward(cuda, 4099, seed=0, norm_dim=norm_dim,
                      has_bottleneck=has_bottleneck)


# Row counts at the edges of the kernels' row tile: one row, a tile short
# of one row, one row into a second tile, and whole tiles (4096 rows: two
# whole weight-grad splits of the backward).
TILE_EDGES = (1, tft.KERNEL_TILE_ROWS - 1, tft.KERNEL_TILE_ROWS + 1,
              64 * tft.KERNEL_TILE_ROWS)


@pytest.mark.cuda
@pytest.mark.parametrize('n', TILE_EDGES)
def test_fused_trunk_kernel_at_tile_edges(cuda, n):
  check_trunk_forward(cuda, n, seed=n)


def check_trunk_backward(cuda, n, seed, norm_dim=3, has_bottleneck=True):
  gen = torch.Generator().manual_seed(seed)
  spec, weights = nerf_ds_trunk(cuda, gen, norm_dim, has_bottleneck)
  feat = (torch.rand(n, 52, generator=gen) * 2 - 1).to(cuda)
  cots = tuple(torch.randn(n, c, generator=gen).to(cuda)
               for c in (1, norm_dim, 256, 256, 52))
  # Rows at relu kinks, as in chip_smoke.py: each feat_bar row beyond
  # tolerance must be proven exact with one mask flipped, such rows are at
  # most 1e-3 of N, and with their cotangents zeroed everything must agree.
  with torch.no_grad():
    got_x, _ = tft.trunk_sigma_grad_backward(feat, weights, spec, cots)
    want_x, _ = tft.trunk_sigma_grad_backward_reference(feat, weights, spec,
                                                        cots)
    bad, _, _ = tft.check_kink_rows(feat, weights, spec, cots, got_x, want_x)
    cots = tuple(c * (~bad).float()[:, None] for c in cots)
  with torch.no_grad():
    before = kernels.launch_counts['fused_trunk_bwd']
    got_x, got_w = tft.trunk_sigma_grad_backward(feat, weights, spec, cots)
    again_x, again_w = tft.trunk_sigma_grad_backward(feat, weights, spec,
                                                     cots)
    want_x, want_w = tft.trunk_sigma_grad_backward_reference(
        feat, weights, spec, cots)
  assert kernels.launch_counts['fused_trunk_bwd'] == before + 2
  got, again, want = (tft._flatten(w) for w in (got_w, again_w, want_w))
  for g, a in zip([got_x, *got], [again_x, *again]):
    assert torch.equal(g, a)  # fixed summation order: the same bits
  # Tolerance relative to each tensor's norm: sums over up to N rows in
  # another order than cuBLAS.
  for i, (g, w) in enumerate(zip([got_x, *got], [want_x, *want])):
    rel = float((g - w).norm() / w.norm().clamp_min(1e-30))
    assert rel < 1e-4, (i, rel)


@pytest.mark.cuda
@pytest.mark.parametrize('norm_dim,has_bottleneck', HEADS)
def test_fused_trunk_backward_kernel_matches_plain_on_card(cuda, norm_dim,
                                                           has_bottleneck):
  # A ragged last tile and a ragged last weight-grad split.
  check_trunk_backward(cuda, 4099, seed=1, norm_dim=norm_dim,
                       has_bottleneck=has_bottleneck)


@pytest.mark.cuda
@pytest.mark.parametrize('n', TILE_EDGES)
def test_fused_trunk_backward_kernel_at_tile_edges(cuda, n):
  check_trunk_backward(cuda, n, seed=n + 1)


def check_trunk_bf16(cuda, n, seed, norm_dim=3, has_bottleneck=True):
  """K1f and K1b with bf16 operands (on the tensor cores) against their
  bf16 plain versions.

  Both round the same values to bf16, but a float32 sum that lies within
  its rounding error of a bf16 rounding boundary or of a relu kink goes the
  other way in one of them, and that carries on through the later layers:
  a moved mask changes a whole row of g or feat̄ (the plain version alone,
  run in float32 against float64, shows this in 0.17% of K1f's rows and
  0.41% of K1b's at N = 4,099). So every output is held elementwise at atol
  1e-3 + rtol 1e-2, and each row beyond that must be reproduced within
  float32 tolerance by the plain version in float64 with the sites moved
  that lie at such a boundary, must not lie in the ragged last tile, and
  such rows are at most 2% of N (``fused_trunk.check_bf16_rows``). With
  those rows' cotangents zeroed every output of K1b lies within 5e-3 of
  its norm, and two K1b launches give the same bits.
  """
  bf16 = torch.bfloat16
  gen = torch.Generator().manual_seed(seed)
  spec, weights = nerf_ds_trunk(cuda, gen, norm_dim, has_bottleneck)
  feat = (torch.rand(n, 52, generator=gen) * 2 - 1).to(cuda)
  cots = tuple(torch.randn(n, c, generator=gen).to(cuda)
               for c in (1, norm_dim, 256, 256, 52))
  with torch.no_grad():
    launched = kernels.launch_counts['fused_trunk_fwd_bf16']
    got = tft.trunk_sigma_grad(feat, weights, spec, compute_dtype=bf16)
    assert kernels.launch_counts['fused_trunk_fwd_bf16'] == launched + 1
    want = tft.trunk_sigma_grad_reference(feat, weights, spec,
                                          compute_dtype=bf16)
    _, rows, flips = tft.check_bf16_rows(feat, weights, spec, got, want)
    print(f'N={n}: K1f rows beyond {rows}, moved sites {flips}')
    got_x, _ = tft.trunk_sigma_grad_backward(feat, weights, spec, cots,
                                             compute_dtype=bf16)
    want_x, _ = tft.trunk_sigma_grad_backward_reference(
        feat, weights, spec, cots, compute_dtype=bf16)
    off, rows, flips = tft.check_bf16_rows(feat, weights, spec, got_x,
                                           want_x, cots, name='feat_bar')
    print(f'N={n}: feat_bar rows beyond {rows}, moved sites {flips}')
    cots = tuple(c * (~off).float()[:, None] for c in cots)
    before = dict(kernels.launch_counts)
    runs = [tft.trunk_sigma_grad_backward(feat, weights, spec, cots,
                                          compute_dtype=bf16)
            for _ in range(2)]
    want_x, want_w = tft.trunk_sigma_grad_backward_reference(
        feat, weights, spec, cots, compute_dtype=bf16)
  assert kernels.launch_counts == {
      **before, 'fused_trunk_bwd_bf16': before['fused_trunk_bwd_bf16'] + 2}
  got, again, want = ([x, *tft._flatten(w)] for x, w in (
      *runs, (want_x, want_w)))
  for i, (g, a, w) in enumerate(zip(got, again, want)):
    assert torch.equal(g, a), i
    rel = float((g - w).norm() / w.norm().clamp_min(1e-30))
    assert rel < 5e-3, (i, rel)


@pytest.mark.cuda
@pytest.mark.parametrize('n', (4099, *TILE_EDGES))
def test_fused_trunk_bf16_kernels_match_plain_on_card(cuda, n):
  check_trunk_bf16(cuda, n, seed=n + 7)


@pytest.mark.cuda
@pytest.mark.parametrize('norm_dim,has_bottleneck', HEADS[1:])
def test_fused_trunk_bf16_kernels_at_heads_on_card(cuda, norm_dim,
                                                   has_bottleneck):
  # The σ-only head, the trunk without a bottleneck, and both, at a ragged
  # N, by the rule above.
  check_trunk_bf16(cuda, 4099, seed=11, norm_dim=norm_dim,
                   has_bottleneck=has_bottleneck)


@pytest.mark.cuda
@pytest.mark.parametrize('compute_dtype', [None, torch.bfloat16])
def test_fused_mlp_kernel_matches_plain_on_card(cuda, compute_dtype):
  gen = torch.Generator().manual_seed(2)
  # The NeRF trunk's shape and an rgb branch wider than 256 inputs.
  for mlp in (MLP(52, 8, 256, (4,), generator=gen),
              MLP(560, 1, 128, (), output_channels=3, generator=gen)):
    mlp = mlp.to(cuda)
    x = (torch.rand(4099, mlp.in_dim, generator=gen) * 2 - 1).to(cuda)
    before = kernels.launch_counts['fused_mlp_fwd']
    got = tfm.fused_apply(mlp, None, x, compute_dtype=compute_dtype)
    assert kernels.launch_counts['fused_mlp_fwd'] == before + 1
    layers, has_out = tfm.mlp_params_to_layers(mlp, None)
    with torch.no_grad():
      want = tfm.fused_mlp_reference(x, layers, mlp.skips,
                                     has_output_layer=has_out,
                                     compute_dtype=compute_dtype)
    if compute_dtype is None:
      # float32 sums in another order than cuBLAS.
      torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
      # A sum near a bf16 rounding boundary may round the other way: 2 to
      # 4 bf16 ulps of the element and of the largest magnitude.
      scale = want.abs().max().item()
      torch.testing.assert_close(got, want, rtol=2 ** -6,
                                 atol=2 ** -6 * scale)


def random_mlp(cuda, seed, *args, **kwargs):
  """An MLP on the card with glorot weights and biases drawn from
  U(-0.1, 0.1), so that no bias is 0."""
  gen = torch.Generator().manual_seed(seed)
  mlp = MLP(*args, generator=gen, **kwargs)
  with torch.no_grad():
    for name, p in mlp.named_parameters():
      if name.endswith('bias'):
        p.uniform_(-0.1, 0.1, generator=gen)
  return mlp.to(cuda)


def check_fused_mlp(cuda, mlp, n, seed, compute_dtype=None):
  """K3 on n rows (one launch, none for n = 0) against the plain chain; each
  launch stages every layer's bias ahead of its epilogue, and a second
  launch gives the same bits."""
  x = (torch.rand(n, mlp.in_dim, generator=torch.Generator().manual_seed(
      seed)) * 2 - 1).to(cuda)
  layers, has_out = tfm.mlp_params_to_layers(mlp, None)
  before = dict(kernels.launch_counts)
  got = tfm.fused_apply(mlp, None, x, compute_dtype=compute_dtype)
  launched = int(n > 0)
  assert kernels.launch_counts['fused_mlp_fwd'] == (
      before['fused_mlp_fwd'] + launched)
  assert kernels.launch_counts['fused_mlp_fwd_prefetched_layers'] == (
      before['fused_mlp_fwd_prefetched_layers'] + launched * len(layers))
  torch.testing.assert_close(
      tfm.fused_apply(mlp, None, x, compute_dtype=compute_dtype), got,
      rtol=0, atol=0)
  with torch.no_grad():
    want = tfm.fused_mlp_reference(
        x, layers, mlp.skips, mlp.hidden_activation, mlp.output_activation,
        has_out, compute_dtype=compute_dtype)
  if compute_dtype is None:
    # float32 sums in another order than cuBLAS.
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
  else:
    # As test_fused_mlp_kernel_matches_plain_on_card: 2 to 4 bf16 ulps.
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=2 ** -6, atol=2 ** -6 * scale)


# One stack of each hidden width class of K3 (nerf_ds's NeRF trunk, SE(3)
# trunk and hyper sheet, with their input widths), at row counts at the
# edges of the kernel's 64-row tile.
K3_STACKS = {
    256: dict(in_dim=52, depth=8, width=256, skips=(4,)),
    128: dict(in_dim=33, depth=6, width=128, skips=(4,)),
    64: dict(in_dim=45, depth=6, width=64, skips=(4,), output_channels=2),
}
K3_TILE_EDGES = (1, tfm.KERNEL_TILE_ROWS - 1, tfm.KERNEL_TILE_ROWS + 1,
                 64 * tfm.KERNEL_TILE_ROWS)


@pytest.mark.cuda
@pytest.mark.parametrize('n', K3_TILE_EDGES)
@pytest.mark.parametrize('width', list(K3_STACKS))
def test_fused_mlp_kernel_at_tile_edges(cuda, width, n):
  check_fused_mlp(cuda, random_mlp(cuda, width, **K3_STACKS[width]), n,
                  seed=n)


@pytest.mark.cuda
@pytest.mark.parametrize('skips', [(), (1,)])
def test_fused_mlp_kernel_widest_input(cuda, skips):
  # 1024 input channels stream through the kernel's input ring.
  mlp = random_mlp(cuda, 5, 1024, 2, 256, skips, output_channels=3)
  check_fused_mlp(cuda, mlp, 4099, seed=6)


@pytest.mark.cuda
@pytest.mark.parametrize('compute_dtype', [None, torch.bfloat16])
@pytest.mark.parametrize('act', ['relu', 'sigmoid', 'softplus', 'tanh',
                                 'none'])
def test_fused_mlp_kernel_each_activation(cuda, act, compute_dtype):
  # Width 40 pads to 64 columns, where sigmoid and softplus put act(0) != 0;
  # skips at layer 0 and 2 re-read the 45 input channels.
  mlp = random_mlp(cuda, 7, 45, 3, 40, (0, 2), act, output_channels=3,
                   output_activation=None if act == 'none' else act)
  check_fused_mlp(cuda, mlp, 4099, seed=8, compute_dtype=compute_dtype)


# Stacks that put each kind of layer boundary in K3 (where a layer's bias
# slot and weights change): 256 -> 256, 128 -> 128 and 64 -> 64 with a skip
# at layer 4 (the input ring entered mid-stack), a hidden layer into the
# 16-wide head after 128 and after 64, a skip at layer 1, one layer (no
# boundary) and the most layers the kernel takes (16 hidden and the head).
K3_BOUNDARY_STACKS = {
    'wide_skip4': dict(in_dim=52, depth=8, width=256, skips=(4,)),
    'narrow_skip4_head': dict(in_dim=44, depth=8, width=128, skips=(4,),
                              output_channels=1, output_activation='relu'),
    'sheet_skip4_head': dict(in_dim=45, depth=6, width=64, skips=(4,),
                             output_channels=2),
    'skip1_head': dict(in_dim=45, depth=3, width=64, skips=(1,),
                       output_channels=3),
    'one_layer': dict(in_dim=256, depth=0, width=0, skips=(),
                      output_channels=4),
    'max_layers': dict(in_dim=45, depth=tfm.KERNEL_MAX_LAYERS - 1, width=64,
                       skips=(4,), output_channels=16),
}


@pytest.mark.cuda
@pytest.mark.parametrize('n', (4099, 65, 63, 1, 0))
@pytest.mark.parametrize('stack', list(K3_BOUNDARY_STACKS))
def test_fused_mlp_kernel_across_layer_boundaries(cuda, stack, n):
  check_fused_mlp(cuda, random_mlp(cuda, 21, **K3_BOUNDARY_STACKS[stack]),
                  n, seed=n + 3)


@pytest.mark.cuda
@pytest.mark.parametrize('stack', ['wide_skip4', 'narrow_skip4_head',
                                   'sheet_skip4_head'])
def test_fused_mlp_kernel_layer_boundaries_bf16(cuda, stack):
  check_fused_mlp(cuda, random_mlp(cuda, 22, **K3_BOUNDARY_STACKS[stack]),
                  4099, seed=9, compute_dtype=torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize('width', [256, 128])
def test_fused_mlp_kernel_widest_input_mid_stack(cuda, width):
  # 1024 input channels re-fed at layer 2: 32 or 64 chunks of x's rows
  # between the h products of a stack.
  mlp = random_mlp(cuda, 23, 1024, 4, width, (2,), output_channels=3)
  check_fused_mlp(cuda, mlp, 4099, seed=10)


def config2_step(rays: str):
  """BASELINE config[2] (hypernerf with the elastic, background and
  hyper-reg losses; K2 compositing) at 32 + 32 samples, and a batch with
  its background draws: 512 rays of the synthetic scene ('synthetic'), or
  64 random rays from near the origin out to |x| = 2.1 ('random').
  Returns grads(device, batch) and the batch."""
  import dataclasses
  from nerfds_torch import config as config_lib
  from nerfds_torch.datasets import SyntheticDataSource
  from nerfds_torch.models import NerfDSModel
  from nerfds_torch.training import step as step_lib
  source = SyntheticDataSource(num_frames=4, image_size=32, gt_samples=32)
  rng = np.random.RandomState(1)
  if rays == 'synthetic':
    store = source.build_ray_store(source.train_ids)
    idx = np.random.RandomState(0).choice(store.num_rays, 512, replace=False)
    batch = {'origins': store.origins[idx],
             'directions': store.directions[idx], 'rgb': store.rgb[idx],
             'metadata': {'warp': store.metadata['warp'][idx]}}
    near, far = source.near, source.far
  else:
    directions = rng.randn(64, 3).astype(np.float32)
    directions /= np.linalg.norm(directions, axis=-1, keepdims=True)
    batch = {'origins': rng.randn(64, 3).astype(np.float32) * 0.1,
             'directions': directions,
             'rgb': rng.rand(64, 3).astype(np.float32),
             'metadata': {'warp': rng.randint(0, 4, (64, 1))}}
    near, far = 0.2, 2.0
  batch.update(background_points=source.load_points()[:256],
               background_metadata=rng.randint(0, 4, (256, 1)),
               background_noise=rng.randn(256, 3).astype(np.float32) * 1e-3)
  model_cfg = dataclasses.replace(
      config_lib.hypernerf(), num_coarse_samples=32, num_fine_samples=32,
      use_stratified_sampling=False, use_pallas_compositing=True)
  train_cfg = dataclasses.replace(
      config_lib.TrainConfig(batch_size=len(batch['origins'])),
      use_elastic_loss=True, use_background_loss=True,
      background_loss_weight=1.0, use_hyper_reg_loss=True,
      hyper_reg_loss_weight=0.001, warp_alpha_schedule=('constant', 4.0))
  scalars = step_lib.eval_schedules(step_lib.build_schedules(train_cfg), 0)

  def grads(device, batch):
    model = NerfDSModel(model_cfg, num_warp_embeds=4, num_hyper_embeds=4,
                        near=near, far=far, device=device)
    to = lambda x: ({k: to(v) for k, v in x.items()} if isinstance(x, dict)
                    else t(x).to(device))
    g, stats = step_lib._grads(step_lib.make_loss_fn(model, train_cfg),
                               dict(model.named_parameters()), to(batch),
                               None, scalars)
    assert {'loss/elastic', 'loss/hyper_reg'} <= set(stats['coarse'])
    assert np.isfinite(float(stats['loss/background']))
    return {k: v.cpu() for k, v in g.items()}

  return grads, batch


def worst_rel(got, want):
  return max(float((got[k] - w).norm() / w.norm().clamp_min(1e-30))
             for k, w in want.items())


@pytest.mark.parametrize('rays', ['synthetic', 'random'])
def test_config2_step_float32_floor(rays):
  """The step's own float32 floor on the CPU: moving the ray origins by
  one ulp moves the gradients by 5.5e-4 of a gradient's norm on the
  synthetic scene's rays, and by 1.1e-3 on the random rays, where the
  2^7·x posenc bands amplify the points' rounding and the gradients at
  initialisation cancel. The card test below runs on the former, where
  its 1e-3 resolves a real disagreement."""
  grads, batch = config2_step(rays)
  nudged = dict(batch, origins=np.nextafter(batch['origins'],
                                            np.float32(np.inf)))
  floor = worst_rel(grads('cpu', nudged), grads('cpu', batch))
  if rays == 'synthetic':
    assert floor < 7e-4, floor
  else:
    assert floor > 7e-4, floor


@pytest.mark.cuda
def test_config2_step_on_card_matches_cpu(cuda):
  """One BASELINE config[2] step on the card (K2) against the same step
  on the CPU (K2's plain version), from the same params, batch and
  background draws, on the synthetic scene's rays (their float32 floor:
  ``test_config2_step_float32_floor``)."""
  grads, batch = config2_step('synthetic')
  before = kernels.launch_counts['composite_fwd']
  on_card = grads(cuda, batch)
  assert kernels.launch_counts['composite_fwd'] == before + 2
  assert worst_rel(on_card, grads('cpu', batch)) < 1e-3


def sigma_normals_step():
  """nerf_ds() with ∇σ as the colour's normal and the reflected view
  direction (``use_sigma_gradient``, ``use_ref_radiance``, no predicted
  normal; K1 with a σ-only head), 'fused' ∇σ and K2, at 32 + 32 samples,
  and 512 rays of the synthetic scene. The normal input's posenc window is
  open, so the rgb loss reaches K1b's Ḡ. Returns grads(device, batch) and
  the batch."""
  import dataclasses
  from nerfds_torch import config as config_lib
  from nerfds_torch.datasets import SyntheticDataSource
  from nerfds_torch.models import NerfDSModel
  from nerfds_torch.training import step as step_lib
  source = SyntheticDataSource(num_frames=4, image_size=32, gt_samples=32)
  store = source.build_ray_store(source.train_ids)
  idx = np.random.RandomState(0).choice(store.num_rays, 512, replace=False)
  batch = {'origins': store.origins[idx], 'directions': store.directions[idx],
           'rgb': store.rgb[idx], 'mask': store.mask[idx],
           'metadata': {'warp': store.metadata['warp'][idx]}}
  model_cfg = dataclasses.replace(
      config_lib.nerf_ds(), num_coarse_samples=32, num_fine_samples=32,
      use_stratified_sampling=False, use_pallas_compositing=True,
      sigma_gradient_mode='fused', predict_norm=False,
      use_predicted_norm=False, use_sigma_gradient=True,
      stop_norm_gradient=False, use_ref_radiance=True)
  train_cfg = dataclasses.replace(
      config_lib.nerf_ds_train_config(batch_size=512),
      warp_alpha_schedule=('constant', 4.0),
      norm_input_alpha_schedule=('constant', 4.0))
  scalars = step_lib.eval_schedules(step_lib.build_schedules(train_cfg), 0)

  def grads(device, batch):
    model = NerfDSModel(model_cfg, num_warp_embeds=4, num_hyper_embeds=4,
                        near=source.near, far=source.far, device=device)
    to = lambda x: ({k: to(v) for k, v in x.items()} if isinstance(x, dict)
                    else t(x).to(device))
    g, stats = step_lib._grads(step_lib.make_loss_fn(model, train_cfg),
                               dict(model.named_parameters()), to(batch),
                               None, scalars)
    assert np.isfinite(float(stats['fine']['loss/rgb']))
    return {k: v.cpu() for k, v in g.items()}

  return grads, batch


def sigma_normals_floor(grads, batch):
  """The step's own float32 floor on the CPU: the worst tensor's
  |g' − g| / |g| with the rays' origins moved by one ulp."""
  nudged = dict(batch, origins=np.nextafter(batch['origins'],
                                            np.float32(np.inf)))
  return worst_rel(grads('cpu', nudged), grads('cpu', batch))


def test_sigma_normals_step_float32_floor():
  """With ∇σ feeding the colour, the step at initialisation is far more
  sensitive to float32 rounding than config[2]'s: normalize(∇σ) multiplies
  it by 1/|∇σ|, and |∇σ| is small wherever the fresh density is nearly
  flat. A one-ulp move of the origins moves the worst gradient by more
  than 1e-3 of its norm (6.9e-2, the coarse σ head's, when measured), so
  the card test below holds the card within twice this floor."""
  grads, batch = sigma_normals_step()
  assert sigma_normals_floor(grads, batch) > 1e-3


@pytest.mark.cuda
def test_sigma_normals_step_on_card_matches_cpu(cuda):
  """One step of the radiance variant (a) on the card (K1f, K1b with a
  σ-only head and Ḡ from the rgb loss, K2) against the same step on the
  CPU (their plain versions), from the same params and batch: within
  twice the step's own float32 floor."""
  grads, batch = sigma_normals_step()
  names = ('fused_trunk_fwd', 'fused_trunk_bwd', 'composite_fwd')
  before = {k: kernels.launch_counts[k] for k in names}
  on_card = grads(cuda, batch)
  assert all(kernels.launch_counts[k] == before[k] + 2 for k in names)
  floor = sigma_normals_floor(grads, batch)
  assert worst_rel(on_card, grads('cpu', batch)) < max(1e-3, 2 * floor)


def variant_step(name: str):
  """nerf_ds() at 32 + 32 samples with (b) ``concat_dense_inputs`` or (c)
  the bone warp field and its background loss, on 512 rays of the
  synthetic scene (and, for (c), 256 of its static points with fixed
  draws). Returns grads(device, batch, kernels) and the batch: the kernel
  path is 'fused' ∇σ (K1f, K1b) with K2, the plain path 'vmap' with plain
  compositing."""
  import dataclasses
  from nerfds_torch import config as config_lib
  from nerfds_torch.datasets import SyntheticDataSource
  from nerfds_torch.models import NerfDSModel
  from nerfds_torch.training import step as step_lib
  source = SyntheticDataSource(num_frames=4, image_size=32, gt_samples=32)
  store = source.build_ray_store(source.train_ids)
  idx = np.random.RandomState(0).choice(store.num_rays, 512, replace=False)
  batch = {'origins': store.origins[idx], 'directions': store.directions[idx],
           'rgb': store.rgb[idx], 'mask': store.mask[idx],
           'metadata': {'warp': store.metadata['warp'][idx]}}
  flags = {'concat_dense_inputs': dict(concat_dense_inputs=True),
           'bone': dict(use_bone=True)}[name]
  train_cfg = dataclasses.replace(
      config_lib.nerf_ds_train_config(batch_size=512),
      warp_alpha_schedule=('constant', 4.0),
      norm_input_alpha_schedule=('constant', 4.0))
  if name == 'bone':
    rng = np.random.RandomState(1)
    batch.update(background_points=source.load_points()[:256],
                 background_metadata=rng.randint(0, 4, (256, 1)),
                 background_noise=rng.randn(256, 3).astype(np.float32) * 1e-3)
    train_cfg = dataclasses.replace(train_cfg, use_background_loss=True,
                                    background_loss_weight=1.0)
  scalars = step_lib.eval_schedules(step_lib.build_schedules(train_cfg), 0)

  def grads(device, batch, kernel_path):
    model_cfg = dataclasses.replace(
        config_lib.nerf_ds(), num_coarse_samples=32, num_fine_samples=32,
        use_stratified_sampling=False, use_pallas_compositing=kernel_path,
        sigma_gradient_mode='fused' if kernel_path else 'vmap', **flags)
    model = NerfDSModel(model_cfg, num_warp_embeds=4, num_hyper_embeds=4,
                        near=source.near, far=source.far, device=device)
    to = lambda x: ({k: to(v) for k, v in x.items()} if isinstance(x, dict)
                    else t(x).to(device))
    g, stats = step_lib._grads(step_lib.make_loss_fn(model, train_cfg),
                               dict(model.named_parameters()), to(batch),
                               None, scalars)
    assert np.isfinite(float(stats['fine']['loss/rgb']))
    if name == 'bone':
      assert np.isfinite(float(stats['loss/background']))
    return {k: v.cpu() for k, v in g.items()}

  return grads, batch


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['concat_dense_inputs', 'bone'])
def test_variant_step_kernel_path_matches_plain_on_card(cuda, name):
  """One step of (b) or (c) on the card through K1f, K1b and K2 (each
  launched twice: the coarse and fine levels) against the plain path on
  the card, from the same params and batch: within max(1e-3, twice the
  plain step's float32 floor, its gradients' move when the origins move
  one ulp)."""
  grads, batch = variant_step(name)
  names = ('fused_trunk_fwd', 'fused_trunk_bwd', 'composite_fwd')
  before = {k: kernels.launch_counts[k] for k in names}
  got = grads(cuda, batch, True)
  assert all(kernels.launch_counts[k] == before[k] + 2 for k in names)
  want = grads(cuda, batch, False)
  nudged = dict(batch, origins=np.nextafter(batch['origins'],
                                            np.float32(np.inf)))
  floor = worst_rel(grads(cuda, nudged, False), want)
  assert worst_rel(got, want) < max(1e-3, 2 * floor)
  if name == 'bone':
    assert float(got['bone_warp_field.moving_mlp.hidden_0.kernel'].abs()
                 .max()) > 0


@pytest.mark.cuda
def test_host_ray_iterator_on_card(cuda):
  """Batches copied on the sampler's side stream reach the consumer's
  stream as numpy's gather of RandomState(seed)'s indices; close() joins
  the worker."""
  from nerfds_torch.datasets.core import HostRayIterator, RayStore
  rng = np.random.RandomState(0)
  columns = dict(origins=rng.randn(5000, 3).astype(np.float32),
                 directions=rng.randn(5000, 3).astype(np.float32),
                 rgb=rng.rand(5000, 3).astype(np.float32),
                 mask=rng.rand(5000, 1).astype(np.float32),
                 metadata={'warp': rng.randint(0, 9, (5000, 1)).astype(
                     np.int32)})
  it = HostRayIterator(RayStore.from_dict(columns), 512, seed=3, device=cuda)
  draws = np.random.RandomState(3)
  try:
    for _ in range(6):
      batch = next(it)
      idx = draws.randint(0, 5000, 512)
      # Work on the consumer's stream first: a batch read before its copy
      # landed would differ.
      total = sum(float(batch[k].double().sum()) for k in ('origins', 'rgb'))
      for k in ('origins', 'directions', 'rgb', 'mask'):
        assert batch[k].device.type == 'cuda'
        np.testing.assert_array_equal(batch[k].cpu().numpy(), columns[k][idx])
      np.testing.assert_array_equal(batch['metadata']['warp'].cpu().numpy(),
                                    columns['metadata']['warp'][idx])
      assert total == pytest.approx(float(columns['origins'][idx].sum(
          dtype=np.float64) + columns['rgb'][idx].sum(dtype=np.float64)))
  finally:
    it.close()
  assert not it._thread.is_alive()


@pytest.mark.cuda
def test_bench_kernel_path_matches_plain_on_card(cuda):
  """One step of ``nerfds_torch.bench.build`` at batch 512 on the kernel
  path (K1f, K1b and K2 twice each) against the plain path, from the same
  parameters, batch and draws: Adam's first moment (a tenth of the
  gradient) within 1e-3 of each tensor's norm."""
  from nerfds_torch import bench
  names = ('fused_trunk_fwd', 'fused_trunk_bwd', 'composite_fwd')
  moments = {}
  for path in bench.PATHS:
    state, step_fn, batch = bench.build(512, path=path, device=cuda)
    before = {k: kernels.launch_counts[k] for k in names}
    new, stats = step_fn(state, batch,
                         torch.Generator(device=cuda).manual_seed(7))
    assert np.isfinite(float(stats['fine']['loss/total']))
    want = 2 if path == 'kernel' else 0
    assert all(kernels.launch_counts[k] == before[k] + want for k in names)
    moments[path] = {k: v.cpu() for k, v in new.opt_state.mu.items()}
  assert worst_rel(moments['kernel'], moments['plain']) < 1e-3


# The stacks of nerf_ds() that MLP.forward sends to K3 under no_grad, with
# the feature blocks the model hands them: the NeRF trunk (the canonical
# point's posenc and the hyper point's), the mask MLP (posenc and the mask
# embedding), the SE(3) trunk (posenc and the warp embedding) and the hyper
# sheet (posenc and the hyper embedding).
ROUTED_STACKS = {
    'nerf_trunk': (dict(in_dim=52, depth=8, width=256, skips=(4,)),
                   (39, 13)),
    'mask_mlp': (dict(in_dim=44, depth=8, width=128, skips=(4,),
                      output_channels=1, output_activation='relu'), (36, 8)),
    'se3_trunk': (dict(in_dim=33, depth=6, width=128, skips=(4,)), (25, 8)),
    'hyper_sheet': (dict(in_dim=45, depth=6, width=64, skips=(4,),
                         output_channels=2), (37, 8)),
}


@pytest.mark.cuda
@pytest.mark.parametrize('name', list(ROUTED_STACKS))
def test_mlp_forward_routes_no_grad_stacks_to_k3(cuda, name):
  kw, widths = ROUTED_STACKS[name]
  mlp = random_mlp(cuda, 12, **kw)
  gen = torch.Generator().manual_seed(13)
  blocks = [(torch.rand(4099, w, generator=gen) * 2 - 1).to(cuda)
            for w in widths]
  layers, has_out = tfm.mlp_params_to_layers(mlp, None)
  want = tfm.fused_mlp_reference(
      torch.cat(blocks, -1), layers, mlp.skips, mlp.hidden_activation,
      mlp.output_activation, has_out)
  before = kernels.launch_counts['fused_mlp_fwd']
  with torch.no_grad():
    assert mlp.k3_refusal(blocks) is None
    got = mlp(blocks)
  assert kernels.launch_counts['fused_mlp_fwd'] == before + 1
  # As check_fused_mlp: float32 sums in another order than cuBLAS.
  torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
  # Again from the kept operands, over 4097 = 17 x 241 of the rows with a
  # leading batch axis: the same bits.
  with torch.no_grad():
    again = mlp([b[:4097].reshape(17, 241, -1) for b in blocks])
  assert kernels.launch_counts['fused_mlp_fwd'] == before + 2
  torch.testing.assert_close(again.reshape(4097, -1), got[:4097], rtol=0,
                             atol=0)
  # Grad mode on: the plain chain, and the gradient reaches the weights.
  out = mlp(blocks)
  assert kernels.launch_counts['fused_mlp_fwd'] == before + 2
  torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
  out.square().sum().backward()
  assert all(p.grad is not None and p.grad.abs().sum() > 0
             for p in mlp.parameters())


@pytest.mark.cuda
def test_render_image_runs_k3_eight_times_a_chunk(cuda, monkeypatch):
  """A no-grad render of a seeded full-width nerf_ds() launches K3 for the
  NeRF trunk, the mask MLP, the SE(3) trunk and the hyper sheet of each
  level, and its outputs match the same render with every MLP on its
  plain chain within the render cell's limits (rgb 1e-4, acc 1e-5, depth
  2e-5, normal 5e-5)."""
  from nerfds_torch import config
  from nerfds_torch.evaluation import render as render_lib
  from nerfds_torch.models.nerfds import NerfDSModel, default_extra_params
  cfg = config.nerf_ds()
  model = NerfDSModel(cfg, num_warp_embeds=4, num_hyper_embeds=4,
                      generator=torch.Generator().manual_seed(0),
                      device=cuda)
  with torch.no_grad():
    for name, p in model.named_parameters():
      if name.endswith('bias'):
        p.uniform_(-0.1, 0.1)
  rng = np.random.RandomState(1)
  size, chunk = 40, 512
  dirs = rng.randn(size, size, 3).astype(np.float32)
  dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
  rays = {'origins': rng.randn(size, size, 3).astype(np.float32) * 0.1,
          'directions': dirs,
          'metadata': {'warp': np.full((size, size, 1), 2, np.int32)}}
  extra = default_extra_params(cfg)

  def render():
    return render_lib.render_image(
        model, rays, extra, chunk=chunk,
        generator=torch.Generator(device=cuda).manual_seed(3))

  before = kernels.launch_counts['fused_mlp_fwd']
  prefetched = kernels.launch_counts['fused_mlp_fwd_prefetched_layers']
  got = render()
  chunks = -(-size * size // chunk)
  assert kernels.launch_counts['fused_mlp_fwd'] == before + 8 * chunks
  # 8, 9, 6 and 7 layers a level (NeRF trunk, mask MLP, SE(3) trunk,
  # hyper sheet), each with its bias staged ahead of its epilogue.
  assert kernels.launch_counts['fused_mlp_fwd_prefetched_layers'] == (
      prefetched + 60 * chunks)
  monkeypatch.setattr(MLP, 'k3_refusal', lambda self, *a, **k: 'off')
  want = render()
  assert kernels.launch_counts['fused_mlp_fwd'] == before + 8 * chunks
  for key, limit in (('rgb', 1e-4), ('acc', 1e-5), ('depth', 2e-5),
                     ('ray_norm', 5e-5)):
    gap = np.abs(got[key].astype(np.float64) - want[key]).max()
    assert gap <= limit, (key, gap)
