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


def nerf_ds_trunk(cuda, gen):
  """The nerf_ds NeRF trunk (8x256, skip at 4, 52 inputs, σ + normal head,
  bottleneck) on the card."""
  tm = NerfMLP(52, 0, 0, True, trunk_depth=8, trunk_width=256, skips=(4,),
               predict_norm=True, generator=gen).to(cuda)
  spec = tft.TrunkSpec(depth=8, width=256, skips=(4,), in_dim=52,
                       alpha_channels=1, norm_dim=3, has_bottleneck=True)
  return spec, tm.trunk_weights()


def check_trunk_forward(cuda, n, seed):
  gen = torch.Generator().manual_seed(seed)
  spec, weights = nerf_ds_trunk(cuda, gen)
  feat = torch.rand(n, 52, generator=gen).to(cuda) * 2 - 1
  with torch.no_grad():
    before = kernels.launch_counts['fused_trunk_fwd']
    got = tft.trunk_sigma_grad(feat, weights, spec)
    want = tft.trunk_sigma_grad_reference(feat, weights, spec)
  assert kernels.launch_counts['fused_trunk_fwd'] == before + 1
  for name, g, w in zip(('sigma', 'normal', 'trunk', 'bneck'), got, want):
    torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4, msg=name)
  # g follows the relu masks; a pre-activation within rounding of 0 may
  # fall on the other side of the kink in the two versions.
  bad = ((got[4] - want[4]).abs() > 1e-4 + 1e-4 * want[4].abs()).float()
  assert bad.mean().item() <= 1e-3


@pytest.mark.cuda
def test_fused_trunk_kernel_matches_plain_on_card(cuda):
  check_trunk_forward(cuda, 4099, seed=0)


# Row counts at the edges of the kernels' row tile: one row, a tile short
# of one row, one row into a second tile, and whole tiles (4096 rows: two
# whole weight-grad splits of the backward).
TILE_EDGES = (1, tft.KERNEL_TILE_ROWS - 1, tft.KERNEL_TILE_ROWS + 1,
              64 * tft.KERNEL_TILE_ROWS)


@pytest.mark.cuda
@pytest.mark.parametrize('n', TILE_EDGES)
def test_fused_trunk_kernel_at_tile_edges(cuda, n):
  check_trunk_forward(cuda, n, seed=n)


def check_trunk_backward(cuda, n, seed):
  gen = torch.Generator().manual_seed(seed)
  spec, weights = nerf_ds_trunk(cuda, gen)
  feat = (torch.rand(n, 52, generator=gen) * 2 - 1).to(cuda)
  cots = tuple(torch.randn(n, c, generator=gen).to(cuda)
               for c in (1, 3, 256, 256, 52))
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
def test_fused_trunk_backward_kernel_matches_plain_on_card(cuda):
  # A ragged last tile and a ragged last weight-grad split.
  check_trunk_backward(cuda, 4099, seed=1)


@pytest.mark.cuda
@pytest.mark.parametrize('n', TILE_EDGES)
def test_fused_trunk_backward_kernel_at_tile_edges(cuda, n):
  check_trunk_backward(cuda, n, seed=n + 1)


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
  x = (torch.rand(n, mlp.in_dim, generator=torch.Generator().manual_seed(
      seed)) * 2 - 1).to(cuda)
  before = kernels.launch_counts['fused_mlp_fwd']
  got = tfm.fused_apply(mlp, None, x, compute_dtype=compute_dtype)
  assert kernels.launch_counts['fused_mlp_fwd'] == before + 1
  layers, has_out = tfm.mlp_params_to_layers(mlp, None)
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
