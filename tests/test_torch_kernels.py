"""The port's kernels: their plain PyTorch versions against the JAX
package's Pallas kernels (interpret mode on the CPU, as the JAX package's
own kernel tests run them), the backward's autograd Function, and the
wrappers' routing. The kernels themselves are held against their plain
versions on the card by ``tests/test_torch_cuda.py``.
"""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfds_tpu.models.mlp import MLP as JaxMLP
from nerfds_tpu.models.mlp import NerfMLP as JaxNerfMLP
from nerfds_tpu.pallas import composite as jcomposite
from nerfds_tpu.pallas import fused_mlp as jfm
from nerfds_tpu.pallas import fused_trunk as jft
from nerfds_torch import kernels
from nerfds_torch.convert import params_from_jax
from nerfds_torch.kernels import composite as tcomposite
from nerfds_torch.kernels import fused_mlp as tfm
from nerfds_torch.kernels import fused_trunk as tft
from nerfds_torch.models.mlp import MLP, NerfMLP
from nerfds_torch.ops import rendering as trendering

torch.set_num_threads(1)


def t(x):
  return torch.from_numpy(np.array(x))


def composite_inputs(num_rays=37, num_samples=16, seed=0):
  rng = np.random.RandomState(seed)
  rgb = rng.rand(num_rays, num_samples, 3).astype(np.float32)
  sigma = (rng.rand(num_rays, num_samples) * 3).astype(np.float32)
  z = np.sort(rng.rand(num_rays, num_samples).astype(np.float32) * 3 + 1, -1)
  dirs = rng.randn(num_rays, 3).astype(np.float32)
  return rgb, sigma, z, dirs


@pytest.mark.parametrize('sample_at_infinity', [True, False])
def test_composite_plain_matches_pallas(sample_at_infinity):
  # 37 rays on a 16-ray tile: a ragged tail on the Pallas side.
  args = composite_inputs()
  want = jcomposite.composite(*map(jnp.asarray, args), sample_at_infinity,
                              1e-10, 16, True)
  got = tcomposite.composite_forward(*map(t, args), sample_at_infinity)
  # Tolerance: the Pallas kernel forms the running product as
  # exp(cumsum(log)), the plain version with torch.cumprod; float32.
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                               atol=1e-6)


def test_composite_gradient_matches_jax():
  rgb, sigma, z, dirs = composite_inputs(num_rays=12, num_samples=8, seed=1)
  target = np.random.RandomState(2).rand(12, 3).astype(np.float32)

  def jloss(rgb, sigma, z, dirs):
    out_rgb, depth, _, weights, *_ = jcomposite.composite(
        rgb, sigma, z, dirs, True, 1e-10, 8, True)
    return (jnp.mean((out_rgb - target) ** 2) + jnp.mean(depth)
            + jnp.mean(weights ** 2))

  want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
      *map(jnp.asarray, (rgb, sigma, z, dirs)))
  inputs = [t(a).requires_grad_() for a in (rgb, sigma, z, dirs)]
  out_rgb, depth, _, weights, *_ = tcomposite.composite(*inputs)
  loss = (((out_rgb - t(target)) ** 2).mean() + depth.mean()
          + (weights ** 2).mean())
  got = torch.autograd.grad(loss, inputs)
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                               atol=1e-6)


def test_volumetric_rendering_kernel_route_matches_plain():
  rgb, sigma, z, dirs = map(t, composite_inputs(num_rays=9, seed=3))
  for at_inf in (True, False):
    a = trendering.volumetric_rendering(rgb, sigma, z, dirs, True, at_inf,
                                        use_kernel=True)
    b = trendering.volumetric_rendering(rgb, sigma, z, dirs, True, at_inf)
    for k in b:
      torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_composite_wrapper_checks_inputs():
  rgb, sigma, z, dirs = map(t, composite_inputs(num_rays=4, num_samples=5))
  with pytest.raises(ValueError):
    tcomposite.composite_forward(rgb[:, :4], sigma, z, dirs)
  with pytest.raises(TypeError):
    tcomposite.composite_forward(rgb.double(), sigma, z, dirs)
  before = dict(kernels.launch_counts)
  tcomposite.composite_forward(rgb, sigma, z, dirs)
  assert kernels.launch_counts == before  # the CPU path launches nothing


def trunk_case(n=37, norm_dim=3, has_bottleneck=True, seed=0):
  """The JAX fused-trunk test's toy spec: depth 3, width 32, skip at 2."""
  depth, width, skips, in_dim = 3, 32, (2,), 12
  jm = JaxNerfMLP(trunk_depth=depth, trunk_width=width, skips=skips,
                  rgb_branch_depth=1, rgb_branch_width=16, alpha_channels=1,
                  predict_norm=norm_dim > 0, norm_dim=max(norm_dim, 3))
  params = jax.device_get(
      jm.init(jax.random.PRNGKey(seed), in_dim, 0, 8, has_bottleneck))
  tm = NerfMLP(in_dim, 0, 8, has_bottleneck, trunk_depth=depth,
               trunk_width=width, skips=skips, rgb_branch_width=16,
               predict_norm=norm_dim > 0)
  tm.load_state_dict(params_from_jax(params))
  jspec = jft.TrunkSpec(depth=depth, width=width, skips=skips, in_dim=in_dim,
                        alpha_channels=1, norm_dim=norm_dim,
                        has_bottleneck=has_bottleneck)
  tspec = tft.TrunkSpec(depth=depth, width=width, skips=skips, in_dim=in_dim,
                        alpha_channels=1, norm_dim=norm_dim,
                        has_bottleneck=has_bottleneck)
  feat = np.random.RandomState(seed + 1).randn(n, in_dim).astype(np.float32)
  return params, jspec, tm, tspec, feat


@pytest.mark.parametrize('norm_dim,has_bottleneck', [(3, True), (0, False)])
def test_fused_trunk_plain_matches_pallas(norm_dim, has_bottleneck):
  # N = 37 on a 16-row tile: a ragged tail on the Pallas side.
  params, jspec, tm, tspec, feat = trunk_case(norm_dim=norm_dim,
                                              has_bottleneck=has_bottleneck)
  f = jft.make_trunk_sigma_grad(jspec, tile=16, interpret=True,
                                compute_dtype=jnp.float32)
  want = f(jnp.asarray(feat), *jft.trunk_params_flat(jspec, params))
  with torch.no_grad():
    got = tft.trunk_sigma_grad(t(feat), tm.trunk_weights(), tspec)
  # Tolerance: float32 matmuls of XLA and of torch sum in another order.
  for g, w in zip(got, want):
    if w is None:
      assert g is None
      continue
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                               atol=1e-5)


def test_fused_trunk_plain_matches_autograd():
  """g from the explicit reverse sweep equals autograd of σ in the port."""
  _, _, tm, tspec, feat = trunk_case(n=19, seed=4)
  x = t(feat).requires_grad_()
  trunk_out, bottleneck = tm.query_bottleneck(x)
  sigma, norm = tm.query_sigma(trunk_out, bottleneck)
  (g_autograd,) = torch.autograd.grad(sigma.sum(), x)
  with torch.no_grad():
    s, n, tr, b, g = tft.trunk_sigma_grad(t(feat), tm.trunk_weights(), tspec)
  for got, want in ((s, sigma), (n, norm), (tr, trunk_out), (b, bottleneck),
                    (g, g_autograd)):
    torch.testing.assert_close(got, want.detach(), rtol=1e-6, atol=1e-6)


def test_fused_trunk_wrapper_checks_inputs():
  _, _, tm, tspec, feat = trunk_case(n=5)
  with torch.no_grad():
    with pytest.raises(ValueError):
      tft.trunk_sigma_grad(t(feat)[:, :10], tm.trunk_weights(), tspec)
    with pytest.raises(TypeError):
      tft.trunk_sigma_grad(t(feat).double(), tm.trunk_weights(), tspec)
    # The CUDA kernel's limits (width 256, ...) are checked before a launch.
    with pytest.raises(ValueError, match='width 256'):
      tft._check_kernel_limits(tspec, 4)


def cuda_constants(name):
  """The literal ``constexpr int`` values of a source in kernels/csrc."""
  text = (pathlib.Path(tft.__file__).parent / 'csrc' / name).read_text()
  return {m.group(1): int(m.group(2))
          for m in re.finditer(r'constexpr int (\w+) = (\d+);', text)}


def test_trunk_kernel_constants_match_the_cuda_sources():
  """The wrapper's tile rows and limits are those compiled into the trunk
  kernels, and a block's shared memory fits the H100's 232,448 bytes at
  the deepest trunk each kernel takes."""
  tile = cuda_constants('trunk_tile.cuh')
  fwd = cuda_constants('fused_trunk_fwd.cu')
  bwd = cuda_constants('fused_trunk_bwd.cu')
  assert tile['TM'] == tft.KERNEL_TILE_ROWS
  assert tile['WIDTH'] == tft.KERNEL_WIDTH
  assert tile['DMAX'] == tft.KERNEL_MAX_IN_DIM
  assert tile['HCMAX'] == tft.KERNEL_MAX_HEAD
  assert tile['NW'] == tft.KERNEL_NARROW_WIDTH
  assert fwd['MAXD'] == tft.KERNEL_MAX_DEPTH
  assert bwd['MAXD'] == tft.KERNEL_BWD_MAX_DEPTH
  # trunk_tile.cuh's layout: [256][TM + 4] activation tiles, a
  # [DMAX][TM + 4] input tile, STAGES chunks of KC weight rows, 2 KB of
  # relu bits a layer.
  act = 4 * tile['WIDTH'] * (tile['TM'] + 4)
  ring = 4 * tile['STAGES'] * tile['KC'] * tile['WIDTH']
  bits = 8 * tile['NT']
  fwd_bytes = (act + 4 * tile['DMAX'] * (tile['TM'] + 4) + ring
               + bits * tft.KERNEL_MAX_DEPTH)
  bwd_bytes = 2 * act + ring + bits * tft.KERNEL_BWD_MAX_DEPTH
  assert fwd_bytes <= 232_448 and bwd_bytes <= 232_448, (fwd_bytes,
                                                         bwd_bytes)
  # The backward's row splits depend on N alone, and cover every row.
  for n in (1, 2047, 2048, 4099, 32_768, 65_536, 10**6):
    splits = tft.backward_splits(n)
    assert 1 <= splits <= tft.KERNEL_BWD_MAX_SPLITS
    assert splits * -(-n // splits) >= n


def trunk_cotangents(spec, n, seed, only_gbar=False):
  """Seeded cotangents (σ̄, n̄, T̄, B̄, Ḡ) as numpy; n̄ is [N, 1] zeros
  without a normal, as the JAX kernel takes it."""
  rng = np.random.RandomState(seed)
  cols = (1, max(spec.norm_dim, 1), spec.width, spec.width, spec.in_dim)
  cots = [rng.randn(n, c).astype(np.float32) for c in cols]
  if spec.norm_dim == 0:
    cots[1][:] = 0.0
  if only_gbar:
    cots[:4] = [np.zeros_like(c) for c in cots[:4]]
  return cots


def to_port_cots(cots, spec):
  sbar, nbar, tbar, bbar, gbar = map(t, cots)
  return sbar, nbar if spec.norm_dim > 0 else None, tbar, bbar, gbar


@pytest.mark.parametrize('norm_dim,has_bottleneck,only_gbar', [
    (3, True, False), (0, False, False), (3, False, False), (0, True, False),
    (3, True, True)])
def test_fused_trunk_backward_plain_matches_pallas(norm_dim, has_bottleneck,
                                                   only_gbar):
  # N = 37 on a 16-row tile: a padded tail on the Pallas side. only_gbar
  # leaves Ḡ alone nonzero, so the second-order terms are tested alone.
  params, jspec, tm, tspec, feat = trunk_case(norm_dim=norm_dim,
                                              has_bottleneck=has_bottleneck)
  cots = trunk_cotangents(tspec, len(feat), seed=5, only_gbar=only_gbar)
  want_x, want_w = jft._pallas_backward(
      jnp.asarray(feat), jft.trunk_params_flat(jspec, params),
      tuple(map(jnp.asarray, cots)), jspec, 16, True, jnp.float32)
  with torch.no_grad():
    got_x, got_w = tft.trunk_sigma_grad_backward(
        t(feat), tm.trunk_weights(), tspec, to_port_cots(cots, tspec))
  got_flat = tft._flatten(got_w)
  assert len(got_flat) == len(want_w)
  if only_gbar:
    # ∂(Ḡ·g)/∂feat = 0 and no bias sees Ḡ; the kernels' grads do.
    assert float(got_x.abs().max()) == 0.0
    assert float(got_flat[0].abs().max()) > 0.0
  # Tolerance: float32 matmuls of XLA and of torch sum in another order.
  np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=1e-4,
                             atol=1e-5)
  for i, (g, w) in enumerate(zip(got_flat, want_w)):
    np.testing.assert_allclose(g.numpy(), np.asarray(w).reshape(g.shape),
                               rtol=1e-4, atol=1e-5, err_msg=f'grad {i}')


@pytest.mark.parametrize('norm_dim,has_bottleneck', [(3, True), (0, False)])
def test_trunk_sigma_grad_function_matches_double_autograd(norm_dim,
                                                           has_bottleneck):
  """TrunkSigmaGrad's backward (K1b's plain version) against torch's own
  double autograd of the forward's plain version, g included."""
  _, _, tm, tspec, feat = trunk_case(n=21, norm_dim=norm_dim,
                                     has_bottleneck=has_bottleneck, seed=2)
  proj = [t(c) for c in trunk_cotangents(tspec, 21, seed=9)]

  def loss(outs):
    sigma, norm, trunk_out, bneck, g = outs
    out = ((proj[0] * sigma).sum() + (proj[2] * torch.tanh(trunk_out)).sum()
           + (proj[3] * bneck).sum() + (proj[4] * torch.sin(g)).sum())
    return out + (proj[1] * norm).sum() if norm is not None else out

  weights = tm.trunk_weights()
  leaves = [t(feat).requires_grad_(), *tft._flatten(weights)]
  got = torch.autograd.grad(
      loss(tft.trunk_sigma_grad(leaves[0], weights, tspec)), leaves)
  want = torch.autograd.grad(
      loss(tft.trunk_sigma_grad_reference(leaves[0], weights, tspec)),
      leaves)
  for i, (g, w) in enumerate(zip(got, want)):
    torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5, msg=f'leaf {i}')


@pytest.mark.parametrize('row_is', ['flipped_at_kink', 'wrong'])
def test_check_kink_rows(row_is):
  """The card checks' relu-kink rule: a feat̄ row computed with one relu
  flipped at a unit 5e-5 from its kink is proven and reported; a row that
  is wrong otherwise fails the check."""
  n, row, size = 1000, 7, 5e-5
  _, _, tm, tspec, feat = trunk_case(n=n, seed=6)
  x = t(feat)
  cots = to_port_cots(trunk_cotangents(tspec, n, seed=7), tspec)
  with torch.no_grad():
    weights = tm.trunk_weights()
    w0, b0 = weights.layers[0]
    pre = x[row] @ w0 + b0
    unit = int(torch.argmax(pre))
    # Move the unit's bias so that its pre-activation at the row is +size.
    near = b0.clone()
    near[unit] -= pre[unit] - size
    weights = weights._replace(layers=[(w0, near), *weights.layers[1:]])
    want_x, _ = tft.trunk_sigma_grad_backward_reference(x, weights, tspec,
                                                        cots)
    got_x = want_x.clone()
    if row_is == 'wrong':
      got_x[row] += 1.0
      with pytest.raises(AssertionError, match='match no result'):
        tft.check_kink_rows(x, weights, tspec, cots, got_x, want_x)
      return
    flipped = near.clone()
    flipped[unit] -= 2 * size
    got_x[row] = tft.trunk_sigma_grad_backward_reference(
        x[row:row + 1], weights._replace(
            layers=[(w0, flipped), *weights.layers[1:]]), tspec,
        tuple(c[row:row + 1] if c is not None else None for c in cots))[0][0]
    bad, rows, flips = tft.check_kink_rows(x, weights, tspec, cots, got_x,
                                           want_x)
  assert rows == [row] and bool(bad[row]) and int(bad.sum()) == 1
  assert flips[0] == pytest.approx(size, rel=1e-2)


def test_trunk_sigma_grad_function_refuses_double_backward():
  """The CUDA backward's outputs carry no graph, so a second derivative
  through TrunkSigmaGrad raises on every device, the CPU included."""
  _, _, tm, tspec, feat = trunk_case(n=9, seed=3)
  x = t(feat).requires_grad_()
  sigma = tft.trunk_sigma_grad(x, tm.trunk_weights(), tspec)[0]
  # σ̄ = c requires grad, so feat̄ = ∂(c·σ)/∂x has a derivative in c.
  c = torch.ones_like(sigma, requires_grad=True)
  (gx,) = torch.autograd.grad((c * sigma).sum(), x, create_graph=True)
  with pytest.raises(RuntimeError, match='once_differentiable'):
    gx.sum().backward()


def mlp_case(depth, width, skips, out_ch, out_act, hidden_act='relu',
             in_dim=52, n=300, seed=0):
  """A JAX MLP's params and input, and the port's MLP on the same params."""
  jm = JaxMLP(depth=depth, width=width, skips=skips,
              hidden_activation=hidden_act, output_channels=out_ch,
              output_activation=out_act)
  params = jax.device_get(jm.init(jax.random.PRNGKey(seed), in_dim))
  tm = MLP(in_dim, depth, width, skips, hidden_act, out_ch, out_act)
  tm.load_state_dict(params_from_jax(params))
  x = np.random.RandomState(seed + 1).randn(n, in_dim).astype(np.float32)
  return jm, params, tm, x


# The three shapes of the JAX package's own test (300 rows on a 128-row
# tile), its ragged case (77 rows, 16 in), depth 0 (the σ/normal head), and
# each activation as the hidden and the output activation.
K3_CASES = {
    'trunk': dict(depth=8, width=256, skips=(4,), out_ch=0, out_act=None),
    'warp_like': dict(depth=6, width=128, skips=(4,), out_ch=3,
                      out_act=None),
    'mask_like': dict(depth=2, width=64, skips=(), out_ch=1, out_act='relu'),
    'ragged': dict(depth=2, width=32, skips=(), out_ch=4, out_act=None,
                   in_dim=16, n=77),
    'depth0': dict(depth=0, width=0, skips=(), out_ch=4, out_act=None,
                   in_dim=256),
    **{f'act_{a}': dict(depth=3, width=64, skips=(0, 2), out_ch=3,
                        out_act=a, hidden_act=a)
       for a in ('relu', 'sigmoid', 'softplus', 'tanh', 'identity')},
}


@pytest.mark.parametrize('case', list(K3_CASES))
def test_fused_mlp_plain_matches_pallas(case):
  jm, params, tm, x = mlp_case(**K3_CASES[case])
  want = jfm.fused_apply(jm, params, jnp.asarray(x), tile=128,
                         interpret=True)
  got = tfm.fused_apply(tm, params, t(x))
  assert got.dtype == torch.float32 and not got.requires_grad
  # Tolerance: as the JAX package's own test, float32 matmuls of XLA and
  # of torch sum in another order.
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                             atol=1e-5)
  # The module's own parameters, and the port's MLP.forward, which feeds a
  # skip layer's two blocks to split weights (sums in another order).
  torch.testing.assert_close(tfm.fused_apply(tm, None, t(x)), got, rtol=0,
                             atol=0)
  with torch.no_grad():
    torch.testing.assert_close(tm(t(x)), got, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('case', ['trunk', 'act_sigmoid', 'act_softplus'])
def test_fused_mlp_plain_bf16_matches_pallas(case):
  jm, params, tm, x = mlp_case(**K3_CASES[case])
  want = np.asarray(jfm.fused_apply(jm, params, jnp.asarray(x), tile=128,
                                    compute_dtype=jnp.bfloat16,
                                    interpret=True))
  got = tfm.fused_apply(tm, params, t(x), compute_dtype=torch.bfloat16)
  assert got.dtype == torch.float32
  # Tolerance: bf16 keeps 8 significant bits. A sum that lies near a bf16
  # rounding boundary rounds the other way when XLA and torch sum in
  # another order, and XLA evaluates sigmoid and softplus in bf16 steps:
  # 2^-6 of each element and of the largest magnitude is 2 to 4 bf16 ulps.
  scale = np.abs(want).max()
  np.testing.assert_allclose(got.numpy(), want, rtol=2 ** -6,
                             atol=2 ** -6 * scale)
  # Rounded where JAX rounds: bf16 values, unlike the float32 result.
  assert torch.equal(got, got.to(torch.bfloat16).float())
  assert not torch.equal(got, tfm.fused_apply(tm, params, t(x)))


def test_fused_mlp_empty_input_and_checks():
  _, params, tm, _ = mlp_case(**K3_CASES['warp_like'])
  out = tfm.fused_apply(tm, params, torch.zeros(0, 52))
  assert tuple(out.shape) == (0, 3) and out.dtype == torch.float32
  x = torch.randn(5, 52)
  for act in ('elu', 'gelu', 'silu', 'sin'):
    other = MLP(52, 2, 16, (), act, 2)
    with pytest.raises(NotImplementedError):
      tfm.fused_apply(other, None, x)
  layers, has_out = tfm.mlp_params_to_layers(tm, None)
  with pytest.raises(ValueError, match='forward-only'):
    tfm.fused_mlp_forward(x.requires_grad_(), layers, tm.skips,
                          has_output_layer=has_out)
  with pytest.raises(ValueError):
    tfm.fused_mlp_forward(torch.randn(5, 51), layers, tm.skips,
                          has_output_layer=has_out)
  before = dict(kernels.launch_counts)
  with torch.no_grad():
    tfm.fused_mlp_forward(x, layers, tm.skips, has_output_layer=has_out)
  assert kernels.launch_counts == before  # the CPU path launches nothing
  # The CUDA kernel's limits are checked before a launch.
  wide = [(torch.zeros(52, 512), torch.zeros(512))]
  with pytest.raises(ValueError, match='256 output columns'):
    tfm._check_kernel_limits(x, wide)


def test_mlp_kernel_constants_match_the_cuda_source():
  """K3's limits and tile rows in the wrapper are those compiled into
  csrc/fused_mlp_fwd.cu and its engine; every width class's ring chunks
  fit a stage and divide every hidden width class (so a product reads no
  tile row that no layer wrote); whatever the input width (x streams
  through the input ring), a block of the 256-wide instantiation fits the
  H100's 232,448 bytes, and two blocks of the narrow one fit an SM's
  233,472 (1 KB of it reserved a block); each column count takes the
  narrowest class that holds it."""
  tile = cuda_constants('trunk_tile.cuh')
  k3 = cuda_constants('fused_mlp_fwd.cu')
  assert k3['MAXL'] == tfm.KERNEL_MAX_LAYERS
  assert k3['WMAX'] == tfm.KERNEL_MAX_COLS == max(tfm.KERNEL_WIDTHS)
  assert k3['WMAX'] == tile['WIDTH'] and k3['NARROW'] in tfm.KERNEL_WIDTHS
  assert k3['CIN_MAX'] == tfm.KERNEL_MAX_IN_DIM
  assert k3['HEADW'] == tfm.KERNEL_HEAD_WIDTH
  assert tile['TM'] == tfm.KERNEL_TILE_ROWS
  chunk, nt, tm = tile['KC'] * tile['WIDTH'], tile['NT'], tile['TM']
  for w in (*tfm.KERNEL_WIDTHS, tfm.KERNEL_HEAD_WIDTH):
    kc = min(k3['KCMAX'], chunk // w)
    kcx = min(kc, k3['KCX'])
    assert kc * w <= chunk and all(h % kc == 0 for h in tfm.KERNEL_WIDTHS)
    # The staging loops give each thread whole 16-byte pieces, or (a 16-wide
    # weight chunk of x's rows) fewer pieces than threads, which the loop
    # guards.
    for rows in (kc, kcx):
      pieces = rows * w // 4
      assert pieces % nt == 0 or (w == tfm.KERNEL_HEAD_WIDTH and pieces < nt)
    assert (tm * kcx // 4) % nt == 0
  lda = tm + 4
  rings = tile['STAGES'] * (chunk + tm * (k3['KCX'] + 4))
  wide = 4 * (tile['WIDTH'] * lda + rings)
  narrow = 4 * (k3['NARROW'] * lda + rings)
  assert (wide, narrow) == (146_432, 111_616)
  assert wide <= 232_448 and 2 * (narrow + 1024) <= 233_472
  for cols in range(1, tfm.KERNEL_MAX_COLS + 1):
    hidden = tfm.kernel_width(cols, last=False)
    assert hidden == min(w for w in tfm.KERNEL_WIDTHS if w >= cols)
    assert tfm.kernel_width(cols, last=True) == (
        tfm.KERNEL_HEAD_WIDTH if cols <= tfm.KERNEL_HEAD_WIDTH else hidden)


def test_composite_kernel_constants_match_the_cuda_source():
  """K2's rays a block and samples a pass in the wrapper are those
  compiled into csrc/composite.cu; it keeps nothing in shared memory, and
  its blocks spread a training batch (512 rays) and a render chunk (4096)
  over the H100's 132 SMs."""
  k2 = cuda_constants('composite.cu')
  assert k2['WARPS'] == tcomposite.KERNEL_RAYS_PER_BLOCK
  assert k2['LANES'] * k2['UNROLL'] == tcomposite.KERNEL_SAMPLE_CHUNK
  source = (pathlib.Path(tcomposite.__file__).parent / 'csrc' /
            'composite.cu').read_text()
  assert '__shared__' not in source
  for rays in (512, 4096):
    assert -(-rays // tcomposite.KERNEL_RAYS_PER_BLOCK) >= 0.95 * 132


# The kernel's activation codes back to names.
ACT_NAMES = {code: name for name, code in tfm.ACTIVATIONS.items()}


@pytest.mark.parametrize('case', list(K3_CASES))
def test_fused_mlp_kernel_operands_give_the_plain_result(case):
  """The kernel's arithmetic, emulated in torch on the operands the
  wrapper builds (each product reads the previous layer's true width of
  the padded activation, then x at a skip; bias; activation), gives the
  plain version's result: the padding, widths, skip offsets and activation
  codes handed to the kernel are right."""
  c = dict(K3_CASES[case])
  in_dim, n = c.pop('in_dim', 52), c.pop('n', 300)
  gen = torch.Generator().manual_seed(11)
  mlp = MLP(in_dim, c['depth'], c['width'], c['skips'],
            c.get('hidden_act', 'relu'), c['out_ch'], c['out_act'],
            generator=gen)
  with torch.no_grad():
    for name, p in mlp.named_parameters():
      if name.endswith('bias'):
        p.uniform_(-0.1, 0.1, generator=gen)
  x = torch.rand(n, in_dim, generator=gen) * 2 - 1
  layers, has_out = tfm.mlp_params_to_layers(mlp, None)
  ops = tfm.kernel_operands(layers, mlp.skips, mlp.hidden_activation,
                            mlp.output_activation, has_out, torch.float32)
  h, k = x, in_dim
  for i, (w, b, cols, width, skip, code) in enumerate(ops):
    assert width == tfm.kernel_width(cols, i == len(ops) - 1)
    assert w.shape[1] == b.shape[0] == width and w.is_contiguous()
    assert not w[:, cols:].any() and not b[cols:].any()
    acc = h[:, :k] @ w[:k]
    if skip:
      acc = acc + x @ w[k:]
    h, k = tfm.apply_activation(acc + b, ACT_NAMES[code]), cols
  want = tfm.fused_mlp_reference(x, layers, mlp.skips, mlp.hidden_activation,
                                 mlp.output_activation, has_out)
  # Tolerance: float32; a skip layer's two products are summed apart here.
  torch.testing.assert_close(h[:, :k], want, rtol=1e-5, atol=1e-5)
