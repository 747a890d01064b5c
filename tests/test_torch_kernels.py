"""The port's kernels: their plain PyTorch versions against the JAX
package's Pallas kernels (interpret mode on the CPU, as the JAX package's
own kernel tests run them), the backward's autograd Function, and the
wrappers' routing. The kernels themselves are held against their plain
versions on the card by ``tests/test_torch_cuda.py``.
"""
import functools
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


def rel_to_scale(got, want):
  """max |got - want| over max |want|."""
  want = np.asarray(want).reshape(got.shape)
  return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


# The bf16 plain versions round where the JAX kernel rounds and multiply
# the rounded values exactly in float32, as the JAX kernel's bf16 operands
# with float32 accumulation do; so they differ from it only by the order
# of float32 sums (measured: at most 1.4e-7 of the largest magnitude in
# the forward, 7.1e-7 in the backward). The float32 versions differ from
# the JAX bf16 kernel by 0.3% to 22% of it (g, 7% to 21% for feat̄ and the
# weight grads), which BF16_KERNEL_TOL rejects.
BF16_KERNEL_TOL = 1e-5


@pytest.mark.parametrize('norm_dim,has_bottleneck', [(3, True), (0, False)])
def test_fused_trunk_plain_bf16_matches_pallas(norm_dim, has_bottleneck):
  params, jspec, tm, tspec, feat = trunk_case(norm_dim=norm_dim,
                                              has_bottleneck=has_bottleneck)
  flat = jft.trunk_params_flat(jspec, params)
  f = jft.make_trunk_sigma_grad(jspec, tile=16, interpret=True,
                                compute_dtype=jnp.bfloat16)
  want = f(jnp.asarray(feat), *flat)
  cots = trunk_cotangents(tspec, len(feat), seed=5)
  want_x, want_w = jft._pallas_backward(
      jnp.asarray(feat), flat, tuple(map(jnp.asarray, cots)), jspec, 16,
      True, jnp.bfloat16)
  outs = {}
  with torch.no_grad():
    for cdt in (torch.bfloat16, None):
      fwd = tft.trunk_sigma_grad(t(feat), tm.trunk_weights(), tspec,
                                 compute_dtype=cdt)
      x, w = tft.trunk_sigma_grad_backward(
          t(feat), tm.trunk_weights(), tspec, to_port_cots(cots, tspec),
          compute_dtype=cdt)
      outs[cdt] = ([o for o in fwd if o is not None],
                   [x, *tft._flatten(w)])
  want_fwd = [w for w in want if w is not None]
  want_bwd = [want_x, *want_w]
  got_fwd, got_bwd = outs[torch.bfloat16]
  for i, (g, w) in enumerate(zip(got_fwd + got_bwd, want_fwd + want_bwd)):
    assert rel_to_scale(g, w) < BF16_KERNEL_TOL, i
  # The float32 versions fail that tolerance: g, feat̄ and every weight
  # kernel's grad (the bias grads sum unrounded cotangents in both modes).
  f32_fwd, f32_bwd = outs[None]
  assert rel_to_scale(f32_fwd[-1], want_fwd[-1]) > 1e-2
  kernels_of = lambda outs: [outs[0], *outs[1::2]]  # feat̄, then each dW
  for g, w in zip(kernels_of(f32_bwd), kernels_of(want_bwd)):
    assert rel_to_scale(g, w) > 1e-3


def emulate_trunk_kernels(feat, weights, spec, cots, compute_dtype):
  """K1f's outputs and K1b's feat̄, computed in torch from the operands the
  wrapper builds for the kernels, read as each engine reads them: the
  float32 engine multiplies by [in, out] weights, the bf16 tensor-core
  engine by [out, in] ones (the mma's B operand: out = A @ Bᵀ), with feat
  zero-padded to the 64 columns of its K. Checks the operands' shapes,
  dtypes and zero padding on the way."""
  bf16 = compute_dtype == torch.bfloat16
  wdt = torch.bfloat16 if bf16 else torch.float32
  rnd = lambda v: v.to(wdt).float()
  f = lambda w: w.float()
  layers, ptrs = tft._layer_operands(weights, spec, compute_dtype)
  head_w, head_b, bn_w, bn_b = tft._head_operands(weights, compute_dtype)
  bwd_head = tft._bwd_head_operands(weights, spec, compute_dtype)
  hc = spec.alpha_channels + spec.norm_dim
  narrow, max_head = tft.KERNEL_NARROW_WIDTH, tft.KERNEL_MAX_HEAD
  assert len(ptrs) == 5 * spec.depth
  for i, (wf_h, wf_x, wr_h, wr_x, b) in enumerate(layers):
    assert (wf_x is not None) == spec.is_skip(i)
    assert (wr_h is None) == (i == 0)
    assert (wr_x is None) == (i > 0 and not spec.is_skip(i))
    for op in (wf_h, wf_x, wr_h, wr_x):
      assert op is None or (op.dtype == wdt and op.is_contiguous())
    assert b.dtype == torch.float32
    if wr_x is not None:
      assert wr_x.shape == (spec.width, narrow)
      assert not wr_x[:, spec.in_dim:].any()
  for op in (head_w, bn_w, *bwd_head):
    assert op is None or (op.dtype == wdt and op.is_contiguous())
  if bf16:
    # Transposed for the tensor cores; the head's rows past hc are zero.
    assert head_w.shape == (max_head, spec.width)
    assert not head_w[hc:].any()
    head_seed, bn_seed = bwd_head
    assert head_seed.shape == (spec.width, max_head)
    assert not head_seed[:, hc:].any()
  else:
    assert head_w.shape == (spec.width, narrow)
    assert not head_w[:, hc:].any()
    _, head_seed, bn_seed = bwd_head
    assert head_seed.shape == (hc, spec.width)
  assert (bn_w is None) == (bn_seed is None) == (not spec.has_bottleneck)
  # x @ (the weight from feat): wr_x [out, 64] in bf16, as its transpose
  # [64, out] in float32 (wf_h[0] or wf_x, K = D).
  x = rnd(kernels.pad_columns(feat, narrow))
  from_x = lambda wf, wr: (x @ f(wr).T if bf16 else
                           x[:, :spec.in_dim] @ f(wf))
  # c @ (that weight)ᵀ, the reverse sweep's share of g or feat̄: wf_x (or
  # wf_h[0]) [D, out] in bf16, wr_x [out, 64] cut to D in float32.
  to_x = lambda c, wf, wr: (c @ f(wf).T if bf16 else
                            (c @ f(wr))[:, :spec.in_dim])
  # h @ W_h and r @ W_hᵀ of a layer > 0.
  fwd_h = lambda h, wf_h, wr_h: h @ (f(wr_h).T if bf16 else f(wf_h))
  rev_h = lambda c, wf_h, wr_h: c @ (f(wf_h).T if bf16 else f(wr_h))
  # Products with the head and the bottleneck as K1f reads them.
  out_of = lambda a, w: a @ (f(w).T if bf16 else f(w))
  h, pre = x, []
  for i, (wf_h, wf_x, wr_h, wr_x, b) in enumerate(layers):
    a = from_x(wf_h, wr_x) if i == 0 else fwd_h(h, wf_h, wr_h)
    if wf_x is not None:
      a = a + from_x(wf_x, wr_x)
    a = a + b
    pre.append(a)
    h_f32 = torch.relu(a)
    h = rnd(h_f32)
  head = out_of(h, head_w)[:, :hc] + head_b[:hc]
  bneck = out_of(h, bn_w) + bn_b if bn_w is not None else h_f32

  def sweep(r, masks):
    out = 0.0
    for i in range(spec.depth - 1, -1, -1):
      wf_h, wf_x, wr_h, wr_x, _ = layers[i]
      c = rnd(r * masks[i])
      if wr_x is not None:
        out = out + to_x(c, wf_h if i == 0 else wf_x, wr_x)
      if wr_h is not None:
        r = rev_h(c, wf_h, wr_h)
    return out

  seed = head_w[0] if bf16 else head_w[:, 0]
  g = sweep(f(seed).expand(len(feat), spec.width), [a > 0 for a in pre])
  fwd = (head[:, :1], head[:, 1:hc] if spec.norm_dim else None, h_f32,
         bneck, g)
  # K1b's feat̄: its masks test the stored h, its seed of r reads the head
  # and bottleneck through the backward's own operands.
  sbar, nbar, tbar, bbar, _ = cots
  head_bar = torch.cat([sbar, nbar], -1) if spec.norm_dim else sbar
  if bf16:
    r = tbar + rnd(kernels.pad_columns(head_bar, max_head)) @ f(head_seed).T
  else:
    r = tbar + head_bar @ f(head_seed)
  if bn_seed is not None:
    r = r + rnd(bbar) @ (f(bn_seed).T if bf16 else f(bn_seed))
  xbar = sweep(r, [rnd(torch.relu(a)) > 0 for a in pre])
  return fwd, xbar


@pytest.mark.parametrize('compute_dtype', [None, torch.bfloat16])
def test_fused_trunk_kernel_operands_give_the_plain_result(compute_dtype):
  """K1f's arithmetic and K1b's feat̄ sweep, emulated in torch on the
  operands the wrapper builds for the kernels (forward weights and their
  transposes, the reverse weights to feat and the heads padded, weights in
  the compute dtype and biases in float32; in bf16 each weight in the
  tensor cores' [out, in] layout and feat padded to K = 64), give the
  plain version's result at every head shape: the layouts, dtypes and
  paddings handed to the kernels are right."""
  for norm_dim, has_bottleneck in ((3, True), (0, True), (3, False)):
    _, _, tm, tspec, feat = trunk_case(n=29, norm_dim=norm_dim,
                                       has_bottleneck=has_bottleneck, seed=8)
    weights = tm.trunk_weights()
    cots = to_port_cots(trunk_cotangents(tspec, len(feat), seed=9), tspec)
    if not has_bottleneck:  # folded into T̄, as TrunkSigmaGrad does
      cots = (*cots[:2], cots[2] + cots[3], torch.zeros_like(cots[3]),
              cots[4])
    emulated, xbar = emulate_trunk_kernels(t(feat), weights, tspec, cots,
                                           compute_dtype)
    with torch.no_grad():
      want = tft.trunk_sigma_grad_reference(t(feat), weights, tspec,
                                            compute_dtype=compute_dtype)
      want_x, _ = tft.trunk_sigma_grad_backward_reference(
          t(feat), weights, tspec, cots, compute_dtype=compute_dtype)
    # Tolerance: float32; the emulation sums a skip layer's products and
    # the reverse products over transposed copies, in another order.
    for got, w in zip([*emulated, xbar], [*want, want_x]):
      if w is None:
        assert got is None
        continue
      torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-5)


def test_backward_scratch_sizes():
  """K1b's device scratch at depth 8, N = 65,536: 2,147 MB in float32;
  in bf16, h and τ (but τ_L) take half: 1,644 MB."""
  n, depth = 65_536, 8
  f32 = 4 * tft.backward_scratch_floats(n, depth)
  bf16 = 4 * tft.backward_scratch_floats(n, depth, torch.bfloat16)
  layer = n * tft.KERNEL_WIDTH
  assert f32 == 4 * 4 * depth * layer and round(f32 / 1e6) == 2147
  assert bf16 == (4 * (2 * depth + 1) + 2 * (2 * depth - 1)) * layer
  assert round(bf16 / 1e6) == 1644


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
  # The bf16 kernels' tensor-core engine, trunk_mma.cuh, at the same limits.
  mma = cuda_constants('trunk_mma.cuh')
  fwd16 = cuda_constants('fused_trunk_fwd_bf16.cu')
  bwd16 = cuda_constants('fused_trunk_bwd_bf16.cu')
  assert mma['TM'] == tft.KERNEL_TILE_ROWS
  assert mma['WIDTH'] == tft.KERNEL_WIDTH
  assert mma['DMAX'] == tft.KERNEL_MAX_IN_DIM
  assert mma['HCMAX'] == tft.KERNEL_MAX_HEAD
  assert mma['NW'] == tft.KERNEL_NARROW_WIDTH
  assert fwd16['MAXD'] == tft.KERNEL_MAX_DEPTH
  assert bwd16['MAXD'] == tft.KERNEL_BWD_MAX_DEPTH
  # The backward's row splits depend on N alone, and cover every row.
  for n in (1, 2047, 2048, 4099, 32_768, 65_536, 10**6):
    splits = tft.backward_splits(n)
    assert 1 <= splits <= tft.KERNEL_BWD_MAX_SPLITS
    assert splits * -(-n // splits) >= n


def test_bf16_trunk_kernels_shared_memory_fits():
  """The bf16 trunk kernels' tensor-core engine (trunk_mma.cuh): its tiles
  hold whole k16 steps, and a block's shared memory, computed from the
  sources' constants at the deepest trunk each kernel takes (resum's row
  maxima and lists included), fits the H100's 232,448 bytes (the weight
  grads: two blocks an SM)."""
  mma = cuda_constants('trunk_mma.cuh')
  bwd16 = cuda_constants('fused_trunk_bwd_bf16.cu')
  # An mma's K is 16: a wide chunk's k, the narrow input tile's columns
  # (feat padded to DMAX) and a narrow product's k (WIDTH) are multiples.
  for k in (mma['KC'], mma['DMAX'], mma['WIDTH'], bwd16['RB']):
    assert k % 16 == 0, k
  # Its layout in bf16 (2 bytes): [TM][WIDTH] activation tiles, [TM][DMAX]
  # narrow input tiles, STAGES ring chunks of [WIDTH][KC] (wide) or
  # [NW][WIDTH] (narrow), 2 KB of relu bits a layer.
  assert mma['TILE'] == mma['TM'] * mma['WIDTH']
  assert mma['XTILE'] == mma['TM'] * mma['DMAX']
  assert mma['STAGE'] == mma['WIDTH'] * mma['KC'] == mma['NW'] * mma['WIDTH']
  assert mma['MASK_BYTES'] == 8 * mma['NT']
  ring16 = 2 * mma['STAGES'] * mma['STAGE']
  fwd16_bytes = (2 * (mma['TILE'] + mma['XTILE']) + ring16
                 + mma['MASK_BYTES'] * tft.KERNEL_MAX_DEPTH)
  # The sweep: two activation tiles; feat, Ḡ and the head cotangent.
  bwd16_bytes = (2 * (2 * mma['TILE'] + 3 * mma['XTILE']) + ring16
                 + mma['MASK_BYTES'] * tft.KERNEL_BWD_MAX_DEPTH)
  # The weight grads: a ring of [RB][TK] bf16 A, A2 and [RB][TJ] f32 C,
  # C2; C and C2 in bf16; the sums of four row groups, two of them. Two
  # blocks an SM, of its 228 KB less 1 KB each.
  rb, tk, tj = bwd16['RB'], bwd16['TK'], bwd16['TJ']
  wgrad16_bytes = (bwd16['WSTAGES'] * (2 * 2 * rb * tk + 2 * 4 * rb * tj)
                   + 2 * 2 * rb * tj + 2 * 4 * 4 * tj)
  # resum (the sums near a rounding or a mask taken again in k order): each
  # tile's row maxima, four column groups' of TM rows (two tiles in K1f,
  # five in K1b's sweep), and each warp's list of SEQ_CAP entries and
  # results; the weight rows it sums with go to the ring, in eight warps'
  # parts that hold a round's rows at the widest (a trunk row, a feat row
  # and 16 bytes of padding each).
  assert mma['RM'] == 4 * mma['TM']
  lists = 8 * mma['SEQ_CAP'] * (4 + 4)
  fwd16_bytes += 2 * 4 * mma['RM'] + lists
  bwd16_bytes += 5 * 4 * mma['RM'] + lists
  slice16 = mma['STAGES'] * mma['STAGE'] // 8
  assert slice16 // (mma['WIDTH'] + mma['NW'] + 8) >= 16
  # resum's table of weight norms: three a layer (two more in K1b).
  assert mma['L1MAX'] >= max(3 * tft.KERNEL_MAX_DEPTH,
                             3 * tft.KERNEL_BWD_MAX_DEPTH + 2)
  assert (fwd16_bytes, bwd16_bytes, wgrad16_bytes) == (178_176, 222_208,
                                                       86_016)
  assert max(fwd16_bytes, bwd16_bytes) <= 232_448
  assert 2 * (wgrad16_bytes + 1024) <= 228 * 1024


def _near_decision(x, delta):
  """trunk_mma.cuh's near_decision: |x| <= delta, or |x| - delta and |x| +
  delta round to different bf16 values (bits + half a step, 16 dropped)."""
  ax = np.abs(x)
  lo = (ax - delta).astype(np.float32).view(np.uint32).astype(np.int64)
  hi = (ax + delta).astype(np.float32).view(np.uint32).astype(np.int64)
  return (ax <= delta) | (((lo + 0x8000) >> 16) != ((hi + 0x8000) >> 16))


def test_resum_rule_rounds_as_the_in_order_sum():
  """The bf16 kernels' rule for their rounding decisions (trunk_mma.cuh's
  resum), on the CPU: sums taken in another order (k16 partials, each
  truncated toward zero as a tensor core may, added in float32) and then
  summed again in k order wherever near_decision flags them within
  SEQ_WINDOW * 2^-24 * M (M: the row's largest |a| times the largest L1
  norm of the weight's columns, plus |bias|) make every relu mask and
  bf16 rounding fall as the in-order float32 sum (the plain version's on
  the card) makes it fall; without the second sums some fall otherwise."""
  window = cuda_constants('trunk_mma.cuh')['SEQ_WINDOW']
  rng = np.random.RandomState(0)
  bf = lambda t: torch.from_numpy(np.ascontiguousarray(t, np.float32)).to(
      torch.bfloat16).float().numpy()
  a = bf(np.maximum(rng.randn(256, 256), 0.0))  # relu'd activations
  w = bf(rng.randn(256, 256) / 16.0)
  b = rng.randn(256).astype(np.float32) * 0.1
  prod = a[:, :, None].astype(np.float32) * w[None, :, :]  # exact in f32
  in_order = np.zeros((256, 256), np.float32)
  for k in range(256):
    in_order = (in_order + prod[:, k, :]).astype(np.float32)
  in_order = (in_order + b).astype(np.float32)
  other = np.zeros((256, 256), np.float32)
  for k0 in range(0, 256, 16):
    part = prod[:, k0:k0 + 16, :].astype(np.float64).sum(1)
    near32 = part.astype(np.float32)
    part = np.where(np.abs(near32.astype(np.float64)) > np.abs(part),
                    np.nextafter(near32, np.float32(0)), near32)
    other = (other + part).astype(np.float32)
  other = (other + b).astype(np.float32)
  m = (np.abs(a).max(1, keepdims=True) * np.abs(w).sum(0).max()
       + np.abs(b).max()).astype(np.float32)
  delta = (m * np.float32(window * 2.0**-24)).astype(np.float32)
  decide = lambda v: (v > 0, bf(np.maximum(v, 0.0)))
  mask_want, h_want = decide(in_order)
  mask_tc, h_tc = decide(other)
  moved = (mask_tc != mask_want) | (h_tc != h_want)
  assert moved.sum() > 0
  near = (other > -delta) & _near_decision(other, delta)
  fixed = np.where(near, in_order, other)
  mask_got, h_got = decide(fixed)
  assert (mask_got == mask_want).all() and (h_got == h_want).all()
  # The window holds the two orders' difference with room to spare, and
  # flags few sums.
  assert np.abs(other - in_order).max() < delta.min()
  assert near.mean() < 0.05, near.mean()


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


@functools.lru_cache(maxsize=1)
def bf16_sum_order_case(n=4099, seed=9):
  """The nerf_ds trunk at full width, and K1f's outputs and K1b's feat̄ of
  its plain bf16 versions run in float32 (as a kernel would give them) and
  in float64 (as the plain version, rounded to float32): the same bf16
  roundings, another order of sums."""
  gen = torch.Generator().manual_seed(seed)
  tm = NerfMLP(52, 0, 0, True, trunk_depth=8, trunk_width=256, skips=(4,),
               predict_norm=True, generator=gen)
  spec = tft.TrunkSpec(depth=8, width=256, skips=(4,), in_dim=52,
                       alpha_channels=1, norm_dim=3, has_bottleneck=True)
  weights = tm.trunk_weights()
  feat = torch.rand(n, 52, generator=gen) * 2 - 1
  cots = tuple(torch.randn(n, c, generator=gen) for c in (1, 3, 256, 256, 52))
  f64 = lambda ts: tuple(t.double() if t is not None else None for t in ts)
  w64 = tft.TrunkWeights([f64(layer) for layer in weights.layers],
                         f64(weights.head), f64(weights.bottleneck))
  bf16 = torch.bfloat16
  with torch.no_grad():
    got = tft.trunk_sigma_grad_reference(feat, weights, spec, bf16)
    want = tuple(o.float() for o in tft.trunk_sigma_grad_reference(
        feat.double(), w64, spec, bf16))
    got_x = tft.trunk_sigma_grad_backward_reference(feat, weights, spec,
                                                    cots, bf16)[0]
    want_x = tft.trunk_sigma_grad_backward_reference(
        feat.double(), w64, spec, f64(cots), bf16)[0].float()
  return spec, weights, feat, cots, got, want, got_x, want_x


@pytest.mark.parametrize('case', ['sum_order', 'wrong_row', 'ragged_tail',
                                  'f32'])
def test_check_bf16_rows(case):
  """The card checks' bf16 rule. Another order of the float32 sums moves
  rows of K1f and K1b beyond the bf16 tolerance, and each is reproduced
  with the sites that lie at a rounding boundary or a kink moved; a row
  wrong otherwise, any row of the ragged last tile beyond tolerance, and
  the float32 version all fail the check."""
  spec, weights, feat, cots, got, want, got_x, want_x = bf16_sum_order_case()
  check = tft.check_bf16_rows
  with torch.no_grad():
    if case == 'sum_order':
      for name, g, w, c in (('K1f', got, want, None),
                            ('feat_bar', got_x, want_x, cots)):
        bad, rows, flips = check(feat, weights, spec, g, w, c, name=name)
        assert rows and rows == torch.nonzero(bad).flatten().tolist(), name
        assert all(1 <= len(f) <= 2 for f in flips), (name, flips)
      return
    if case == 'f32':
      f32 = tft.trunk_sigma_grad_reference(feat, weights, spec)
      with pytest.raises(AssertionError, match='rows of 4099 beyond'):
        check(feat, weights, spec, f32, want)
      return
    bad, _, _ = check(feat, weights, spec, got, want)
    row = (feat.shape[0] - 1 if case == 'ragged_tail'
           else int(torch.nonzero(~bad)[0]))
    wrong = list(got)
    wrong[4] = got[4].clone()
    wrong[4][row] += 0.1
    with pytest.raises(AssertionError, match=(
        'ragged last tile' if case == 'ragged_tail' else 'match no plain')):
      check(feat, weights, spec, wrong, want)


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
  # Two bias slots of the widest layer's columns.
  wide += 4 * 2 * tile['WIDTH']
  narrow += 4 * 2 * k3['NARROW']
  assert (wide, narrow) == (148_480, 112_640)
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


def routable_mlp(**overrides):
  """A stack that ``MLP.forward`` would send to K3 on a card: float32,
  3 hidden layers of 64 with a skip, an output layer of 2."""
  kw = dict(in_dim=45, depth=3, width=64, skips=(1,), hidden_activation='relu',
            output_channels=2, generator=torch.Generator().manual_seed(3))
  kw.update(overrides)
  return MLP(**kw)


# Each case changes one thing about a routable call (a stack of
# routable_mlp's, called under no_grad with float32 blocks) and names the
# reason MLP.k3_refusal gives for keeping the plain chain. On the CPU the
# unchanged call is refused for its device alone.
ROUTING_CASES = {
    'grad': (dict(), dict(grad=True), 'grad'),
    'cpu_tensors': (dict(), dict(), 'device'),
    'dtype_bf16': (dict(), dict(dtype=torch.bfloat16), 'dtype'),
    'storage_dtype_bf16': (dict(), dict(storage_dtype=torch.bfloat16),
                           'dtype'),
    'hidden_norm': (dict(hidden_norm='layer'), dict(), 'hidden_norm'),
    'depth0': (dict(depth=0, width=0, skips=()), dict(), 'depth'),
    'depth1': (dict(depth=1, skips=()), dict(), 'depth'),
    'elu': (dict(hidden_activation='elu'), dict(), 'activation'),
    'gelu_output': (dict(output_activation='gelu'), dict(), 'activation'),
    'too_wide': (dict(width=tfm.KERNEL_MAX_COLS + 1), dict(), 'limits'),
    'no_bias': (dict(use_bias=False), dict(), 'bias'),
    'float64_blocks': (dict(), dict(blocks_dtype=torch.float64), 'dtype'),
    'broadcast_blocks': (dict(), dict(lead=((7,), (1,))), 'shape'),
}


@pytest.mark.parametrize('case', list(ROUTING_CASES))
def test_mlp_forward_routing_rule(case):
  mlp_kw, call, reason = ROUTING_CASES[case]
  mlp = routable_mlp(**mlp_kw)
  dtype = call.get('blocks_dtype', torch.float32)
  lead = call.get('lead', ((7,), (7,)))
  blocks = [torch.rand(*lead[0], 40, dtype=dtype),
            torch.rand(*lead[1], 5, dtype=dtype)]
  with torch.set_grad_enabled(call.get('grad', False)):
    got = mlp.k3_refusal(blocks, call.get('dtype'), call.get('storage_dtype'))
  assert got == reason
  assert tfm.stack_refusal(mlp) == (
      reason if reason in ('depth', 'hidden_norm', 'activation', 'limits',
                           'bias') else None)


def test_mlp_forward_runs_k3_where_the_rule_admits_it(monkeypatch):
  """``MLP.forward`` hands an admitted call's blocks to
  ``fused_mlp.mlp_forward`` once and returns its result, and runs the plain
  chain for a refused one; ``mlp_forward`` is faked here (it launches the
  CUDA kernel), over the real operands and input rows."""
  mlp = routable_mlp()
  blocks = [torch.rand(3, 4, 40), torch.rand(3, 4, 5)]
  with torch.no_grad():
    want = mlp(blocks)
  calls = []

  def fake(m, inputs):
    calls.append(inputs)
    x, lead = tfm.input_rows(inputs)
    h, k = x[:, :m.in_dim], m.in_dim
    for w, b, cols, _, skip, code in tfm.mlp_operands(m):
      acc = h[:, :k] @ w[:k]
      if skip:
        acc = acc + x[:, :m.in_dim] @ w[k:]
      h, k = tfm.apply_activation(acc + b, ACT_NAMES[code]), cols
    return h[:, :k].reshape(*lead, k)

  monkeypatch.setattr(tfm, 'mlp_forward', fake)
  with torch.no_grad():
    assert mlp(blocks) is not None and not calls  # refused: CPU tensors
  monkeypatch.setattr(MLP, 'k3_refusal', lambda self, *a: None)
  with torch.no_grad():
    got = mlp(blocks)
  assert len(calls) == 1 and calls[0][0] is blocks[0]
  assert got.shape == want.shape == (3, 4, 2)
  # Tolerance: float32; the chain sums each block's product apart.
  torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_nerf_ds_stacks_that_reach_k3():
  """Of nerf_ds()'s MLPs the rule takes the NeRF trunk of each level, the
  SE(3) trunk, the hyper sheet and the mask MLP (8 launches a render
  chunk: the three fields run at both levels); the σ/normal heads and the
  rgb branches stay on the plain chain."""
  from nerfds_torch import config
  from nerfds_torch.models.nerfds import NerfDSModel
  model = NerfDSModel(config.nerf_ds(), num_warp_embeds=2,
                      num_hyper_embeds=2, device='cpu')
  reasons = {name: tfm.stack_refusal(m) for name, m in model.named_modules()
             if isinstance(m, MLP)}
  assert {n for n, r in reasons.items() if r is None} == {
      'warp_field.trunk', 'hyper_sheet.mlp', 'mask_mlp.mlp',
      'nerf.coarse.trunk', 'nerf.fine.trunk'}
  assert {n for n, r in reasons.items() if r is not None} == {
      f'nerf.{level}.{head}' for level in ('coarse', 'fine')
      for head in ('alpha', 'rgb')}
  assert set(reasons.values()) == {None, 'depth'}


# The layers of each nerf_ds() stack that reaches K3, each of which has its
# bias staged into shared memory ahead of its epilogue.
NERF_DS_PREFETCHED_LAYERS = {
    'nerf.coarse.trunk': 8, 'nerf.fine.trunk': 8, 'mask_mlp.mlp': 8 + 1,
    'warp_field.trunk': 6, 'hyper_sheet.mlp': 6 + 1,
}


def test_k3_prefetched_layers_of_nerf_ds_stacks():
  """The wrapper's count of each nerf_ds() stack that MLP.forward sends to
  K3, from the operands it hands the kernel; a render chunk (the NeRF
  trunk of each level, and the mask MLP, SE(3) trunk and hyper sheet at
  both levels) adds 60 to the counter."""
  from nerfds_torch import config
  from nerfds_torch.models.nerfds import NerfDSModel
  model = NerfDSModel(config.nerf_ds(), num_warp_embeds=2,
                      num_hyper_embeds=2, device='cpu')
  mlps = dict(model.named_modules())
  per_stack = {name: tfm.prefetched_layers(tfm.mlp_operands(mlps[name]))
               for name in NERF_DS_PREFETCHED_LAYERS}
  assert per_stack == NERF_DS_PREFETCHED_LAYERS
  per_chunk = (per_stack['nerf.coarse.trunk'] + per_stack['nerf.fine.trunk']
               + 2 * sum(per_stack[n] for n in ('mask_mlp.mlp',
                                                'warp_field.trunk',
                                                'hyper_sheet.mlp')))
  assert per_chunk == 60


# Stacks at K3's edges: one layer, the most layers K3 takes, skips at layer
# 0 and 1, a 1024-wide input, and a 16-wide head after 128; (MLP arguments,
# layers).
PREFETCHED_LAYER_CASES = {
    'one_layer': (dict(in_dim=256, depth=0, width=0, skips=(),
                       output_channels=4), 1),
    'max_layers': (dict(in_dim=45, depth=16, width=64, skips=(4,),
                        output_channels=16), tfm.KERNEL_MAX_LAYERS),
    'skip_0_and_2': (dict(in_dim=45, depth=3, width=40, skips=(0, 2),
                          output_channels=3), 4),
    'skip_1_wide_input': (dict(in_dim=1024, depth=2, width=256, skips=(1,),
                               output_channels=3), 3),
    'head_after_128': (dict(in_dim=33, depth=2, width=128, skips=(),
                            output_channels=2), 3),
}


@pytest.mark.parametrize('case', list(PREFETCHED_LAYER_CASES))
def test_k3_prefetched_layers_at_its_edges(case):
  kw, layers = PREFETCHED_LAYER_CASES[case]
  mlp = MLP(generator=torch.Generator().manual_seed(4), **kw)
  ops = tfm.mlp_operands(mlp)
  assert tfm.prefetched_layers(ops) == len(ops) == layers


def test_mlp_operands_are_kept_until_a_parameter_changes():
  mlp = routable_mlp()
  ops = tfm.mlp_operands(mlp)
  assert tfm.mlp_operands(mlp) is ops
  layers, has_out = tfm.mlp_params_to_layers(mlp, None)
  want = tfm.kernel_operands(layers, mlp.skips, mlp.hidden_activation,
                             mlp.output_activation, has_out, torch.float32)
  for got_op, want_op in zip(ops, want):
    assert torch.equal(got_op[0], want_op[0]) and got_op[2:] == want_op[2:]
  # Changed in place (an optimizer's step, a loaded state): rebuilt.
  with torch.no_grad():
    mlp.hidden(1).kernel.mul_(2)
  changed = tfm.mlp_operands(mlp)
  assert changed is not ops
  assert torch.equal(changed[1][0][:, :64], 2 * ops[1][0][:, :64])
  assert tfm.mlp_operands(mlp) is changed
  state = {k: v + 1 for k, v in mlp.state_dict().items()}
  mlp.load_state_dict(state)
  loaded = tfm.mlp_operands(mlp)
  assert loaded is not changed
  assert torch.equal(loaded[0][1][:64], state['hidden_0.bias'])
  # Swapped for other tensors (torch.func.functional_call): rebuilt, and
  # rebuilt again for the module's own parameters afterwards.
  other = {k: torch.zeros_like(v) for k, v in state.items()}

  class Operands(torch.nn.Module):
    def __init__(self, inner):
      super().__init__()
      self.inner = inner

    def forward(self):
      return tfm.mlp_operands(self.inner)

  swapped = torch.func.functional_call(
      Operands(mlp), {f'inner.{k}': v for k, v in other.items()}, ())
  assert not swapped[0][0].any()
  back = tfm.mlp_operands(mlp)
  assert back is not swapped
  assert torch.equal(back[0][1][:64], state['hidden_0.bias'])


@pytest.mark.parametrize('blocks', [
    [(7, 33)],                      # the SE(3) trunk's 33 channels, one block
    [(7, 40), (7, 5)],              # the hyper sheet's 45
    [(2, 7, 36), (2, 7, 8)],        # the mask MLP's 44, a leading batch
    [(0, 40), (0, 4)],              # no rows
])
def test_input_rows_write_the_blocks_once(blocks):
  gen = torch.Generator().manual_seed(5)
  parts = [torch.rand(*shape, generator=gen) for shape in blocks]
  x, lead = tfm.input_rows(parts)
  c_in = sum(p.shape[-1] for p in parts)
  assert lead == blocks[0][:-1] and x.is_contiguous()
  assert x.shape == (int(np.prod(lead)), -(-c_in // 4) * 4)
  assert torch.equal(x[:, :c_in], torch.cat(parts, -1).reshape(-1, c_in))
  assert not x[:, c_in:].any()


def test_input_rows_refuse_blocks_of_other_leading_shapes():
  with pytest.raises(ValueError, match='leading shapes'):
    tfm.input_rows([torch.rand(3, 4, 40), torch.rand(4, 5)])
