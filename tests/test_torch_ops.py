"""L0 ops of the PyTorch port against the JAX package, on the same inputs.

Inputs come from numpy seeds and go to both sides; float32 on both. Unless
a test says otherwise the tolerance is atol/rtol 1e-6 to 1e-5: the two
frameworks round the same float32 formulas in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfds_tpu.ops import math as jmath
from nerfds_tpu.ops import rendering as jrendering
from nerfds_tpu.ops import rigid as jrigid
from nerfds_tpu.ops import sampling as jsampling
from nerfds_torch.ops import math as tmath
from nerfds_torch.ops import rendering as trendering
from nerfds_torch.ops import rigid as trigid
from nerfds_torch.ops import sampling as tsampling

torch.set_num_threads(1)


def t(x):
  return torch.from_numpy(np.array(x))


def close(got, want, atol=1e-6, rtol=1e-5):
  np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                             rtol=rtol)


@pytest.mark.parametrize('min_deg,max_deg,identity,alpha', [
    (0, 8, False, None), (0, 4, True, None), (0, 6, False, 2.5),
    (2, 2, True, None), (0, 1, False, 0.3)])
def test_posenc(min_deg, max_deg, identity, alpha):
  x = np.random.RandomState(0).randn(7, 3).astype(np.float32)
  want = jmath.posenc(jnp.asarray(x), min_deg, max_deg, identity, alpha)
  got = tmath.posenc(t(x), min_deg, max_deg, identity, alpha)
  assert got.shape[-1] == tmath.posenc_dim(3, min_deg, max_deg, identity)
  # atol 1e-5: sin of arguments up to 2^7 * |x| loses float32 digits.
  close(got, want, atol=1e-5)


def test_posenc_window():
  for alpha in (0.0, 0.5, 3.2, 8.0):
    close(tmath.posenc_window(0, 8, alpha), jmath.posenc_window(0, 8, alpha))


def test_normalize_and_safe_norm_values_and_grads():
  rng = np.random.RandomState(1)
  x = rng.randn(9, 3).astype(np.float32)
  x[0] = 0.0          # exactly zero: both zero the gradient
  x[1] = 1e-12        # below tol: gradient zeroed
  close(tmath.normalize(t(x)), jmath.normalize(jnp.asarray(x)))
  w = rng.randn(9).astype(np.float32)
  want_val = jmath.safe_norm(jnp.asarray(x))
  want_grad = jax.grad(lambda v: jnp.sum(jnp.asarray(w) * jmath.safe_norm(v))
                       )(jnp.asarray(x))
  xt = t(x).requires_grad_()
  got_val = tmath.safe_norm(xt)
  (got_grad,) = torch.autograd.grad((t(w) * got_val).sum(), xt)
  close(got_val.detach(), want_val)
  close(got_grad, want_grad)
  keep = tmath.safe_norm(t(x), keepdims=True)
  assert keep.shape == (9, 1)


@pytest.mark.parametrize('keepdims', [False, True])
def test_safe_norm_second_derivative_matches_jax(keepdims):
  """The double backward keeps the ∂‖x‖/∂x term at both keepdims values
  (JAX's custom_jvp differentiates its own rule at every order)."""
  x = np.random.RandomState(4).randn(7, 3).astype(np.float32)

  def jax_outer(v):
    g = jax.grad(lambda u: jnp.sum(jmath.safe_norm(u, keepdims=keepdims)))(v)
    return jnp.sum(g ** 2) + jnp.sum(g[:, 0])

  want = jax.grad(jax_outer)(jnp.asarray(x))
  xt = t(x).requires_grad_()
  (g,) = torch.autograd.grad(tmath.safe_norm(xt, keepdims=keepdims).sum(),
                             xt, create_graph=True)
  (got,) = torch.autograd.grad((g ** 2).sum() + g[:, 0].sum(), xt)
  close(got, want, atol=1e-5)


def _screw_inputs(seed=2, n=11):
  rng = np.random.RandomState(seed)
  w_raw = rng.randn(n, 3).astype(np.float32) * 0.7
  v_raw = rng.randn(n, 3).astype(np.float32)
  x = rng.randn(n, 3).astype(np.float32)
  return w_raw, v_raw, x


def test_screw_functions():
  w_raw, v_raw, x = _screw_inputs()
  js = jrigid.screw_from_raw(jnp.asarray(w_raw), jnp.asarray(v_raw))
  ts = trigid.screw_from_raw(t(w_raw), t(v_raw))
  for a, b in zip(ts, js):
    close(a, b)
  close(ts.axis, js.axis)
  xj = jnp.asarray(x)
  close(trigid.rotate(ts, t(x)), jrigid.rotate(js, xj), atol=1e-5)
  close(trigid.rotate_inverse(ts, t(x)), jrigid.rotate_inverse(js, xj),
        atol=1e-5)
  close(trigid.translation(ts), jrigid.translation(js), atol=1e-5)
  close(trigid.transform_point(ts, t(x)), jrigid.transform_point(js, xj),
        atol=1e-5)
  # Rotating back undoes the rotation.
  close(trigid.rotate_inverse(ts, trigid.rotate(ts, t(x))), x, atol=1e-5)


def test_screw_zero_row_and_gradients():
  """θ = ‖w_raw‖: an exact-zero row gives the identity in both packages,
  but the gradient of the norm there differs (torch 0, JAX NaN), so the
  gradients are compared on nonzero rows only and the model's parity tests
  check that their toy widths emit no zero row."""
  w_raw, v_raw, x = _screw_inputs(n=5)
  w_raw[0] = 0.0
  js = jrigid.screw_from_raw(jnp.asarray(w_raw), jnp.asarray(v_raw))
  ts = trigid.screw_from_raw(t(w_raw), t(v_raw))
  close(ts.theta, js.theta)
  close(trigid.transform_point(ts, t(x))[0], x[0])
  close(jrigid.transform_point(js, jnp.asarray(x))[0], x[0])

  w_nz = w_raw[1:]

  def jloss(w):
    s = jrigid.screw_from_raw(w, jnp.asarray(v_raw[1:]))
    return jnp.sum(jrigid.transform_point(s, jnp.asarray(x[1:])) ** 2)

  want = jax.grad(jloss)(jnp.asarray(w_nz))
  wt = t(w_nz).requires_grad_()
  s = trigid.screw_from_raw(wt, t(v_raw[1:]))
  (got,) = torch.autograd.grad(
      (trigid.transform_point(s, t(x[1:])) ** 2).sum(), wt)
  close(got, want, atol=1e-5, rtol=1e-4)


def test_sample_along_rays_with_injected_uniforms():
  rng = np.random.RandomState(3)
  origins = rng.randn(5, 3).astype(np.float32)
  dirs = rng.randn(5, 3).astype(np.float32)
  key = jax.random.PRNGKey(4)
  for stratified in (True, False):
    for disparity in (False, True):
      jz, jp = jsampling.sample_along_rays(
          key, jnp.asarray(origins), jnp.asarray(dirs), 7, 0.2, 2.0,
          stratified, disparity)
      # The JAX function draws exactly this; hand the same to the port.
      u = t(jax.random.uniform(key, [5, 7]))
      tz, tp = tsampling.sample_along_rays(
          t(origins), t(dirs), 7, 0.2, 2.0, stratified, disparity,
          uniforms=u if stratified else None)
      close(tz, jz)
      close(tp, jp, atol=1e-5)


def test_sample_along_rays_generator_is_deterministic():
  o, d = torch.zeros(4, 3), torch.ones(4, 3)
  z1, _ = tsampling.sample_along_rays(o, d, 8, 0.2, 2.0, True, False,
                                      torch.Generator().manual_seed(5))
  z2, _ = tsampling.sample_along_rays(o, d, 8, 0.2, 2.0, True, False,
                                      torch.Generator().manual_seed(5))
  assert torch.equal(z1, z2)
  assert bool((z1[:, 1:] >= z1[:, :-1]).all())


@pytest.mark.parametrize('stratified', [True, False])
def test_sample_pdf_with_injected_uniforms(stratified):
  rng = np.random.RandomState(6)
  num_rays, num_bins, num_samples = 6, 9, 5
  bins = np.sort(rng.rand(num_rays, num_bins + 1).astype(np.float32) * 2,
                 -1)
  weights = rng.rand(num_rays, num_bins).astype(np.float32)
  weights[0] = 0.0  # an empty ray: the +eps keeps its pdf uniform
  origins = rng.randn(num_rays, 3).astype(np.float32)
  dirs = rng.randn(num_rays, 3).astype(np.float32)
  z_vals = np.sort(rng.rand(num_rays, 4).astype(np.float32) * 2, -1)
  key = jax.random.PRNGKey(7)
  jz, jp = jsampling.sample_pdf(
      key, jnp.asarray(bins), jnp.asarray(weights), jnp.asarray(origins),
      jnp.asarray(dirs), jnp.asarray(z_vals), num_samples, stratified)
  u = t(jax.random.uniform(key, [num_rays, num_samples]))
  tz, tp = tsampling.sample_pdf(
      t(bins), t(weights), t(origins), t(dirs), t(z_vals), num_samples,
      stratified, uniforms=u if stratified else None)
  close(tz, jz, atol=1e-6)
  close(tp, jp, atol=1e-5)


def _render_inputs(num_rays=10, num_samples=12, seed=8):
  rng = np.random.RandomState(seed)
  rgb = rng.rand(num_rays, num_samples, 3).astype(np.float32)
  sigma = (rng.rand(num_rays, num_samples) * 3).astype(np.float32)
  z = np.sort(rng.rand(num_rays, num_samples).astype(np.float32) * 3 + 1, -1)
  dirs = rng.randn(num_rays, 3).astype(np.float32)
  return rgb, sigma, z, dirs


@pytest.mark.parametrize('at_inf,white,sharp', [
    (True, False, False), (False, True, False), (True, True, True)])
def test_volumetric_rendering(at_inf, white, sharp):
  rgb, sigma, z, dirs = _render_inputs()
  want = jrendering.volumetric_rendering(
      *map(jnp.asarray, (rgb, sigma, z, dirs)), white, at_inf,
      use_sharp_weights=sharp, sharp_weights_std=0.5)
  got = trendering.volumetric_rendering(
      *map(t, (rgb, sigma, z, dirs)), white, at_inf,
      use_sharp_weights=sharp, sharp_weights_std=0.5)
  assert set(got) == set(want)
  for k in want:
    close(got[k], want[k], atol=1e-5, rtol=1e-4)


def test_alpha_weights_sharpen_and_depth():
  rgb, sigma, z, dirs = _render_inputs(seed=9)
  for scale in (1.0, 5.0):
    want = jrendering.compute_alpha_and_weights(
        jnp.asarray(sigma), jnp.asarray(z), jnp.asarray(dirs), scale=scale)
    got = trendering.compute_alpha_and_weights(t(sigma), t(z), t(dirs),
                                               scale=scale)
    for a, b in zip(got, want):
      close(a, b, atol=1e-6, rtol=1e-4)
  w = np.asarray(want[1])
  w_zero = w.copy()
  w_zero[0] = 0.0  # all-zero row: sharpened weights are 0, not NaN
  for std in (0.01, 0.3):
    close(trendering.sharpen_weights(t(w_zero), t(z), std),
          jrendering.sharpen_weights(jnp.asarray(w_zero), jnp.asarray(z),
                                     std), atol=1e-6, rtol=1e-4)
  close(trendering.compute_depth_map(t(w), t(z)),
        jrendering.compute_depth_map(jnp.asarray(w), jnp.asarray(z)))
  np.testing.assert_array_equal(
      trendering.compute_depth_index(t(w)).numpy(),
      np.asarray(jrendering.compute_depth_index(jnp.asarray(w))))
  close(trendering.cal_weights(t(sigma), t(z), t(dirs), False),
        jrendering.cal_weights(jnp.asarray(sigma), jnp.asarray(z),
                               jnp.asarray(dirs), False), rtol=1e-4)


def test_noise_regularize_sigma():
  sigma = torch.rand(4, 6)
  assert trendering.noise_regularize_sigma(sigma, None, True) is sigma
  assert trendering.noise_regularize_sigma(sigma, 1.0, False) is sigma
  a = trendering.noise_regularize_sigma(sigma, 0.5, True,
                                        torch.Generator().manual_seed(0))
  b = trendering.noise_regularize_sigma(sigma, 0.5, True,
                                        torch.Generator().manual_seed(0))
  assert torch.equal(a, b) and not torch.equal(a, sigma)
