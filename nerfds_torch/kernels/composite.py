"""Volume-compositing forward (K2): CUDA kernel, its plain version and the
autograd wrapper.

Counterpart of ``nerfds_tpu/pallas/composite.py``. The kernel is
``csrc/composite.cu``; ``composite_reference`` is the same function in plain
PyTorch. ``composite_forward`` takes the plain version only for CPU tensors
and the kernel for CUDA tensors. ``composite`` is differentiable: its
backward is autograd of the plain version, as the JAX package's custom VJP
is XLA autodiff of its reference.
"""
from __future__ import annotations

from typing import Tuple

import torch

from nerfds_torch import kernels
from nerfds_torch.kernels import build

Outputs = Tuple[torch.Tensor, ...]

# The kernel's geometry (csrc/composite.cu): one warp a ray, this many rays
# a block, and the samples a warp loads before it uses any (32 lanes x
# UNROLL chunks).
KERNEL_RAYS_PER_BLOCK = 4
KERNEL_SAMPLE_CHUNK = 128


def composite_reference(rgb, sigma, z_vals, dirs, sample_at_infinity=True,
                        eps: float = 1e-10) -> Outputs:
  """(rgb[R,S,3], σ[R,S], z[R,S], dirs[R,3]) ->
  (rgb[R,3], depth[R], acc_all[R], weights[R,S], alpha[R,S], accum[R,S]).

  ``acc_all`` sums all weights; the caller drops the last sample for
  sample-at-infinity, as ``ops.rendering.volumetric_rendering`` does.
  """
  last_sample_z = 1e10 if sample_at_infinity else 1e-19
  dists = torch.cat([
      z_vals[..., 1:] - z_vals[..., :-1],
      torch.full_like(z_vals[..., :1], last_sample_z),
  ], -1)
  dists = dists * torch.linalg.vector_norm(dirs[..., None, :], dim=-1)
  alpha = 1.0 - torch.exp(-sigma * dists)
  accum = torch.cat([
      torch.ones_like(alpha[..., :1]),
      torch.cumprod(1.0 - alpha[..., :-1] + eps, dim=-1),
  ], -1)
  weights = alpha * accum
  out_rgb = (weights[..., None] * rgb).sum(-2)
  depth = (weights * z_vals).sum(-1)
  acc = weights.sum(-1)
  return out_rgb, depth, acc, weights, alpha, accum


def _check_inputs(rgb, sigma, z_vals, dirs):
  if sigma.dim() != 2:
    raise ValueError(f'sigma must be [R, S], got {tuple(sigma.shape)}')
  r, s = sigma.shape
  want = {'rgb': (r, s, 3), 'z_vals': (r, s), 'dirs': (r, 3)}
  for name, t in (('rgb', rgb), ('z_vals', z_vals), ('dirs', dirs)):
    if tuple(t.shape) != want[name]:
      raise ValueError(f'{name} must be {want[name]}, got {tuple(t.shape)}')
  for name, t in (('rgb', rgb), ('sigma', sigma), ('z_vals', z_vals),
                  ('dirs', dirs)):
    if t.dtype != torch.float32:
      raise TypeError(f'{name} must be float32, got {t.dtype}')
    if t.device != sigma.device:
      raise ValueError(f'{name} is on {t.device}, sigma on {sigma.device}')


def _launch(rgb, sigma, z_vals, dirs, sample_at_infinity, eps) -> Outputs:
  """Runs ``csrc/composite.cu`` on the current stream."""
  r, s = sigma.shape
  if not s:
    raise ValueError('composite needs at least one sample per ray')
  rgb, sigma, z_vals, dirs = (t.contiguous()
                              for t in (rgb, sigma, z_vals, dirs))
  new = lambda *shape: torch.empty(shape, device=sigma.device,
                                   dtype=torch.float32)
  outs = (new(r, 3), new(r), new(r), new(r, s), new(r, s), new(r, s))
  if r == 0:
    return outs
  lib = build.load_library()
  with torch.cuda.device(sigma.device):
    stream = torch.cuda.current_stream(sigma.device).cuda_stream
    rc = lib.composite_fwd(
        rgb.data_ptr(), sigma.data_ptr(), z_vals.data_ptr(), dirs.data_ptr(),
        *(o.data_ptr() for o in outs), r, s, int(bool(sample_at_infinity)),
        float(eps), stream)
  build.check(rc, 'composite_fwd')
  kernels.launch_counts['composite_fwd'] += 1
  return outs


def composite_forward(rgb, sigma, z_vals, dirs, sample_at_infinity=True,
                      eps: float = 1e-10) -> Outputs:
  """The forward on the inputs' device: the kernel for CUDA tensors, the
  plain version for CPU tensors."""
  _check_inputs(rgb, sigma, z_vals, dirs)
  if sigma.device.type == 'cuda':
    return _launch(rgb, sigma, z_vals, dirs, sample_at_infinity, eps)
  if sigma.device.type == 'cpu':
    return composite_reference(rgb, sigma, z_vals, dirs, sample_at_infinity,
                               eps)
  raise ValueError(f'no compositing path for device {sigma.device}')


class _Composite(torch.autograd.Function):

  @staticmethod
  def forward(ctx, rgb, sigma, z_vals, dirs, sample_at_infinity, eps):
    ctx.save_for_backward(rgb, sigma, z_vals, dirs)
    ctx.sample_at_infinity, ctx.eps = sample_at_infinity, eps
    return composite_forward(rgb, sigma, z_vals, dirs, sample_at_infinity,
                             eps)

  @staticmethod
  def backward(ctx, *grads):
    inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
    with torch.enable_grad():
      outs = composite_reference(*inputs, ctx.sample_at_infinity, ctx.eps)
    pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
    in_grads = torch.autograd.grad([o for o, _ in pairs],
                                   inputs, [g for _, g in pairs],
                                   allow_unused=True)
    return (*in_grads, None, None)


def composite(rgb, sigma, z_vals, dirs, sample_at_infinity=True,
              eps: float = 1e-10) -> Outputs:
  """Differentiable compositing; see :func:`composite_reference` for the
  outputs."""
  return _Composite.apply(rgb, sigma, z_vals, dirs, sample_at_infinity, eps)
