"""NeRF trunk forward with ∂σ/∂feat (K1f): CUDA kernel and its plain version.

Counterpart of the forward half of ``nerfds_tpu/pallas/fused_trunk.py``.
One call returns σ, the predicted normal, the trunk output, the bottleneck
and g = ∂σ/∂feat, so the per-point ∇σ is the feature path's pullback of g
(``models/nerfds.py``, ``sigma_gradient_mode='fused'``). The kernel is
``csrc/fused_trunk_fwd.cu``; ``trunk_sigma_grad_reference`` is the same
function in plain PyTorch: a forward that keeps the relu masks, then the
reverse sweep seeded with the σ column of the head. ``trunk_sigma_grad``
takes the plain version only for CPU tensors and the kernel for CUDA
tensors.

Forward only: no autograd rule is attached. The hand-derived backward
(the JAX package's ``_bwd_kernel``) comes with the training path.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from nerfds_torch import kernels
from nerfds_torch.kernels import build

# Limits compiled into csrc/fused_trunk_fwd.cu.
KERNEL_WIDTH = 256
KERNEL_MAX_IN_DIM = 64
KERNEL_MAX_DEPTH = 16
KERNEL_MAX_HEAD = 8


@dataclasses.dataclass(frozen=True)
class TrunkSpec:
  """Static shape of a relu NerfMLP trunk and its heads."""
  depth: int
  width: int
  skips: Tuple[int, ...]
  in_dim: int
  alpha_channels: int
  norm_dim: int
  has_bottleneck: bool

  def __post_init__(self):
    object.__setattr__(self, 'skips', tuple(sorted(self.skips)))

  def is_skip(self, i: int) -> bool:
    return i != 0 and i in self.skips


class TrunkWeights(NamedTuple):
  """``[in, out]`` kernels and biases, as the model stores them."""
  layers: Sequence[Tuple[torch.Tensor, torch.Tensor]]  # trunk hidden_i
  head: Tuple[torch.Tensor, torch.Tensor]              # alpha logit
  bottleneck: Optional[Tuple[torch.Tensor, torch.Tensor]]


Outputs = Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor,
                torch.Tensor, torch.Tensor]


def trunk_sigma_grad_reference(feat: torch.Tensor, weights: TrunkWeights,
                               spec: TrunkSpec) -> Outputs:
  """(feat [N, D]) -> (σ [N, 1], normal [N, norm_dim] or None,
  trunk_out [N, W], bottleneck [N, W], g = ∂σ/∂feat [N, D])."""
  h, masks = feat, []
  for i, (w, b) in enumerate(weights.layers):
    if spec.is_skip(i):
      a = h @ w[:spec.width] + feat @ w[spec.width:] + b
    else:
      a = h @ w + b
    masks.append(a > 0)
    h = torch.relu(a)
  head_w, head_b = weights.head
  head = h @ head_w + head_b
  sigma = head[:, :spec.alpha_channels]
  norm = (head[:, spec.alpha_channels:spec.alpha_channels + spec.norm_dim]
          if spec.norm_dim > 0 else None)
  if weights.bottleneck is not None:
    bneck = h @ weights.bottleneck[0] + weights.bottleneck[1]
  else:
    bneck = h.clone()
  # Reverse sweep: c_i = r_i * mask_i, r_{i-1} = c_i W_h,iᵀ, and g collects
  # c_i W_x,iᵀ at the input layer and at every skip layer.
  r = head_w[:, 0].expand(feat.shape[0], spec.width)
  g = None
  for i in range(spec.depth - 1, -1, -1):
    w = weights.layers[i][0]
    c = r * masks[i]
    if i == 0:
      gx = c @ w.T
    elif spec.is_skip(i):
      gx = c @ w[spec.width:].T
      r = c @ w[:spec.width].T
    else:
      gx = None
      r = c @ w.T
    if gx is not None:
      g = gx if g is None else g + gx
  return sigma, norm, h, bneck, g


def _check(feat: torch.Tensor, weights: TrunkWeights, spec: TrunkSpec):
  if feat.dim() != 2 or feat.shape[1] != spec.in_dim:
    raise ValueError(f'feat must be [N, {spec.in_dim}], got '
                     f'{tuple(feat.shape)}')
  if len(weights.layers) != spec.depth:
    raise ValueError(f'{len(weights.layers)} layers for depth {spec.depth}')
  for i, (w, b) in enumerate(weights.layers):
    rows = (spec.in_dim if i == 0 else spec.width) + (
        spec.in_dim if spec.is_skip(i) else 0)
    if tuple(w.shape) != (rows, spec.width) or tuple(b.shape) != (spec.width,):
      raise ValueError(f'layer {i}: kernel {tuple(w.shape)}, bias '
                       f'{tuple(b.shape)}; want ({rows}, {spec.width})')
  head_cols = spec.alpha_channels + spec.norm_dim
  if weights.head[0].shape[0] != spec.width or (
      weights.head[0].shape[1] < head_cols):
    raise ValueError(f'head kernel {tuple(weights.head[0].shape)}')
  if (weights.bottleneck is not None) != spec.has_bottleneck:
    raise ValueError('bottleneck weights do not match spec.has_bottleneck')
  tensors = [feat, *(t for layer in weights.layers for t in layer),
             *weights.head, *(weights.bottleneck or ())]
  for t in tensors:
    if t.dtype != torch.float32:
      raise TypeError(f'fused trunk takes float32, got {t.dtype}')
    if t.device != feat.device:
      raise ValueError(f'a weight is on {t.device}, feat on {feat.device}')


def _check_kernel_limits(spec: TrunkSpec, head_cols: int):
  if (spec.width != KERNEL_WIDTH or spec.in_dim > KERNEL_MAX_IN_DIM
      or not 1 <= spec.depth <= KERNEL_MAX_DEPTH
      or head_cols > KERNEL_MAX_HEAD or spec.alpha_channels != 1
      or 0 in spec.skips):
    raise ValueError(
        f'the CUDA trunk kernel takes width {KERNEL_WIDTH}, in_dim <= '
        f'{KERNEL_MAX_IN_DIM}, depth <= {KERNEL_MAX_DEPTH}, one σ channel, '
        f'<= {KERNEL_MAX_HEAD} head columns and no skip at layer 0; '
        f'got {spec}')


def _launch(feat: torch.Tensor, weights: TrunkWeights,
            spec: TrunkSpec) -> Outputs:
  """Runs ``csrc/fused_trunk_fwd.cu`` on the current stream."""
  head_w, head_b = (t.contiguous() for t in weights.head)
  hc = head_w.shape[1]
  _check_kernel_limits(spec, hc)
  n, d = feat.shape
  feat = feat.contiguous()
  # Per layer: forward weights [in, out] and their transposes [out, in], so
  # that both the forward and the reverse sweep read contiguous rows.
  keep, ptrs = [], []
  for i, (w, b) in enumerate(weights.layers):
    if spec.is_skip(i):
      wf_h, wf_x = w[:spec.width].contiguous(), w[spec.width:].contiguous()
    else:
      wf_h, wf_x = w.contiguous(), None
    # Reverse weights: to h for i > 0; to feat at layer 0 and the skips.
    wr_h = wf_h.T.contiguous() if i > 0 else None
    wr_x = wf_h if i == 0 else wf_x
    wr_x = wr_x.T.contiguous() if wr_x is not None else None
    layer = (wf_h, wf_x, wr_h, wr_x, b.contiguous())
    keep.extend(t for t in layer if t is not None)
    ptrs.extend(t.data_ptr() if t is not None else 0 for t in layer)
  bn = (tuple(t.contiguous() for t in weights.bottleneck)
        if weights.bottleneck is not None else (None, None))
  for t in (head_w, head_b, *bn):
    ptrs.append(t.data_ptr() if t is not None else 0)
    if t is not None:
      keep.append(t)
  for t in keep:
    if t.data_ptr() % 16:
      raise ValueError('fused trunk operands must be 16-byte aligned')

  new = lambda *shape: torch.empty(shape, device=feat.device,
                                   dtype=torch.float32)
  sigma, trunk, bneck, g = new(n, 1), new(n, spec.width), new(n, spec.width), \
      new(n, d)
  norm = new(n, spec.norm_dim) if spec.norm_dim > 0 else None
  if n == 0:
    return sigma, norm, trunk, bneck, g
  skip_bits = sum(1 << i for i in spec.skips)
  ptr_array = (ctypes.c_uint64 * len(ptrs))(*ptrs)
  lib = build.load_library()
  with torch.cuda.device(feat.device):
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    rc = lib.fused_trunk_fwd(
        feat.data_ptr(), ptr_array, n, d, spec.depth, skip_bits, hc,
        spec.norm_dim, int(spec.has_bottleneck), sigma.data_ptr(),
        norm.data_ptr() if norm is not None else 0, trunk.data_ptr(),
        bneck.data_ptr(), g.data_ptr(), stream)
  build.check(rc, 'fused_trunk_fwd')
  kernels.launch_counts['fused_trunk_fwd'] += 1
  return sigma, norm, trunk, bneck, g


def trunk_sigma_grad(feat: torch.Tensor, weights: TrunkWeights,
                     spec: TrunkSpec) -> Outputs:
  """The forward on feat's device: the kernel for CUDA tensors, the plain
  version for CPU tensors. See :func:`trunk_sigma_grad_reference`."""
  _check(feat, weights, spec)
  if feat.device.type == 'cuda':
    return _launch(feat, weights, spec)
  if feat.device.type == 'cpu':
    return trunk_sigma_grad_reference(feat, weights, spec)
  raise ValueError(f'no fused trunk path for device {feat.device}')
