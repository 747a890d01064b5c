"""NeRF trunk with ∂σ/∂feat: the forward (K1f) and its hand-derived
backward (K1b), CUDA kernels and their plain versions.

Counterpart of ``nerfds_tpu/pallas/fused_trunk.py``. One forward call
returns σ, the predicted normal, the trunk output, the bottleneck and
g = ∂σ/∂feat, so the per-point ∇σ is the feature path's pullback of g
(``models/nerfds.py``, ``sigma_gradient_mode='fused'``).

* K1f, ``csrc/fused_trunk_fwd.cu``; plain version
  ``trunk_sigma_grad_reference``: a forward that keeps the relu masks, then
  the reverse sweep seeded with the σ column of the head.
* K1b, ``csrc/fused_trunk_bwd.cu``; plain version
  ``trunk_sigma_grad_backward_reference``: given the cotangents
  (σ̄, n̄, T̄, B̄, Ḡ) it returns feat̄ and every weight and bias grad,
  including the second-order terms of Ḡ·g. Because relu'' = 0 a.e., g is
  bilinear in the weights for a fixed mask pattern: with τ the forward
  tangent sweep seeded with Ḡ at every input injection and c_g the
  w_σ-seeded reverse sweep, ∂(Ḡ·g)/∂W_i = τ_{i-1}ᵀ c_g,i,
  ∂(Ḡ·g)/∂w_σ = Σ_rows τ_L and ∂(Ḡ·g)/∂feat = 0.

``trunk_sigma_grad`` is differentiable through ``TrunkSigmaGrad``, whose
forward is K1f and backward K1b. Both take the plain versions only for CPU
tensors and the kernels for CUDA tensors. The Function needs no double
backward: g is an output of its forward, and the outer backward reaches
the small MLPs' second-order terms through autograd of the feature path.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from nerfds_torch import kernels
from nerfds_torch.kernels import build

# Limits compiled into csrc/trunk_tile.cuh, csrc/fused_trunk_fwd.cu and
# csrc/fused_trunk_bwd.cu (tests/test_torch_kernels.py reads them there).
KERNEL_TILE_ROWS = 64      # rows a block of either kernel owns (TM)
KERNEL_WIDTH = 256
KERNEL_MAX_IN_DIM = 64
KERNEL_MAX_HEAD = 8
# Columns of a narrow weight (the reverse weights to feat, the forward's
# head), zero-padded by the wrapper (NW).
KERNEL_NARROW_WIDTH = 64
KERNEL_MAX_DEPTH = 16
# The backward passes its table of grads as one kernel parameter, which
# bounds its depth.
KERNEL_BWD_MAX_DEPTH = 12
# Rows of the weight-grad reduction's fixed split (csrc/fused_trunk_bwd.cu).
KERNEL_BWD_SPLIT_ROWS = 2048
KERNEL_BWD_MAX_SPLITS = 32


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
# (σ̄ [N, 1], n̄ [N, norm_dim] or None, T̄ [N, W], B̄ [N, W], Ḡ [N, D]).
Cotangents = Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor,
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


def trunk_sigma_grad_backward_reference(
    feat: torch.Tensor, weights: TrunkWeights, spec: TrunkSpec,
    cots: Cotangents) -> Tuple[torch.Tensor, TrunkWeights]:
  """(feat̄ [N, D], grads shaped as ``weights``) of the forward's outputs
  against the cotangents ``cots``, with the sweeps of the JAX package's
  ``_bwd_kernel``. ``B̄`` reaches the bottleneck only: a caller without one
  folds ``B̄`` into ``T̄`` first (``TrunkSigmaGrad`` does).
  """
  sbar, nbar, tbar, bbar, gbar = cots
  w_of = lambda i: weights.layers[i][0]
  # Forward recompute; zin_i is layer i's input (h_{i-1}, or feat at 0).
  hs, masks = [], []
  h = feat
  for i, (w, b) in enumerate(weights.layers):
    if spec.is_skip(i):
      a = h @ w[:spec.width] + feat @ w[spec.width:] + b
    else:
      a = h @ w + b
    masks.append((a > 0).to(feat.dtype))
    h = torch.relu(a)
    hs.append(h)
  h_last = hs[-1]
  # Tangent sweep seeded with Ḡ at every input injection.
  taus, tau = [], None
  for i in range(spec.depth):
    w = w_of(i)
    if i == 0:
      tau = gbar @ w
    elif spec.is_skip(i):
      tau = tau @ w[:spec.width] + gbar @ w[spec.width:]
    else:
      tau = tau @ w
    tau = tau * masks[i]
    taus.append(tau)
  # Head: the cotangent of [σ, normal], the reverse seed r, head grads.
  head_w, _ = weights.head
  n_used = spec.alpha_channels + spec.norm_dim
  head_bar = torch.cat([sbar, nbar], -1) if spec.norm_dim > 0 else sbar
  r = tbar + head_bar @ head_w[:, :n_used].T
  bn_grads = None
  if weights.bottleneck is not None:
    r = r + bbar @ weights.bottleneck[0].T
    bn_grads = (h_last.T @ bbar, bbar.sum(0))
  head_dw = torch.zeros_like(head_w)
  head_dw[:, :n_used] = h_last.T @ head_bar
  head_dw[:, 0] += taus[-1].sum(0)  # ∂(Ḡ·g)/∂w_σ
  head_db = torch.zeros_like(weights.head[1])
  head_db[:n_used] = head_bar.sum(0)
  # The first-order sweep r and the w_σ-seeded g-path sweep r_g, together.
  r_g = head_w[:, 0].expand(feat.shape[0], spec.width)
  layer_grads = [None] * spec.depth
  xbar = torch.zeros_like(feat)
  for i in range(spec.depth - 1, -1, -1):
    w = w_of(i)
    c1, cg = r * masks[i], r_g * masks[i]
    zin = feat if i == 0 else hs[i - 1]
    tin = gbar if i == 0 else taus[i - 1]
    dw = zin.T @ c1 + tin.T @ cg
    if spec.is_skip(i):
      dw = torch.cat([dw, feat.T @ c1 + gbar.T @ cg], 0)
    layer_grads[i] = (dw, c1.sum(0))
    if i == 0:
      xbar = xbar + c1 @ w.T
    else:
      if spec.is_skip(i):
        xbar = xbar + c1 @ w[spec.width:].T
      r, r_g = c1 @ w[:spec.width].T, cg @ w[:spec.width].T
  return xbar, TrunkWeights(layers=layer_grads, head=(head_dw, head_db),
                            bottleneck=bn_grads)


def kink_flip(feat: torch.Tensor, cots: Cotangents, weights: TrunkWeights,
              spec: TrunkSpec, got_x: torch.Tensor) -> Optional[float]:
  """Explains the backward's feat̄ ``got_x`` [1, D] of the one-row ``feat``
  and ``cots`` as the exact (float64) result with every relu mask as it
  falls, or with one mask flipped at a unit whose pre-activation lies
  within 1e-4 of 0 (the 16 nearest), where float32 rounding may put it on
  the other side. Returns |a| of the flipped unit (0.0 for none), or None
  when no such result matches within atol 1e-4 + rtol 1e-4.

  feat̄ depends on the forward values only through the masks, so a mask is
  flipped by moving that unit's bias by -2a."""
  f64 = lambda ts: tuple(t.double() if t is not None else None for t in ts)
  w64 = TrunkWeights(
      layers=[f64(layer) for layer in weights.layers],
      head=f64(weights.head),
      bottleneck=(f64(weights.bottleneck) if weights.bottleneck is not None
                  else None))
  x, c64, got = feat.double(), f64(cots), got_x.double()
  pre, h = [], x
  for i, (w, b) in enumerate(w64.layers):
    a = (h @ w[:spec.width] + x @ w[spec.width:] + b if spec.is_skip(i)
         else h @ w + b)
    pre.append(a[0])
    h = torch.relu(a)
  near = sorted((abs(a[u].item()), i, u) for i, a in enumerate(pre)
                for u in torch.nonzero(a.abs() < 1e-4).flatten().tolist())
  for size, i, u in [(0.0, None, None), *near[:16]]:
    layers = list(w64.layers)
    if i is not None:
      w, b = layers[i]
      b = b.clone()
      b[u] -= 2 * pre[i][u]
      layers[i] = (w, b)
    want = trunk_sigma_grad_backward_reference(
        x, w64._replace(layers=layers), spec, c64)[0]
    if bool(((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all()):
      return size
  return None


def check_kink_rows(feat: torch.Tensor, weights: TrunkWeights,
                    spec: TrunkSpec, cots: Cotangents, got_x: torch.Tensor,
                    want_x: torch.Tensor):
  """The relu-kink rule of the backward's checks on the card.

  A row whose pre-activation lies within rounding of 0 may take the other
  side of a relu kink in the kernel's recompute than in cuBLAS, which moves
  that row's feat̄ and its share of every grad sum. Every row of the
  kernel's ``got_x`` beyond atol 1e-4 + rtol 1e-4 of the plain version's
  ``want_x`` must be proven by :func:`kink_flip`, and such rows may be at
  most 1e-3 of N. Raises AssertionError otherwise. Returns (those rows as a
  bool mask [N], their indices, |a| of the unit flipped at each); with
  their cotangents zeroed they add nothing to any output.
  """
  bad = ((got_x - want_x).abs() > 1e-4 + 1e-4 * want_x.abs()).any(-1)
  rows = torch.nonzero(bad).flatten().tolist()
  flips = [kink_flip(feat[r:r + 1],
                     tuple(c[r:r + 1] if c is not None else None
                           for c in cots), weights, spec, got_x[r:r + 1])
           for r in rows]
  if None in flips:
    raise AssertionError(
        f'feat_bar: rows {[r for r, f in zip(rows, flips) if f is None]} '
        'match no result with at most one relu flipped near a kink')
  if len(rows) > 1e-3 * feat.shape[0]:
    raise AssertionError(f'feat_bar: {len(rows)} rows of {feat.shape[0]} '
                         f'beyond tolerance: {rows[:12]}')
  return bad, rows, flips


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


def _layer_operands(weights: TrunkWeights, spec: TrunkSpec):
  """(tensors to keep alive, five pointers per trunk layer).

  Per layer: forward weights [in, out] and their transposes [out, in], so
  that both the forward and the reverse sweeps read contiguous rows. The
  reverse weights to feat are zero-padded to ``KERNEL_NARROW_WIDTH``
  columns. Both kernels take the same operands: ``TrunkSigmaGrad`` makes
  them once for a forward and its backward.
  """
  keep, ptrs = [], []
  for i, (w, b) in enumerate(weights.layers):
    if spec.is_skip(i):
      wf_h, wf_x = w[:spec.width].contiguous(), w[spec.width:].contiguous()
    else:
      wf_h, wf_x = w.contiguous(), None
    # Reverse weights: to h for i > 0; to feat at layer 0 and the skips.
    wr_h = wf_h.T.contiguous() if i > 0 else None
    wr_x = wf_h if i == 0 else wf_x
    wr_x = _pad_columns(wr_x.T, KERNEL_NARROW_WIDTH) if wr_x is not None \
        else None
    layer = (wf_h, wf_x, wr_h, wr_x, b.contiguous())
    keep.extend(t for t in layer if t is not None)
    ptrs.extend(t.data_ptr() if t is not None else 0 for t in layer)
  return keep, ptrs


def _pad_columns(x: torch.Tensor, cols: int) -> torch.Tensor:
  """A contiguous copy of the 2-D ``x`` with zero columns up to ``cols``."""
  out = x.new_zeros(x.shape[0], cols)
  out[:, :x.shape[1]] = x
  return out


def _check_aligned(tensors):
  for t in tensors:
    if t is not None and t.data_ptr() % 16:
      raise ValueError('fused trunk operands must be 16-byte aligned')


def _stream(device):
  return torch.cuda.current_stream(device).cuda_stream


def _launch(feat: torch.Tensor, weights: TrunkWeights, spec: TrunkSpec,
            operands=None) -> Outputs:
  """Runs ``csrc/fused_trunk_fwd.cu`` on the current stream; ``operands``
  are ``_layer_operands(weights, spec)``, made here when None."""
  head_w, head_b = (t.contiguous() for t in weights.head)
  hc = head_w.shape[1]
  _check_kernel_limits(spec, hc)
  n, d = feat.shape
  feat = feat.contiguous()
  keep, ptrs = operands or _layer_operands(weights, spec)
  ptrs = list(ptrs)
  bn = (tuple(t.contiguous() for t in weights.bottleneck)
        if weights.bottleneck is not None else (None, None))
  head_w = _pad_columns(head_w, KERNEL_NARROW_WIDTH)
  for t in (head_w, head_b, *bn):
    ptrs.append(t.data_ptr() if t is not None else 0)
  _check_aligned([*keep, head_w, head_b, *bn])

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
    rc = lib.fused_trunk_fwd(
        feat.data_ptr(), ptr_array, n, d, spec.depth, skip_bits, hc,
        spec.norm_dim, int(spec.has_bottleneck), sigma.data_ptr(),
        norm.data_ptr() if norm is not None else 0, trunk.data_ptr(),
        bneck.data_ptr(), g.data_ptr(), _stream(feat.device))
  build.check(rc, 'fused_trunk_fwd')
  kernels.launch_counts['fused_trunk_fwd'] += 1
  return sigma, norm, trunk, bneck, g


def backward_splits(n: int) -> int:
  """Row splits of the backward's weight-grad reduction: a function of N
  alone, so that two launches on the same inputs sum in the same order."""
  return max(1, min(KERNEL_BWD_MAX_SPLITS,
                    -(-n // KERNEL_BWD_SPLIT_ROWS)))


def _launch_backward(feat: torch.Tensor, weights: TrunkWeights,
                     spec: TrunkSpec, cots: Cotangents, operands=None
                     ) -> Tuple[torch.Tensor, TrunkWeights]:
  """Runs ``csrc/fused_trunk_bwd.cu`` on the current stream: the sweeps,
  then the weight-grad reduction in a fixed order. ``operands`` as for
  ``_launch``."""
  head_w = weights.head[0].contiguous()
  hc = head_w.shape[1]
  _check_kernel_limits(spec, hc)
  if spec.depth > KERNEL_BWD_MAX_DEPTH:
    raise ValueError(f'the CUDA trunk backward takes depth <= '
                     f'{KERNEL_BWD_MAX_DEPTH}, got {spec.depth}')
  n, d = feat.shape
  hcu = spec.alpha_channels + spec.norm_dim
  sbar, nbar, tbar, bbar, gbar = cots
  dev = feat.device
  tbar = tbar.contiguous()
  # The kernel's 16-byte copies need rows of a multiple of 4 floats: feat
  # and Ḡ padded to D rounded up to 4, the head cotangent to 8 columns.
  ldx = -(-d // 4) * 4
  feat_k, gbar_k = ((_pad_columns(x, ldx) if ldx != d else x.contiguous())
                    for x in (feat, gbar))
  head_cot = _pad_columns(torch.cat([sbar, nbar], -1) if spec.norm_dim > 0
                          else sbar, KERNEL_MAX_HEAD)
  bbar = bbar.contiguous() if spec.has_bottleneck else None
  keep, ptrs = operands or _layer_operands(weights, spec)
  ptrs = list(ptrs)
  # Transposed head (its used columns) and bottleneck for the seed of r.
  wa_t = head_w[:, :hcu].T.contiguous()
  wb_t = (weights.bottleneck[0].T.contiguous() if spec.has_bottleneck
          else None)
  for t in (head_w, wa_t, wb_t):
    ptrs.append(t.data_ptr() if t is not None else 0)
  _check_aligned([*keep, head_w, wa_t, wb_t, feat_k, head_cot, tbar, bbar,
                  gbar_k])

  zeros = lambda t: torch.zeros_like(t, memory_format=torch.contiguous_format)
  grads = TrunkWeights(
      layers=[(zeros(w), zeros(b)) for w, b in weights.layers],
      head=(zeros(weights.head[0]), zeros(weights.head[1])),
      bottleneck=(tuple(zeros(t) for t in weights.bottleneck)
                  if spec.has_bottleneck else None))
  xbar = torch.empty(n, d, device=dev, dtype=torch.float32)
  if n == 0:
    return xbar, grads
  gptrs = []
  for dw, db in (*grads.layers, grads.bottleneck or (None, None), grads.head):
    gptrs.extend(t.data_ptr() if t is not None else 0 for t in (dw, db))
  # One partial sum per split for every grad element that the kernel
  # computes (the head's used columns only).
  per_split = sum(w.numel() + b.numel() for w, b in weights.layers)
  if spec.has_bottleneck:
    per_split += sum(t.numel() for t in weights.bottleneck)
  per_split += (spec.width + 1) * hcu
  splits = backward_splits(n)
  # e0: the unit column that adds Σ_rows τ_L into the σ column of the head.
  e0 = torch.zeros(n, KERNEL_MAX_HEAD, device=dev, dtype=torch.float32)
  e0[:, 0] = 1.0
  # Device-memory scratch of the sweeps: h_i, τ_i, c1_i and c_g,i for every
  # layer, 4·depth·N·W float32 (2.1 GB at depth 8, N = 65,536).
  scratch = torch.empty(4 * spec.depth * n * spec.width, device=dev,
                        dtype=torch.float32)
  partials = torch.empty(splits * per_split, device=dev,
                         dtype=torch.float32)
  skip_bits = sum(1 << i for i in spec.skips)
  wptr_array = (ctypes.c_uint64 * len(ptrs))(*ptrs)
  gptr_array = (ctypes.c_uint64 * len(gptrs))(*gptrs)
  lib = build.load_library()
  with torch.cuda.device(dev):
    rc = lib.fused_trunk_bwd(
        feat_k.data_ptr(), head_cot.data_ptr(), tbar.data_ptr(),
        bbar.data_ptr() if bbar is not None else 0, gbar_k.data_ptr(),
        wptr_array, gptr_array, e0.data_ptr(), n, d, spec.depth, skip_bits,
        hc, hcu, int(spec.has_bottleneck), splits, per_split,
        xbar.data_ptr(), scratch.data_ptr(), partials.data_ptr(),
        _stream(dev))
  build.check(rc, 'fused_trunk_bwd')
  kernels.launch_counts['fused_trunk_bwd'] += 1
  return xbar, grads


def _dispatch(feat, kernel, plain, *args, operands=None):
  if feat.device.type == 'cuda':
    return kernel(feat, *args, operands=operands)
  if feat.device.type == 'cpu':
    return plain(feat, *args)
  raise ValueError(f'no fused trunk path for device {feat.device}')


def trunk_sigma_grad_forward(feat: torch.Tensor, weights: TrunkWeights,
                             spec: TrunkSpec, operands=None) -> Outputs:
  """The forward on feat's device, without autograd: the kernel for CUDA
  tensors, the plain version for CPU tensors. ``operands``: the kernel's
  weight operands, made once by a caller that also runs the backward on
  the same weights (``TrunkSigmaGrad``); made here when None."""
  _check(feat, weights, spec)
  return _dispatch(feat, _launch, trunk_sigma_grad_reference, weights, spec,
                   operands=operands)


def trunk_sigma_grad_backward(feat: torch.Tensor, weights: TrunkWeights,
                              spec: TrunkSpec, cots: Cotangents,
                              operands=None
                              ) -> Tuple[torch.Tensor, TrunkWeights]:
  """The backward on feat's device: the kernel for CUDA tensors, the plain
  version for CPU tensors. See :func:`trunk_sigma_grad_backward_reference`;
  ``operands`` as for :func:`trunk_sigma_grad_forward`.
  """
  _check(feat, weights, spec)
  cols = {'σ̄': spec.alpha_channels, 'n̄': spec.norm_dim, 'T̄': spec.width,
          'B̄': spec.width, 'Ḡ': spec.in_dim}
  for (name, c), t in zip(cols.items(), cots):
    if name == 'n̄' and spec.norm_dim == 0:
      continue
    if (tuple(t.shape) != (feat.shape[0], c) or t.dtype != torch.float32
        or t.device != feat.device):
      raise ValueError(f'{name}: {tuple(t.shape)} {t.dtype} on {t.device}; '
                       f'want ({feat.shape[0]}, {c}) float32')
  return _dispatch(feat, _launch_backward,
                   trunk_sigma_grad_backward_reference, weights, spec, cots,
                   operands=operands)


def _flatten(weights: TrunkWeights):
  """Trunk layers, then the bottleneck, then the head: (kernel, bias) each."""
  pairs = [*weights.layers, *([weights.bottleneck] if weights.bottleneck
                              is not None else []), weights.head]
  return [t for pair in pairs for t in pair]


def _unflatten(flat, spec: TrunkSpec) -> TrunkWeights:
  pairs = [tuple(flat[i:i + 2]) for i in range(0, len(flat), 2)]
  return TrunkWeights(layers=pairs[:spec.depth], head=pairs[-1],
                      bottleneck=pairs[spec.depth] if spec.has_bottleneck
                      else None)


class TrunkSigmaGrad(torch.autograd.Function):
  """The trunk with ∂σ/∂feat under autograd: forward K1f, backward K1b."""

  @staticmethod
  def forward(ctx, feat, spec, *flat):
    ctx.spec = spec
    ctx.save_for_backward(feat, *flat)
    weights = _unflatten(flat, spec)
    # The kernels' transposed and padded weights, made once for K1f and K1b.
    ctx.operands = None
    if feat.device.type == 'cuda':
      _check(feat, weights, spec)
      _check_kernel_limits(spec, weights.head[0].shape[1])
      ctx.operands = _layer_operands(weights, spec)
    return trunk_sigma_grad_forward(feat, weights, spec, ctx.operands)

  @staticmethod
  @torch.autograd.function.once_differentiable
  def backward(ctx, sbar, nbar, tbar, bbar, gbar):
    feat, *flat = ctx.saved_tensors
    spec = ctx.spec
    zeros = lambda c: torch.zeros(feat.shape[0], c, device=feat.device,
                                  dtype=feat.dtype)
    sbar = zeros(spec.alpha_channels) if sbar is None else sbar
    nbar = (None if spec.norm_dim == 0 else
            zeros(spec.norm_dim) if nbar is None else nbar)
    tbar = zeros(spec.width) if tbar is None else tbar
    bbar = zeros(spec.width) if bbar is None else bbar
    gbar = zeros(spec.in_dim) if gbar is None else gbar
    if not spec.has_bottleneck:
      # The bottleneck output is the trunk output: fold its cotangent in.
      tbar, bbar = tbar + bbar, torch.zeros_like(bbar)
    xbar, grads = trunk_sigma_grad_backward(
        feat, _unflatten(flat, spec), spec, (sbar, nbar, tbar, bbar, gbar),
        ctx.operands)
    return (xbar, None, *_flatten(grads))


def trunk_sigma_grad(feat: torch.Tensor, weights: TrunkWeights,
                     spec: TrunkSpec) -> Outputs:
  """(σ, normal, trunk_out, bottleneck, g) on feat's device, differentiable
  in feat and every weight (:class:`TrunkSigmaGrad`). See
  :func:`trunk_sigma_grad_reference` for the outputs."""
  return TrunkSigmaGrad.apply(feat, spec, *_flatten(weights))
