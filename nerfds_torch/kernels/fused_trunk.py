"""NeRF trunk with ∂σ/∂feat: the forward (K1f) and its hand-derived
backward (K1b), CUDA kernels and their plain versions.

Counterpart of ``nerfds_tpu/pallas/fused_trunk.py``. One forward call
returns σ, the predicted normal, the trunk output, the bottleneck and
g = ∂σ/∂feat, so the per-point ∇σ is the feature path's pullback of g
(``models/nerfds.py``, ``sigma_gradient_mode='fused'``).

* K1f, ``csrc/fused_trunk_fwd.cu`` (``csrc/fused_trunk_fwd_bf16.cu`` in
  bf16); plain version ``trunk_sigma_grad_reference``: a forward that keeps
  the relu masks, then the reverse sweep seeded with the σ column of the
  head.
* K1b, ``csrc/fused_trunk_bwd.cu`` (``csrc/fused_trunk_bwd_bf16.cu`` in
  bf16); plain version
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

``compute_dtype`` (None or ``torch.float32``; ``torch.bfloat16``) is the
JAX kernel's operand dtype. In bf16 every product takes bf16 operands with
float32 accumulation, and values are rounded to bf16 exactly where the
JAX kernel casts to its compute dtype: the weights (biases stay f32, and
the reverse sweeps' seed is the rounded w_σ), feat and Ḡ, each layer's
relu output h, the masks' and h's scratch (the backward's masks test the
rounded h), the tangent sweep τ as it is stored and re-read, and every
cotangent where it enters a product (c, c₁, c_g, the head cotangent, B̄).
Sums the JAX kernel takes in f32 stay f32 (the bias grads; the σ column's
Σ τ_L), and so do the outputs: trunk_out is the last layer's unrounded h.
Inputs and outputs are float32 in both modes. The float32 kernels run on
the CUDA cores (``csrc/trunk_tile.cuh``), the bf16 ones on the tensor cores
(``csrc/trunk_mma.cuh``), which take every weight as the B operand of the
product, transposed: [out, in].
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from nerfds_torch import kernels
from nerfds_torch.kernels import build

# Limits compiled into csrc/trunk_tile.cuh, csrc/trunk_mma.cuh and the
# trunk kernels beside them (tests/test_torch_kernels.py reads them there).
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


def _rounder(compute_dtype):
  """x -> x rounded through ``compute_dtype`` and back to x's dtype (the
  identity for float32)."""
  if compute_dtype in (None, torch.float32):
    return lambda x: x
  if compute_dtype == torch.bfloat16:
    return lambda x: x.to(torch.bfloat16).to(x.dtype)
  raise ValueError(f'compute_dtype must be float32 or bfloat16, got '
                   f'{compute_dtype}')


def _rounded_weights(weights: TrunkWeights, rnd) -> TrunkWeights:
  """The kernels rounded to the compute dtype; biases as they are."""
  pair = lambda wb: (rnd(wb[0]), wb[1])
  return TrunkWeights(
      layers=[pair(layer) for layer in weights.layers],
      head=pair(weights.head),
      bottleneck=(pair(weights.bottleneck) if weights.bottleneck is not None
                  else None))


def trunk_sigma_grad_reference(feat: torch.Tensor, weights: TrunkWeights,
                               spec: TrunkSpec,
                               compute_dtype=None) -> Outputs:
  """(feat [N, D]) -> (σ [N, 1], normal [N, norm_dim] or None,
  trunk_out [N, W], bottleneck [N, W], g = ∂σ/∂feat [N, D]), with the
  operands of every product in ``compute_dtype`` (module docstring)."""
  rnd = _rounder(compute_dtype)
  weights = _rounded_weights(weights, rnd)
  x = rnd(feat)
  h, masks = x, []
  for i, (w, b) in enumerate(weights.layers):
    if spec.is_skip(i):
      a = h @ w[:spec.width] + x @ w[spec.width:] + b
    else:
      a = h @ w + b
    masks.append(a > 0)
    h_f32 = torch.relu(a)
    h = rnd(h_f32)
  head_w, head_b = weights.head
  head = h @ head_w + head_b
  sigma = head[:, :spec.alpha_channels]
  norm = (head[:, spec.alpha_channels:spec.alpha_channels + spec.norm_dim]
          if spec.norm_dim > 0 else None)
  if weights.bottleneck is not None:
    bneck = h @ weights.bottleneck[0] + weights.bottleneck[1]
  else:
    bneck = h_f32.clone()
  # Reverse sweep: c_i = r_i * mask_i, r_{i-1} = c_i W_h,iᵀ, and g collects
  # c_i W_x,iᵀ at the input layer and at every skip layer.
  r = head_w[:, 0].expand(feat.shape[0], spec.width)
  g = None
  for i in range(spec.depth - 1, -1, -1):
    w = weights.layers[i][0]
    c = rnd(r * masks[i])
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
  return sigma, norm, h_f32, bneck, g


def trunk_sigma_grad_backward_reference(
    feat: torch.Tensor, weights: TrunkWeights, spec: TrunkSpec,
    cots: Cotangents, compute_dtype=None
) -> Tuple[torch.Tensor, TrunkWeights]:
  """(feat̄ [N, D], grads shaped as ``weights``) of the forward's outputs
  against the cotangents ``cots``, with the sweeps of the JAX package's
  ``_bwd_kernel`` and its roundings in ``compute_dtype`` (module
  docstring). ``B̄`` reaches the bottleneck only: a caller without one
  folds ``B̄`` into ``T̄`` first (``TrunkSigmaGrad`` does).
  """
  rnd = _rounder(compute_dtype)
  sbar, nbar, tbar, bbar, gbar = cots
  head_w = weights.head[0]
  weights = _rounded_weights(weights, rnd)
  w_of = lambda i: weights.layers[i][0]
  x, gb = rnd(feat), rnd(gbar)
  # Forward recompute; zin_i is layer i's input (h_{i-1}, or feat at 0),
  # as stored (rounded); the masks test the stored h.
  hs, masks = [], []
  h = x
  for i, (w, b) in enumerate(weights.layers):
    if spec.is_skip(i):
      a = h @ w[:spec.width] + x @ w[spec.width:] + b
    else:
      a = h @ w + b
    h = rnd(torch.relu(a))
    masks.append((h > 0).to(feat.dtype))
    hs.append(h)
  h_last = hs[-1]
  # Tangent sweep seeded with Ḡ at every input injection; τ is stored
  # rounded, τ_L also kept as computed for its f32 sum.
  taus, tau = [], None
  for i in range(spec.depth):
    w = w_of(i)
    if i == 0:
      tau = gb @ w
    elif spec.is_skip(i):
      tau = taus[-1] @ w[:spec.width] + gb @ w[spec.width:]
    else:
      tau = taus[-1] @ w
    tau = tau * masks[i]
    taus.append(rnd(tau))
  # Head: the cotangent of [σ, normal], the reverse seed r, head grads.
  head_wr = weights.head[0]
  n_used = spec.alpha_channels + spec.norm_dim
  head_bar = torch.cat([sbar, nbar], -1) if spec.norm_dim > 0 else sbar
  r = tbar + rnd(head_bar) @ head_wr[:, :n_used].T
  bn_grads = None
  if weights.bottleneck is not None:
    r = r + rnd(bbar) @ weights.bottleneck[0].T
    bn_grads = (h_last.T @ rnd(bbar), bbar.sum(0))
  head_dw = torch.zeros_like(head_w)
  head_dw[:, :n_used] = h_last.T @ rnd(head_bar)
  head_dw[:, 0] += tau.sum(0)  # ∂(Ḡ·g)/∂w_σ, from the unrounded τ_L
  head_db = torch.zeros_like(weights.head[1])
  head_db[:n_used] = head_bar.sum(0)
  # The first-order sweep r and the w_σ-seeded g-path sweep r_g, together.
  r_g = head_wr[:, 0].expand(feat.shape[0], spec.width)
  layer_grads = [None] * spec.depth
  xbar = torch.zeros_like(feat)
  for i in range(spec.depth - 1, -1, -1):
    w = w_of(i)
    c1 = r * masks[i]
    c1r, cgr = rnd(c1), rnd(r_g * masks[i])
    zin = x if i == 0 else hs[i - 1]
    tin = gb if i == 0 else taus[i - 1]
    dw = zin.T @ c1r + tin.T @ cgr
    if spec.is_skip(i):
      dw = torch.cat([dw, x.T @ c1r + gb.T @ cgr], 0)
    layer_grads[i] = (dw, c1.sum(0))
    if i == 0:
      xbar = xbar + c1r @ w.T
    else:
      if spec.is_skip(i):
        xbar = xbar + c1r @ w[spec.width:].T
      r, r_g = c1r @ w[:spec.width].T, cgr @ w[:spec.width].T
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


# What one row may take the other way in a bf16 run: a relu mask, a
# rounding of the forward's h, a rounding of the reverse sweep's c.
_MASK, _H, _C = 1, 2, 3
_FLIP_KINDS = {_MASK: 'mask', _H: 'h', _C: 'c'}
# bf16_flips' search: steps, candidate sites a step, follow-on sites a
# candidate, and rows a float64 sweep at most; check_bf16_rows' share of
# rows that may lie beyond the bf16 tolerance.
_FLIP_STEPS, _FLIP_TRIES, _FLIP_PAIRS, _SWEEP_ROWS = 4, 32, 10, 8192
_BF16_MAX_ROW_FRAC = 0.02


def _other_bf16(v: torch.Tensor) -> torch.Tensor:
  """The bf16 neighbour of v's nearest bf16 value on v's side: v rounded
  the other way (float64 in, float64 out; v itself where it is 0 or a bf16
  value)."""
  q = v.to(torch.bfloat16)
  step = torch.where(v.abs() > q.double().abs(), 1, -1).to(torch.int16)
  other = (q.view(torch.int16) + step).view(torch.bfloat16).double()
  return torch.where((v == q.double()) | (q == 0), v, other)


def _midpoint_distance(v: torch.Tensor) -> torch.Tensor:
  """|v - the midpoint between its two bf16 roundings| (float64; inf where
  v is 0 or a bf16 value, which no sum order rounds otherwise)."""
  other = _other_bf16(v)
  return torch.where(other == v, torch.inf,
                     (v - (v.to(torch.bfloat16).double() + other) / 2).abs())


def _bf16_sweep64(x, weights, spec, r0, kind, layer, unit, near=0,
                  forward=False):
  """The plain bf16 version of the reverse sweep that gives K1f's g (seed
  r0 = w_σ) and K1b's feat̄ (seed: the heads' cotangents), in float64 on
  the rows of ``x`` [C, D] (feat, rounded to bf16) from ``r0`` (the seed
  [C, W] and the magnitude of the sum that made it [C, W]), each row with
  its own sites moved: in slot s, row k takes its relu mask (``kind[k, s]``
  ``_MASK``) or its rounding of h (``_H``) or of c (``_C``) at
  ``layer[k, s]``, ``unit[k, s]`` the other way. Returns (the output
  [C, D], followed with ``forward`` by the forward's σ, normal, trunk and
  bottleneck outputs in K1f's order; and for each row the ``near`` sites
  nearest to where they would flip, as (distance, kind, layer, unit),
  nearest first, the distance relative to the magnitude of the sum that
  makes the site, those within 2^-14 only)."""
  rnd = lambda t: t.to(torch.bfloat16).double()
  rows = torch.arange(x.shape[0], device=x.device)
  dists, where = [], []

  def add_sites(k, i, d):
    if near:
      dists.append(d)
      where.append((k, i))

  def moved(i, k):
    for s in range(kind.shape[1]):
      f = (layer[:, s] == i) & (kind[:, s] == k)
      yield rows[f], unit[f, s]

  h, masks = x, []
  for i, (w, b) in enumerate(weights.layers):
    if spec.is_skip(i):
      a = h @ w[:spec.width] + x @ w[spec.width:] + b
      mag = h.abs() @ w[:spec.width].abs() + x.abs() @ w[spec.width:].abs()
    else:
      a, mag = h @ w + b, h.abs() @ w.abs()
    mag = (mag + b.abs()).clamp_min(1e-300)
    add_sites(_MASK, i, a.abs() / mag)
    for k, u in moved(i, _MASK):
      a[k, u] *= -1
    masks.append(a > 0)
    hf = torch.relu(a)
    h = rnd(hf)
    for k, u in moved(i, _H):
      h[k, u] = _other_bf16(hf[k, u])
    add_sites(_H, i, torch.where(a > 0, _midpoint_distance(hf) / mag,
                                 torch.inf))
  if forward:
    head_w, head_b = weights.head
    n_used = spec.alpha_channels + spec.norm_dim
    fwd = [(h @ head_w + head_b)[:, :n_used], hf,
           hf if weights.bottleneck is None else
           h @ weights.bottleneck[0] + weights.bottleneck[1]]
  out, (r, r_mag) = 0, r0
  for i in range(spec.depth - 1, -1, -1):
    w = weights.layers[i][0]
    cf = r * masks[i]
    c = rnd(cf)
    for k, u in moved(i, _C):
      c[k, u] = _other_bf16(cf[k, u])
    add_sites(_C, i, _midpoint_distance(cf) / r_mag.clamp_min(1e-300))
    if i == 0 or spec.is_skip(i):
      out = out + c @ (w if i == 0 else w[spec.width:]).T
    if i > 0:
      r = c @ w[:spec.width].T
      r_mag = c.abs() @ w[:spec.width].abs().T
  if forward:
    out = torch.cat([out, *fwd], -1)
  if not near:
    return out, None
  d, j = torch.cat(dists, 1).topk(near, dim=1, largest=False)
  width = spec.width
  return out, [[(dd, *where[jj // width], jj % width)
                for dd, jj in zip(dr, jr) if dd < 2**-14]
               for dr, jr in zip(d.tolist(), j.tolist())]


def bf16_flips(feat: torch.Tensor, weights: TrunkWeights, spec: TrunkSpec,
               got: torch.Tensor, cots: Optional[Cotangents] = None):
  """Explains rows of a bf16 kernel's outputs for the rows ``feat``:
  ``got`` [B, ·] is K1f's g, σ, normal, trunk_out and bottleneck side by
  side (``cots`` None), or K1b's feat̄ (the rows' ``cots``).

  Each row is explained as the plain bf16 version in float64 with every
  rounding to nearest, or with sites moved: a relu mask, a bf16 rounding
  of h or of c, each nearer to where it flips than 2^-14 of the magnitude
  of the float32 sum that makes it, so that that sum's order can move it.
  Each of up to ``_FLIP_STEPS`` steps moves one of the ``_FLIP_TRIES``
  sites nearest to flipping, or one and then one of the ``_FLIP_PAIRS``
  nearest in the row so moved (a moved rounding can bring another to its
  midpoint), whichever brings the row nearest to ``got``; the next step
  starts from the row so moved. The product of two bf16 values is exact in
  float32, so the two versions differ only in the order of their float32
  sums. A moved site carries on through the later layers: where it moves a
  mask the row's g or feat̄ changes beyond the bf16 tolerance, and a few
  roundings moved one bf16 step each can put an element near 0 beyond its
  atol. Returns for each row its moved sites, each (kind, layer, unit,
  distance) (``[]`` for none), or None when no such result matches within
  atol 1e-4 + rtol 1e-4.

  g and feat̄ depend on the forward values only through the masks, and
  on the sweep's seed only through c's roundings."""
  rnd = lambda t: t.to(torch.bfloat16).double()
  w64 = TrunkWeights(
      layers=[(rnd(w), b.double()) for w, b in weights.layers],
      head=(rnd(weights.head[0]), weights.head[1].double()),
      bottleneck=(None if weights.bottleneck is None else
                  (rnd(weights.bottleneck[0]), weights.bottleneck[1].double())))
  x, dev = rnd(feat), feat.device
  head_w = w64.head[0]
  if cots is None:
    seed = head_w[:, 0].expand(x.shape[0], -1)
    r0 = (seed, torch.zeros_like(seed))
  else:
    sbar, nbar, tbar, bbar, _ = (c.double() if c is not None else None
                                 for c in cots)
    n_used = spec.alpha_channels + spec.norm_dim
    head_bar = rnd(torch.cat([sbar, nbar], -1) if spec.norm_dim > 0
                   else sbar)
    r, mag = (tbar + head_bar @ head_w[:, :n_used].T,
              tbar.abs() + head_bar.abs() @ head_w[:, :n_used].abs().T)
    if w64.bottleneck is not None:
      r = r + rnd(bbar) @ w64.bottleneck[0].T
      mag = mag + rnd(bbar).abs() @ w64.bottleneck[0].abs().T
    r0 = (r, mag)

  def sweep(idx, sets, near=0):  # rows ``idx``, each with its set moved
    width = max(1, *map(len, sets))
    sets = [c + [(0.0, 0, -1, -1)] * (width - len(c)) for c in sets]
    outs, sites = [], []
    for lo in range(0, len(sets), _SWEEP_ROWS):
      part = idx[lo:lo + _SWEEP_ROWS]
      kind, layer, unit = (
          torch.tensor([[s[k] for s in c] for c in sets[lo:lo + _SWEEP_ROWS]],
                       device=dev) for k in (1, 2, 3))
      out, near_sites = _bf16_sweep64(x[part], w64, spec,
                                      (r0[0][part], r0[1][part]),
                                      kind, layer, unit, near,
                                      forward=cots is None)
      outs.append(out)
      sites += near_sites or []
    return torch.cat(outs), sites

  got, result = got.double(), [None] * x.shape[0]
  moved = [[] for _ in range(x.shape[0])]
  active = list(range(x.shape[0]))
  for _ in range(_FLIP_STEPS + 1):
    if not active:
      break
    _, near = sweep(torch.tensor(active, device=dev),
                    [moved[b] for b in active],
                    near=_FLIP_TRIES + _FLIP_STEPS)
    ones, one_owner = [], []
    for b, sites in zip(active, near):
      taken = [m[1:] for m in moved[b]]
      ones += [moved[b] + [t] for t in sites
               if t[1:] not in taken][:_FLIP_TRIES]
      one_owner += [b] * (len(ones) - len(one_owner))
    # Each site moved alone, and with each of the _FLIP_PAIRS sites nearest
    # to flipping once it has moved.
    _, after = sweep(torch.tensor(one_owner, device=dev), ones,
                     near=_FLIP_PAIRS + _FLIP_STEPS + 1)
    per_row = {b: [moved[b]] for b in active}
    for b, c, sites in zip(one_owner, ones, after):
      taken = [m[1:] for m in c]
      per_row[b] += [c] + [c + [t] for t in sites
                           if t[1:] not in taken][:_FLIP_PAIRS]
    sets = [c for b in active for c in per_row[b]]
    owner = [b for b in active for _ in per_row[b]]
    idx = torch.tensor(owner, device=dev)
    want, _ = sweep(idx, sets)
    diff = got[idx] - want
    ok = ((diff.abs() <= 1e-4 + 1e-4 * want.abs()).all(-1)).tolist()
    dist = diff.norm(dim=-1).tolist()
    still, lo = [], 0
    while lo < len(sets):
      b, hi = owner[lo], lo
      while hi < len(sets) and owner[hi] == b:
        hi += 1
      first = min((j for j in range(lo, hi) if ok[j]), default=None,
                  key=lambda j: len(sets[j]))
      if first is not None:
        result[b] = [(_FLIP_KINDS[k], i, u, d) for d, k, i, u in sets[first]]
      else:
        best = min(range(lo, hi), key=dist.__getitem__)
        if best != lo:  # sets[lo] is the row as moved so far
          moved[b] = sets[best]
          still.append(b)
      lo = hi
    active = still
  return result


def check_bf16_rows(feat: torch.Tensor, weights: TrunkWeights,
                    spec: TrunkSpec, got, want,
                    cots: Optional[Cotangents] = None, name: str = 'K1f'):
  """The rule of the bf16 kernels' checks on the card: ``got`` and
  ``want`` are the kernel's and the plain bf16 version's K1f outputs
  (``cots`` None) or K1b's feat̄.

  Every row beyond atol 1e-3 + rtol 1e-2 in any of them must lie in a
  whole row tile (the ragged last tile must match outright), such rows may
  be at most 2% of N (or one row), and :func:`bf16_flips` must
  explain each one, all of its outputs together. Raises AssertionError
  otherwise. Returns (those rows as a bool mask [N], their indices, each
  one's moved sites); with their cotangents zeroed they add nothing to any
  output of K1b."""
  if cots is None:  # as bf16_flips orders them
    got, want = (torch.cat([o[4], *(t for t in o[:4] if t is not None)], -1)
                 for o in (got, want))
  n = feat.shape[0]
  bad = ((got - want).abs() > 1e-3 + 1e-2 * want.abs()).any(-1)
  rows = torch.nonzero(bad).flatten().tolist()
  ragged = n - n % KERNEL_TILE_ROWS if n % KERNEL_TILE_ROWS else n
  if len(rows) > max(1.0, _BF16_MAX_ROW_FRAC * n):
    raise AssertionError(f'{name}: {len(rows)} rows of {n} beyond '
                         f'tolerance: {rows[:12]}')
  if [r for r in rows if r >= ragged]:
    raise AssertionError(f'{name}: rows {[r for r in rows if r >= ragged]} '
                         f'of the ragged last tile (from {ragged}) beyond '
                         'tolerance')
  idx = torch.tensor(rows, dtype=torch.long, device=feat.device)
  flips = bf16_flips(feat[idx], weights, spec, got[idx],
                     None if cots is None else
                     tuple(c[idx] if c is not None else None for c in cots))
  if None in flips:
    raise AssertionError(
        f'{name}: rows {[r for r, f in zip(rows, flips) if f is None]} match '
        'no plain bf16 result with sites moved near their flips')
  return bad, rows, flips


def _check(feat: torch.Tensor, weights: TrunkWeights, spec: TrunkSpec,
           compute_dtype=None):
  _rounder(compute_dtype)  # raises for a dtype the kernels do not take
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


def _count_name(kernel: str, compute_dtype) -> str:
  """The ``kernels.launch_counts`` entry of a launch in ``compute_dtype``."""
  return f'{kernel}_bf16' if compute_dtype == torch.bfloat16 else kernel


def _weight_dtype(compute_dtype) -> torch.dtype:
  """The dtype in which the kernels take their weights."""
  return torch.bfloat16 if compute_dtype == torch.bfloat16 else torch.float32


def _layer_operands(weights: TrunkWeights, spec: TrunkSpec,
                    compute_dtype=None):
  """(per trunk layer the five operands ``(wf_h, wf_x, wr_h, wr_x, bias)``,
  None where unused; their pointers, 0 for None).

  Per layer: forward weights [in, out] and their transposes [out, in], so
  that both the forward and the reverse sweeps read contiguous rows. The
  reverse weights to feat are zero-padded to ``KERNEL_NARROW_WIDTH``
  columns. Weights are in the compute dtype (bf16 or float32), biases in
  float32. Both kernels take the same operands: ``TrunkSigmaGrad`` makes
  them once for a forward and its backward.
  """
  wdt = _weight_dtype(compute_dtype)
  layers, ptrs = [], []
  for i, (w, b) in enumerate(weights.layers):
    w = w.to(wdt)
    if spec.is_skip(i):
      wf_h, wf_x = w[:spec.width].contiguous(), w[spec.width:].contiguous()
    else:
      wf_h, wf_x = w.contiguous(), None
    # Reverse weights: to h for i > 0; to feat at layer 0 and the skips.
    wr_h = wf_h.T.contiguous() if i > 0 else None
    wr_x = wf_h if i == 0 else wf_x
    wr_x = (kernels.pad_columns(wr_x.T, KERNEL_NARROW_WIDTH)
            if wr_x is not None else None)
    layer = (wf_h, wf_x, wr_h, wr_x, b.contiguous())
    layers.append(layer)
    ptrs.extend(t.data_ptr() if t is not None else 0 for t in layer)
  return layers, ptrs


def _head_operands(weights: TrunkWeights, compute_dtype=None):
  """K1f's head and bottleneck operands: (head kernel, head bias, bottleneck
  kernel, its bias; None without a bottleneck), biases float32. float32:
  the head [W, hc] zero-padded to ``KERNEL_NARROW_WIDTH`` columns and the
  bottleneck [in, out]. bf16: both transposed, the head to
  [``KERNEL_MAX_HEAD``, W] with zero rows past hc."""
  head_w, head_b = weights.head
  bn_w, bn_b = (weights.bottleneck if weights.bottleneck is not None
                else (None, None))
  if compute_dtype == torch.bfloat16:
    head_w = kernels.pad_columns(head_w, KERNEL_MAX_HEAD).T
    bn_w = bn_w.T if bn_w is not None else None
  else:
    head_w = kernels.pad_columns(head_w.contiguous(), KERNEL_NARROW_WIDTH)
  wdt = _weight_dtype(compute_dtype)
  return (head_w.to(wdt).contiguous(), head_b.contiguous(),
          bn_w.to(wdt).contiguous() if bn_w is not None else None,
          bn_b.contiguous() if bn_b is not None else None)


def _bwd_head_operands(weights: TrunkWeights, spec: TrunkSpec,
                       compute_dtype=None):
  """K1b's head and bottleneck operands for the seed of r: float32, the
  head [W, hc], its used columns transposed [hcu, W] and the bottleneck
  transposed [out, in] (None without one); bf16, the head zero-padded to
  [W, ``KERNEL_MAX_HEAD``] and the bottleneck [in, out], which the tensor
  cores take as they are."""
  hcu = spec.alpha_channels + spec.norm_dim
  head_w = weights.head[0]
  bn_w = weights.bottleneck[0] if spec.has_bottleneck else None
  if compute_dtype == torch.bfloat16:
    ops = (kernels.pad_columns(head_w, KERNEL_MAX_HEAD), bn_w)
  else:
    ops = (head_w, head_w[:, :hcu].T, bn_w.T if bn_w is not None else None)
  wdt = _weight_dtype(compute_dtype)
  return tuple(t.to(wdt).contiguous() if t is not None else None
               for t in ops)


def _check_aligned(tensors):
  for t in tensors:
    if t is not None and t.data_ptr() % 16:
      raise ValueError('fused trunk operands must be 16-byte aligned')


def _stream(device):
  return torch.cuda.current_stream(device).cuda_stream


def _launch(feat: torch.Tensor, weights: TrunkWeights, spec: TrunkSpec,
            operands=None, compute_dtype=None) -> Outputs:
  """Runs ``csrc/fused_trunk_fwd.cu`` on the current stream; ``operands``
  are ``_layer_operands(weights, spec, compute_dtype)``, made here when
  None."""
  hc = weights.head[0].shape[1]
  _check_kernel_limits(spec, hc)
  n, d = feat.shape
  feat = feat.contiguous()
  layers, ptrs = operands or _layer_operands(weights, spec, compute_dtype)
  ptrs = list(ptrs)
  head = _head_operands(weights, compute_dtype)
  for t in head:
    ptrs.append(t.data_ptr() if t is not None else 0)
  _check_aligned([*(t for layer in layers for t in layer), *head])

  new = lambda *shape: torch.empty(shape, device=feat.device,
                                   dtype=torch.float32)
  sigma, trunk, bneck, g = new(n, 1), new(n, spec.width), new(n, spec.width), \
      new(n, d)
  norm = new(n, spec.norm_dim) if spec.norm_dim > 0 else None
  if n == 0:
    return sigma, norm, trunk, bneck, g
  skip_bits = sum(1 << i for i in spec.skips)
  ptr_array = (ctypes.c_uint64 * len(ptrs))(*ptrs)
  name = _count_name('fused_trunk_fwd', compute_dtype)
  launch = getattr(build.load_library(), name)
  # bf16: the L1 norms of the weights' rows, which the entry computes (the
  # window of the sums it takes again in order; see _launch_backward).
  l1 = (new(3 * spec.depth * spec.width) if compute_dtype == torch.bfloat16
        else None)
  extra = (l1.data_ptr(),) if l1 is not None else ()
  with torch.cuda.device(feat.device):
    rc = launch(
        feat.data_ptr(), ptr_array, n, d, spec.depth, skip_bits, hc,
        spec.norm_dim, int(spec.has_bottleneck), sigma.data_ptr(),
        norm.data_ptr() if norm is not None else 0, trunk.data_ptr(),
        bneck.data_ptr(), g.data_ptr(), *extra, _stream(feat.device))
  build.check(rc, name)
  kernels.launch_counts[name] += 1
  return sigma, norm, trunk, bneck, g


def backward_splits(n: int) -> int:
  """Row splits of the backward's weight-grad reduction: a function of N
  alone, so that two launches on the same inputs sum in the same order."""
  return max(1, min(KERNEL_BWD_MAX_SPLITS,
                    -(-n // KERNEL_BWD_SPLIT_ROWS)))


def backward_scratch_floats(n: int, depth: int, compute_dtype=None) -> int:
  """Floats of K1b's device scratch for N rows: c₁ and c_g of every layer
  and the last τ layer in float32, and h of every layer and τ of the
  others in the compute dtype (half a float each in bf16)."""
  layer = n * KERNEL_WIDTH
  narrow = 2 * depth - 1
  if compute_dtype == torch.bfloat16:
    return (2 * depth + 1) * layer + narrow * layer // 2
  return (2 * depth + 1 + narrow) * layer


def _launch_backward(feat: torch.Tensor, weights: TrunkWeights,
                     spec: TrunkSpec, cots: Cotangents, operands=None,
                     compute_dtype=None
                     ) -> Tuple[torch.Tensor, TrunkWeights]:
  """Runs ``csrc/fused_trunk_bwd.cu`` on the current stream: the sweeps,
  then the weight-grad reduction in a fixed order. ``operands`` as for
  ``_launch``."""
  bf16 = compute_dtype == torch.bfloat16
  hc = weights.head[0].shape[1]
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
  feat_k, gbar_k = ((kernels.pad_columns(x, ldx) if ldx != d
                     else x.contiguous()) for x in (feat, gbar))
  # bf16: the weight-grad products read bf16 copies of feat and Ḡ, rows of
  # D rounded up to 8 values (16 bytes).
  feat16, gbar16 = ((kernels.pad_columns(x.to(torch.bfloat16), -(-d // 8) * 8)
                     for x in (feat, gbar)) if bf16 else (None, None))
  head_cot = kernels.pad_columns(
      torch.cat([sbar, nbar], -1) if spec.norm_dim > 0 else sbar,
      KERNEL_MAX_HEAD)
  bbar = bbar.contiguous() if spec.has_bottleneck else None
  layers, ptrs = operands or _layer_operands(weights, spec, compute_dtype)
  ptrs = list(ptrs)
  head = _bwd_head_operands(weights, spec, compute_dtype)
  for t in head:
    ptrs.append(t.data_ptr() if t is not None else 0)
  _check_aligned([*(t for layer in layers for t in layer), *head,
                  feat_k, head_cot, tbar, bbar, gbar_k, feat16, gbar16])

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
  # Device-memory scratch of the sweeps: h_i, τ_i, c1_i and c_g,i for every
  # layer (2.1 GB at depth 8, N = 65,536 in float32; 1.6 GB in bf16).
  scratch = torch.empty(backward_scratch_floats(n, spec.depth, compute_dtype),
                        device=dev, dtype=torch.float32)
  partials = torch.empty(splits * per_split, device=dev,
                         dtype=torch.float32)
  skip_bits = sum(1 << i for i in spec.skips)
  wptr_array = (ctypes.c_uint64 * len(ptrs))(*ptrs)
  gptr_array = (ctypes.c_uint64 * len(gptrs))(*gptrs)
  name = _count_name('fused_trunk_bwd', compute_dtype)
  lib = build.load_library()
  # bf16: Σ_rows τ_L joins the σ column of the head's grad as an f32 sum;
  # float32: e0, a unit column, adds it through the weight-grad product.
  if bf16:
    inputs = (feat16.data_ptr(), gbar16.data_ptr(), wptr_array, gptr_array)
    # The L1 norms of the weights' rows, which the entry computes: the
    # window in which the sweep sums again in order a sum near its bf16
    # rounding or its relu mask.
    l1 = torch.empty((3 * spec.depth + 2) * spec.width, device=dev,
                     dtype=torch.float32)
    extra = (l1.data_ptr(),)
  else:
    e0 = torch.zeros(n, KERNEL_MAX_HEAD, device=dev, dtype=torch.float32)
    e0[:, 0] = 1.0
    inputs = (wptr_array, gptr_array, e0.data_ptr())
    extra = ()
  with torch.cuda.device(dev):
    rc = getattr(lib, name)(
        feat_k.data_ptr(), head_cot.data_ptr(), tbar.data_ptr(),
        bbar.data_ptr() if bbar is not None else 0, gbar_k.data_ptr(),
        *inputs, n, d, spec.depth, skip_bits, hc, hcu,
        int(spec.has_bottleneck), splits, per_split, xbar.data_ptr(),
        scratch.data_ptr(), partials.data_ptr(), *extra, _stream(dev))
  build.check(rc, name)
  kernels.launch_counts[name] += 1
  return xbar, grads


def _dispatch(feat, kernel, plain, *args, operands=None, compute_dtype=None):
  if feat.device.type == 'cuda':
    return kernel(feat, *args, operands=operands, compute_dtype=compute_dtype)
  if feat.device.type == 'cpu':
    return plain(feat, *args, compute_dtype=compute_dtype)
  raise ValueError(f'no fused trunk path for device {feat.device}')


def trunk_sigma_grad_forward(feat: torch.Tensor, weights: TrunkWeights,
                             spec: TrunkSpec, operands=None,
                             compute_dtype=None) -> Outputs:
  """The forward on feat's device, without autograd: the kernel for CUDA
  tensors, the plain version for CPU tensors. ``operands``: the kernel's
  weight operands, made once by a caller that also runs the backward on
  the same weights (``TrunkSigmaGrad``); made here when None.
  ``compute_dtype``: None (float32) or ``torch.bfloat16`` operands."""
  _check(feat, weights, spec, compute_dtype)
  return _dispatch(feat, _launch, trunk_sigma_grad_reference, weights, spec,
                   operands=operands, compute_dtype=compute_dtype)


def trunk_sigma_grad_backward(feat: torch.Tensor, weights: TrunkWeights,
                              spec: TrunkSpec, cots: Cotangents,
                              operands=None, compute_dtype=None
                              ) -> Tuple[torch.Tensor, TrunkWeights]:
  """The backward on feat's device: the kernel for CUDA tensors, the plain
  version for CPU tensors. See :func:`trunk_sigma_grad_backward_reference`;
  ``operands`` and ``compute_dtype`` as for
  :func:`trunk_sigma_grad_forward`.
  """
  _check(feat, weights, spec, compute_dtype)
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
                   operands=operands, compute_dtype=compute_dtype)


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
  def forward(ctx, feat, spec, compute_dtype, *flat):
    ctx.spec, ctx.compute_dtype = spec, compute_dtype
    ctx.save_for_backward(feat, *flat)
    weights = _unflatten(flat, spec)
    # The kernels' transposed and padded weights, made once for K1f and K1b.
    ctx.operands = None
    if feat.device.type == 'cuda':
      _check(feat, weights, spec, compute_dtype)
      _check_kernel_limits(spec, weights.head[0].shape[1])
      ctx.operands = _layer_operands(weights, spec, compute_dtype)
    return trunk_sigma_grad_forward(feat, weights, spec, ctx.operands,
                                    compute_dtype)

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
        ctx.operands, ctx.compute_dtype)
    return (xbar, None, None, *_flatten(grads))


def trunk_sigma_grad(feat: torch.Tensor, weights: TrunkWeights,
                     spec: TrunkSpec, compute_dtype=None) -> Outputs:
  """(σ, normal, trunk_out, bottleneck, g) on feat's device, differentiable
  in feat and every weight (:class:`TrunkSigmaGrad`), with
  ``compute_dtype`` operands (None: float32; ``torch.bfloat16``). See
  :func:`trunk_sigma_grad_reference` for the outputs."""
  return TrunkSigmaGrad.apply(feat, spec, compute_dtype, *_flatten(weights))
