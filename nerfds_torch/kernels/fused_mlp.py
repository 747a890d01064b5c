"""Whole-MLP forward (K3): CUDA kernel, its plain version and the drop-in
``fused_apply``.

Counterpart of ``nerfds_tpu/pallas/fused_mlp.py``. ``fused_mlp_forward``
runs every Dense layer of a ``models.mlp.MLP`` stack in one launch: the
hidden layers with the input re-fed at the skip layers (``[h, x]``), their
activation, and the optional output layer with its own. The kernel is
``csrc/fused_mlp_fwd.cu``; ``fused_mlp_reference`` is the same function as a
chain of ``@``, ``+``, activation and ``cat``. The wrapper takes the plain
version only for CPU tensors and the kernel for CUDA tensors, and a shape
outside the kernel's limits raises ``ValueError``.

``models.mlp.MLP.forward`` reaches the kernel itself (:func:`mlp_forward`)
for a float32 stack of at least ``MIN_ROUTED_DEPTH`` hidden layers called
under no_grad on CUDA tensors (:func:`stack_refusal` and
``MLP.k3_refusal`` give the rule), with the padded weights built once per
set of parameters (:func:`mlp_operands`).

Forward only, as in the JAX package: a call with grad mode on refuses
tensors that require grad, rather than return a result without a
gradient; ``fused_apply`` runs under ``torch.no_grad``. The output is
always float32. With ``compute_dtype=torch.bfloat16`` the input, the
weights, each layer's f32 sum, the bias add and the activation are rounded
to bf16 where the TPU kernel's ``.astype`` puts them; products are summed
in f32.
"""
from __future__ import annotations

import ctypes
import math
from typing import Any, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from nerfds_torch import kernels
from nerfds_torch.kernels import build
from nerfds_torch.models.mlp import get_activation

Layers = Sequence[Tuple[torch.Tensor, torch.Tensor]]

# The kernel's activation codes (csrc/fused_mlp_fwd.cu, enum Act).
ACTIVATIONS = {'none': 0, 'identity': 0, 'relu': 1, 'sigmoid': 2,
               'softplus': 3, 'tanh': 4}
# Limits compiled into csrc/fused_mlp_fwd.cu.
KERNEL_MAX_LAYERS = 17
KERNEL_MAX_COLS = 256
KERNEL_MAX_IN_DIM = 1024
KERNEL_TILE_ROWS = 64   # rows a block owns (trunk_tile.cuh's TM)
# The kernel's register-tile classes: a layer's columns are zero-padded to
# the first of these that holds them; the last layer may also take
# KERNEL_HEAD_WIDTH.
KERNEL_WIDTHS = (64, 128, 256)
KERNEL_HEAD_WIDTH = 16


def _act_name(name: Optional[str]) -> str:
  name = 'none' if name is None else name
  if name not in ACTIVATIONS:
    raise NotImplementedError(name)
  return name


def apply_activation(x: torch.Tensor, name: Optional[str]) -> torch.Tensor:
  """The activations of the TPU kernel; any other raises
  ``NotImplementedError``."""
  return get_activation(_act_name(name))(x)


def _rounder(compute_dtype):
  if compute_dtype == torch.bfloat16:
    return lambda t: t.to(torch.bfloat16).float()
  return lambda t: t


def _compute_dtype(x: torch.Tensor, compute_dtype):
  cdt = x.dtype if compute_dtype is None else compute_dtype
  if cdt not in (torch.float32, torch.bfloat16):
    raise ValueError(f'compute_dtype must be float32 or bfloat16, got {cdt}')
  return cdt


def fused_mlp_reference(x: torch.Tensor, layers: Layers,
                        skips: Tuple[int, ...] = (),
                        hidden_activation: Optional[str] = 'relu',
                        output_activation: Optional[str] = None,
                        has_output_layer: bool = False,
                        compute_dtype=None) -> torch.Tensor:
  """The forward as plain PyTorch ops, float32 out; see the module."""
  rnd = _rounder(_compute_dtype(x, compute_dtype))
  num_hidden = len(layers) - int(has_output_layer)
  x_c = rnd(x.float())
  h = x_c
  for i, (w, b) in enumerate(layers):
    w, b = rnd(w.float()), rnd(b.float())
    if i < num_hidden and i in skips:
      h = torch.cat([h, x_c], -1)
    act = hidden_activation if i < num_hidden else output_activation
    h = rnd(apply_activation(rnd(rnd(h @ w) + b), act))
  return h


def _check(x: torch.Tensor, layers: Layers, skips, has_output_layer: bool):
  if x.dim() != 2:
    raise ValueError(f'x must be [N, C_in], got {tuple(x.shape)}')
  if not layers:
    raise ValueError('fused_mlp_forward needs at least one layer')
  num_hidden = len(layers) - int(has_output_layer)
  width = x.shape[1]
  for i, (w, b) in enumerate(layers):
    rows = width + (x.shape[1] if i < num_hidden and i in skips else 0)
    if w.dim() != 2 or w.shape[0] != rows or tuple(b.shape) != (w.shape[1],):
      raise ValueError(f'layer {i}: kernel {tuple(w.shape)}, bias '
                       f'{tuple(b.shape)}; want ({rows}, ·) and (·,)')
    if w.device != x.device or b.device != x.device:
      raise ValueError(f'layer {i} is on {w.device}, x on {x.device}')
    width = w.shape[1]
  if torch.is_grad_enabled() and any(
      t.requires_grad for t in (x, *(t for layer in layers for t in layer))):
    raise ValueError('fused_mlp_forward is forward-only: call it under '
                     'torch.no_grad() or pass tensors that do not require '
                     'grad')


def _check_kernel_limits(x: torch.Tensor, layers: Layers):
  cols = [w.shape[1] for w, _ in layers]
  if (len(layers) > KERNEL_MAX_LAYERS or x.shape[1] > KERNEL_MAX_IN_DIM
      or max(cols) > KERNEL_MAX_COLS):
    raise ValueError(
        f'the CUDA MLP kernel takes at most {KERNEL_MAX_LAYERS} layers, '
        f'{KERNEL_MAX_IN_DIM} input channels and {KERNEL_MAX_COLS} output '
        f'columns a layer; got {len(layers)} layers, {x.shape[1]} input '
        f'channels, columns {cols}')


def kernel_width(cols: int, last: bool) -> int:
  """The padded width of a layer of ``cols`` output columns in the kernel:
  the first of ``KERNEL_WIDTHS`` that holds it, or ``KERNEL_HEAD_WIDTH`` for
  a last layer that fits it."""
  if last and cols <= KERNEL_HEAD_WIDTH:
    return KERNEL_HEAD_WIDTH
  return next(w for w in KERNEL_WIDTHS if cols <= w)


def kernel_operands(layers: Layers, skips, hidden_activation,
                    output_activation, has_output_layer: bool,
                    compute_dtype) -> list:
  """What the kernel reads of each layer: ``(W, b, cols, width, skip,
  act)`` with W's and b's columns zero-padded to :func:`kernel_width` and
  rounded to bf16 for bf16 compute; ``act`` is the kernel's code."""
  rnd = _rounder(compute_dtype)
  num_hidden = len(layers) - int(has_output_layer)
  ops = []
  for i, (w, b) in enumerate(layers):
    cols = w.shape[1]
    width = kernel_width(cols, i == len(layers) - 1)
    act = hidden_activation if i < num_hidden else output_activation
    ops.append((kernels.pad_columns(rnd(w.float()), width),
                kernels.pad_columns(rnd(b.float()), width), cols, width,
                int(i < num_hidden and i in skips),
                ACTIVATIONS[_act_name(act)]))
  return ops


def prefetched_layers(ops: list) -> int:
  """The layers of a launch over the layers' :func:`kernel_operands` whose
  bias the kernel stages into shared memory with the layer's first weight
  chunk, ahead of the epilogue that reads it: every layer."""
  return len(ops)


def _launch(x: torch.Tensor, layers: Layers, skips, hidden_activation,
            output_activation, has_output_layer: bool,
            compute_dtype) -> torch.Tensor:
  """Runs ``csrc/fused_mlp_fwd.cu`` on the current stream."""
  _check_kernel_limits(x, layers)
  # The kernel copies x in 16-byte pieces: aligned rows of a multiple of 4
  # floats, zero past C_in; rounded here for bf16 compute.
  c_in = x.shape[1]
  x = _rounder(compute_dtype)(x.float())
  if c_in % 4 or x.data_ptr() % 16 or not x.is_contiguous():
    x = kernels.pad_columns(x, -(-c_in // 4) * 4)
  ops = kernel_operands(layers, skips, hidden_activation, output_activation,
                        has_output_layer, compute_dtype)
  return _run(x, c_in, ops, compute_dtype)


def _run(x: torch.Tensor, c_in: int, ops: list,
         compute_dtype) -> torch.Tensor:
  """One launch of the kernel over ``x [N, ldx]`` (contiguous, 16-byte
  aligned, ``ldx`` a multiple of 4, zero past ``c_in``) and the layers'
  :func:`kernel_operands`; float32 ``[N, cols]`` out."""
  n = x.shape[0]
  out = torch.empty(n, ops[-1][2], device=x.device, dtype=torch.float32)
  if n == 0:
    return out
  ptrs = [t.data_ptr() for op in ops for t in op[:2]]
  dims = [v for op in ops for v in op[2:]]
  if any(p % 16 for p in ptrs):
    raise ValueError('fused MLP operands must be 16-byte aligned')
  ptr_array = (ctypes.c_uint64 * len(ptrs))(*ptrs)
  dim_array = (ctypes.c_int * len(dims))(*dims)
  lib = build.load_library()
  with torch.cuda.device(x.device):
    rc = lib.fused_mlp_fwd(
        x.data_ptr(), n, c_in, x.shape[1], ptr_array, dim_array, len(ops),
        int(compute_dtype == torch.bfloat16), out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
  build.check(rc, 'fused_mlp_fwd')
  kernels.launch_counts['fused_mlp_fwd'] += 1
  kernels.launch_counts['fused_mlp_fwd_prefetched_layers'] += (
      prefetched_layers(ops))
  return out


def fused_mlp_forward(x: torch.Tensor, layers: Layers,
                      skips: Tuple[int, ...] = (),
                      hidden_activation: Optional[str] = 'relu',
                      output_activation: Optional[str] = None,
                      has_output_layer: bool = False, tile: int = 512,
                      compute_dtype=None) -> torch.Tensor:
  """Runs the whole Dense stack over ``x [N, C_in]``: the kernel for CUDA
  tensors, the plain version for CPU tensors. ``layers``: ``[(W [in, out],
  b [out]), ...]``, the hidden layers and then, when ``has_output_layer``,
  the output layer. ``tile`` is the TPU kernel's row tile, kept for its
  signature: the CUDA kernel's blocks take ``KERNEL_TILE_ROWS`` rows."""
  if tile < 1:
    raise ValueError(f'tile must be positive, got {tile}')
  for name in (hidden_activation, output_activation):
    _act_name(name)
  cdt = _compute_dtype(x, compute_dtype)
  _check(x, layers, skips, has_output_layer)
  if x.device.type == 'cuda':
    return _launch(x, layers, tuple(skips), hidden_activation,
                   output_activation, has_output_layer, cdt)
  if x.device.type == 'cpu':
    return fused_mlp_reference(x, layers, tuple(skips), hidden_activation,
                               output_activation, has_output_layer, cdt)
  raise ValueError(f'no fused MLP path for device {x.device}')


def _tensor(v: Any) -> torch.Tensor:
  return v if isinstance(v, torch.Tensor) else torch.from_numpy(
      np.array(v, np.float32))


def mlp_params_to_layers(mlp, params: Optional[Mapping[str, Any]]
                         ) -> Tuple[list, bool]:
  """``[(W, b), ...]`` and whether the last is an output layer, from a
  ``{'hidden_i': {'kernel', 'bias'}, 'logit': ...}`` mapping in the JAX
  layout (tensors or arrays), or from ``mlp``'s own parameters when
  ``params`` is None."""
  def pair(name):
    if params is None:
      dense = getattr(mlp, name)
      return dense.kernel.detach(), dense.bias.detach()
    return _tensor(params[name]['kernel']), _tensor(params[name]['bias'])

  layers = [pair(f'hidden_{i}') for i in range(mlp.depth)]
  has_output = mlp.output_channels > 0
  if has_output:
    layers.append(pair('logit'))
  return layers, has_output


def fused_apply(mlp, params: Optional[Mapping[str, Any]], x: torch.Tensor,
                compute_dtype=None, tile: int = 512) -> torch.Tensor:
  """Fused, forward-only equivalent of ``mlp(x)`` for a ``models.mlp.MLP``
  on ``params`` (see :func:`mlp_params_to_layers`), under no_grad. K3 has
  no hidden norm, so an MLP with one is refused (the JAX package's
  ``fused_apply`` drops the norm without a word)."""
  if getattr(mlp, 'hidden_norm', None) not in (None, 'none'):
    raise ValueError(f'fused_apply: K3 has no hidden norm, and this MLP '
                     f'has hidden_norm={mlp.hidden_norm!r}')
  layers, has_output = mlp_params_to_layers(mlp, params)
  layers = [(w.to(x.device), b.to(x.device)) for w, b in layers]
  with torch.no_grad():
    return fused_mlp_forward(
        x, layers, skips=tuple(mlp.skips),
        hidden_activation=mlp.hidden_activation,
        output_activation=mlp.output_activation,
        has_output_layer=has_output, tile=tile, compute_dtype=compute_dtype)


# The fewest hidden layers of a stack that ``MLP.forward`` sends to the
# kernel (:func:`stack_refusal`). At N = 524,288 on the H100 the σ/normal
# head (no hidden layer) takes 0.39-0.44 ms here against F.linear's 0.26,
# and the rgb branch (one hidden layer) ties its plain chain at 2.17 ms
# while its 560-column input would first have to be concatenated.
MIN_ROUTED_DEPTH = 2


def _dense_layers(mlp) -> list:
  """``mlp``'s Dense layers in the kernel's order: hidden, then output."""
  layers = [mlp.hidden(i) for i in range(mlp.depth)]
  if mlp.output_channels > 0:
    layers.append(mlp.logit)
  return layers


def stack_refusal(mlp) -> Optional[str]:
  """Why the kernel does not run the ``models.mlp.MLP`` stack ``mlp`` in
  place of its plain chain, or None where it does: fewer than
  ``MIN_ROUTED_DEPTH`` hidden layers ('depth'), a hidden norm
  ('hidden_norm'), an activation the kernel lacks ('activation'), a layer
  without a bias ('bias'), parameters that are not float32 ('dtype'), or a
  shape past the kernel's compiled limits ('limits')."""
  if mlp.depth < MIN_ROUTED_DEPTH:
    return 'depth'
  if mlp.hidden_norm not in (None, 'none'):
    return 'hidden_norm'
  if any((name or 'none') not in ACTIVATIONS
         for name in (mlp.hidden_activation, mlp.output_activation)):
    return 'activation'
  layers = _dense_layers(mlp)
  if any(d.bias is None for d in layers):
    return 'bias'
  if any(t.dtype != torch.float32 for d in layers
         for t in (d.kernel, d.bias)):
    return 'dtype'
  if (len(layers) > KERNEL_MAX_LAYERS or mlp.in_dim > KERNEL_MAX_IN_DIM
      or max(d.kernel.shape[1] for d in layers) > KERNEL_MAX_COLS):
    return 'limits'
  return None


def mlp_operands(mlp) -> list:
  """:func:`kernel_operands` of ``mlp``'s parameters in float32, built once
  and kept on the module until a parameter is replaced (a
  ``functional_call`` or a new state), moved or changed in place: the key
  holds each parameter itself, its ``_version`` and its data pointer."""
  params = [t for d in _dense_layers(mlp) for t in (d.kernel, d.bias)]
  cached = getattr(mlp, '_k3_operands', None)
  if cached is not None and len(cached[0]) == len(params) and all(
      held is t and version == t._version and ptr == t.data_ptr()
      for (held, version, ptr), t in zip(cached[0], params)):
    return cached[1]
  device = params[0].device
  if any(t.device != device for t in params):
    raise ValueError('the MLP\'s parameters lie on more than one device')
  with torch.no_grad():
    ops = kernel_operands(
        [(w.detach(), b.detach()) for w, b in zip(params[::2], params[1::2])],
        mlp.skips, mlp.hidden_activation, mlp.output_activation,
        mlp.output_channels > 0, torch.float32)
  mlp._k3_operands = ([(t, t._version, t.data_ptr()) for t in params], ops)
  return ops


def input_rows(inputs: Sequence[torch.Tensor]
               ) -> Tuple[torch.Tensor, Tuple[int, ...]]:
  """The feature blocks ``inputs``, of one leading shape, written once side
  by side into the kernel's ``x [N, ceil4(C_in)]`` (float32, zero past
  ``C_in``), and that leading shape, whose rows N counts."""
  lead = tuple(inputs[0].shape[:-1])
  if any(tuple(p.shape[:-1]) != lead for p in inputs[1:]):
    raise ValueError(f'feature blocks of leading shapes '
                     f'{[tuple(p.shape[:-1]) for p in inputs]}')
  c_in = sum(p.shape[-1] for p in inputs)
  ldx = -(-c_in // 4) * 4
  x = torch.empty(math.prod(lead), ldx, device=inputs[0].device,
                  dtype=torch.float32)
  rows = x.view(*lead, ldx)
  offset = 0
  for p in inputs:
    rows[..., offset:offset + p.shape[-1]] = p
    offset += p.shape[-1]
  if ldx > c_in:
    x[:, c_in:] = 0
  return x, lead


def mlp_forward(mlp, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
  """``mlp(inputs)`` in one launch of the kernel, for a call that
  ``models.mlp.MLP.k3_refusal`` admits: ``inputs`` are float32 feature
  blocks on the parameters' card, standing for their concatenation
  (:func:`input_rows`)."""
  c_in = sum(p.shape[-1] for p in inputs)
  if c_in != mlp.in_dim:
    raise ValueError(f'feature blocks sum to {c_in}, the MLP takes '
                     f'{mlp.in_dim}')
  x, lead = input_rows(inputs)
  out = _run(x, c_in, mlp_operands(mlp), torch.float32)
  return out.view(*lead, out.shape[-1])
