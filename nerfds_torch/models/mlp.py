"""MLP core (L3), counterpart of ``nerfds_tpu/models/mlp.py``.

Weights keep the JAX package's layout: every dense layer holds a
``kernel [in, out]`` and a ``bias [out]`` under the same names
(``hidden_i``, ``logit``, ``bottleneck``, ...), so the state dict of a module
is the JAX param tree with ``.`` for ``/`` (see ``nerfds_torch/convert.py``)
and the kernels read the same layout.

A dense layer may take a list of feature blocks: the list stands for their
concatenation, and each block multiplies its own rows of the kernel
(``concat([a, b]) @ W == a @ W[:da] + b @ W[da:]``), as in the JAX package.

With ``concat_input`` an MLP materialises the concatenation with
``torch.cat`` before the layer instead (the reference's op graph, the
``concat_dense_inputs`` flag); the kernel is the same ``[in, out]`` tensor.
``hidden_norm`` ('layer', 'group' or 'batch') normalises each hidden
layer's output before its activation, without a learned affine
(:func:`apply_norm`).

Two precision modes, as in the JAX package (``config.compute_dtype`` and
``config.storage_dtype``): ``dtype=torch.bfloat16`` runs the stack's
products, bias adds and activations in bf16 and returns float32;
``storage_dtype=torch.bfloat16`` keeps float32 compute but rounds every
stored activation through bf16 (:func:`quantize_storage`).

Under no_grad, a float32 stack of two or more hidden layers on a CUDA
device runs in one launch of K3 (``kernels/fused_mlp.py``) in place of its
chain of layers: :meth:`MLP.k3_refusal` gives the rule.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
from torch import nn
import torch.nn.functional as F

from nerfds_torch.kernels.fused_trunk import TrunkWeights

Init = Callable[[torch.Tensor, Optional[torch.Generator]], None]
Blocks = Union[torch.Tensor, Sequence[torch.Tensor]]


def glorot_uniform(t: torch.Tensor, generator=None) -> None:
  """U(-l, l) with l = sqrt(6 / (fan_in + fan_out)), for a ``[in, out]``
  kernel (``jax.nn.initializers.glorot_uniform``)."""
  limit = math.sqrt(6.0 / (t.shape[0] + t.shape[1]))
  with torch.no_grad():
    t.uniform_(-limit, limit, generator=generator)


def uniform_init(scale: float) -> Init:
  """U[0, scale) (``jax.nn.initializers.uniform``)."""
  def init(t, generator=None):
    with torch.no_grad():
      t.uniform_(0.0, scale, generator=generator)
  return init


def normal_init(stddev: float) -> Init:
  """N(0, stddev²) (``jax.nn.initializers.normal``)."""
  def init(t, generator=None):
    with torch.no_grad():
      t.normal_(0.0, stddev, generator=generator)
  return init


def get_activation(name: Optional[str]) -> Callable[[torch.Tensor],
                                                      torch.Tensor]:
  if name is None or name in ('none', 'identity'):
    return lambda x: x
  return {
      'relu': torch.relu,
      'elu': F.elu,
      'gelu': lambda x: F.gelu(x, approximate='tanh'),  # jax.nn.gelu default
      'silu': F.silu,
      'tanh': torch.tanh,
      'sigmoid': torch.sigmoid,
      'softplus': F.softplus,
      'sin': torch.sin,
  }[name]


def apply_norm(x: torch.Tensor, norm_type: Optional[str],
               num_groups: int = 32, pointwise: bool = False) -> torch.Tensor:
  """Parameter-free normalisation between a Dense and its activation.

  'layer' over the channels, 'group' over ``min(num_groups, C)`` equal
  groups of channels, 'batch' over every leading axis with the batch's own
  statistics (there are no running averages, as in the JAX package).
  ``pointwise=True`` gives each row its own batch of one, the statistics
  the JAX package's per-point σ function sees ('vmap' and 'naive' take
  ∇σ by ``vmap(value_and_grad)`` over single points): its 'batch' output
  is then 0."""
  if norm_type is None or norm_type == 'none':
    return x
  if norm_type == 'layer':
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-6)
  if norm_type == 'group':
    c = x.shape[-1]
    groups = min(num_groups, c)
    if c % groups != 0:
      raise ValueError(f'channels {c} not divisible by {groups} groups')
    g = x.reshape(*x.shape[:-1], groups, c // groups)
    mean = g.mean(-1, keepdim=True)
    var = ((g - mean) ** 2).mean(-1, keepdim=True)
    return ((g - mean) * torch.rsqrt(var + 1e-6)).reshape(x.shape)
  if norm_type == 'batch':
    if pointwise:
      mean = x
      var = (x - mean) ** 2
    else:
      axes = tuple(range(x.dim() - 1))
      mean = x.mean(axes, keepdim=True)
      var = ((x - mean) ** 2).mean(axes, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5)
  raise ValueError(f'Unknown norm type {norm_type!r}')


def quantize_storage(x: torch.Tensor, storage_dtype) -> torch.Tensor:
  """``x`` rounded through ``storage_dtype`` (bf16) and back: the value a
  narrow activation buffer would hold. Plain casts, so autograd (second
  order included) differentiates the quantised forward exactly; eager
  PyTorch never folds the round trip away, so it needs no barrier."""
  if storage_dtype is None or x.dtype == storage_dtype:
    return x
  return x.to(storage_dtype).to(x.dtype)


class Dense(nn.Module):
  """``y = x @ kernel + bias`` with a ``[in, out]`` kernel."""

  def __init__(self, in_dim: int, out_dim: int, init: Init = glorot_uniform,
               use_bias: bool = True, generator=None):
    super().__init__()
    self.kernel = nn.Parameter(torch.empty(in_dim, out_dim))
    init(self.kernel, generator)
    self.bias = nn.Parameter(torch.zeros(out_dim)) if use_bias else None

  def forward(self, x: Blocks) -> torch.Tensor:
    return dense_apply(self, x)


def dense_apply(dense: Dense, x: Blocks, dtype=None) -> torch.Tensor:
  """Dense layer over a tensor or a list of feature blocks. ``dtype``
  (bf16): the blocks, the kernel and the bias are cast to it, and the
  per-block products are summed in it."""
  kernel, bias = dense.kernel, dense.bias
  if dtype is not None:
    kernel = kernel.to(dtype)
    bias = bias.to(dtype) if bias is not None else None
  if isinstance(x, (list, tuple)):
    width = sum(part.shape[-1] for part in x)
    if width != kernel.shape[0]:
      raise ValueError(f'feature blocks sum to {width}, kernel rows '
                       f'{kernel.shape[0]}')
    y, offset = None, 0
    for part in x:
      d = part.shape[-1]
      if dtype is not None:
        part = part.to(dtype)
      contrib = part @ kernel[offset:offset + d]
      y = contrib if y is None else y + contrib
      offset += d
  else:
    y = (x.to(dtype) if dtype is not None else x) @ kernel
  if bias is not None:
    y = y + bias
  return y


def _fused_mlp():
  """``kernels/fused_mlp.py``, imported at the call: it imports this
  module."""
  from nerfds_torch.kernels import fused_mlp
  return fused_mlp


class MLP(nn.Module):
  """Dense stack with input re-feed skips and an optional output layer.

  At a skip layer the input is ``[h, inputs]``, in that order.
  ``hidden_norm`` and ``concat_input``: see the module's docstring.
  """

  def __init__(self, in_dim: int, depth: int, width: int,
               skips: Tuple[int, ...] = (), hidden_activation: str = 'relu',
               output_channels: int = 0,
               output_activation: Optional[str] = None,
               use_bias: bool = True, hidden_init: Init = glorot_uniform,
               output_init: Optional[Init] = None, generator=None,
               hidden_norm: Optional[str] = None,
               concat_input: bool = False):
    super().__init__()
    self.in_dim = in_dim
    self.depth, self.width, self.skips = depth, width, tuple(skips)
    self.hidden_activation = hidden_activation
    self.hidden_norm = hidden_norm
    self.concat_input = concat_input
    self.output_channels = output_channels
    self.output_activation = output_activation
    for i in range(depth):
      layer_in = (in_dim if i == 0 else width) + (
          in_dim if i in self.skips else 0)
      self.add_module(f'hidden_{i}', Dense(
          layer_in, width, hidden_init, use_bias, generator))
    if output_channels > 0:
      self.logit = Dense(width if depth > 0 else in_dim, output_channels,
                         output_init or glorot_uniform, use_bias, generator)

  def hidden(self, i: int) -> Dense:
    return getattr(self, f'hidden_{i}')

  def k3_refusal(self, inputs: Sequence[torch.Tensor], dtype=None,
                 storage_dtype=None) -> Optional[str]:
    """Why :meth:`forward` runs this call as the plain chain, or None where
    it runs the whole stack in one launch of K3
    (``kernels/fused_mlp.py``): grad mode on ('grad', so autograd and its
    second-order terms see the plain chain), a ``dtype`` or a
    ``storage_dtype`` ('dtype': K3 rounds to bf16 where the TPU kernel
    does, not where this module casts), a stack K3 does not take
    (``fused_mlp.stack_refusal``), feature blocks that are not float32
    ('dtype'), that differ in their leading shape ('shape': the chain
    broadcasts them) or that are not on one CUDA device with the
    parameters ('device')."""
    if torch.is_grad_enabled():
      return 'grad'
    if dtype is not None or storage_dtype is not None:
      return 'dtype'
    reason = _fused_mlp().stack_refusal(self)
    if reason is not None:
      return reason
    if any(p.dtype != torch.float32 for p in inputs):
      return 'dtype'
    if any(p.shape[:-1] != inputs[0].shape[:-1] for p in inputs[1:]):
      return 'shape'
    device = self.hidden(0).kernel.device
    if device.type != 'cuda' or any(p.device != device for p in inputs):
      return 'device'
    return None

  def forward(self, x: Blocks, dtype=None, storage_dtype=None,
              pointwise_norm: bool = False) -> torch.Tensor:
    """``dtype``: the inputs are cast once, the layers run in it and the
    output comes back in the inputs' dtype. ``storage_dtype``: each
    stored activation (the inputs and every hidden output) is quantised
    through it; ignored when ``dtype`` is set. ``pointwise_norm``: the
    'batch' norm's statistics are each row's own (:func:`apply_norm`).
    A call that :meth:`k3_refusal` admits runs through K3 instead of the
    chain of layers below, with the same result in another float32
    summation order."""
    inputs = list(x) if isinstance(x, (list, tuple)) else [x]
    if self.k3_refusal(inputs, dtype, storage_dtype) is None:
      return _fused_mlp().mlp_forward(self, inputs)
    act = get_activation(self.hidden_activation)
    if self.concat_input and len(inputs) > 1:
      inputs = [torch.cat(inputs, -1)]
    out_dtype = inputs[0].dtype
    if dtype is not None:
      inputs = [p.to(dtype) for p in inputs]
    elif storage_dtype is not None:
      inputs = [quantize_storage(p, storage_dtype) for p in inputs]
    h = None
    for i in range(self.depth):
      layer_in = inputs if i == 0 else [h]
      if i in self.skips:
        layer_in = layer_in + inputs
        if self.concat_input:
          layer_in = [torch.cat(layer_in, -1)]
      h = act(apply_norm(dense_apply(self.hidden(i), layer_in, dtype),
                         self.hidden_norm, pointwise=pointwise_norm))
      if dtype is None:
        h = quantize_storage(h, storage_dtype)
    out = h if self.depth > 0 else inputs
    if self.output_channels > 0:
      out = dense_apply(self.logit, out, dtype)
      if self.output_activation is not None:
        out = get_activation(self.output_activation)(out)
    if isinstance(out, list):  # depth 0 and no output layer: identity
      out = out[0] if len(out) == 1 else torch.cat(out, -1)
    if dtype is not None:
      out = out.to(out_dtype)
    return out


class NerfMLP(nn.Module):
  """Trunk, bottleneck, σ/normal head and rgb branch, with the staged
  queries of the JAX package: the trunk and bottleneck run once, σ (and the
  predicted normal) read the trunk output, rgb reads
  ``[bottleneck, rgb_condition], extra, screw, norm``."""

  def __init__(self, in_dim: int, alpha_cond_dim: int, rgb_cond_dim: int,
               has_condition: bool, trunk_depth: int = 8,
               trunk_width: int = 256, rgb_branch_depth: int = 1,
               rgb_branch_width: int = 128, rgb_channels: int = 3,
               alpha_channels: int = 1, activation: str = 'relu',
               skips: Tuple[int, ...] = (4,), predict_norm: bool = False,
               norm_dim: int = 3, generator=None,
               hidden_norm: Optional[str] = None,
               concat_input: bool = False):
    super().__init__()
    self.trunk_width = trunk_width
    self.alpha_channels = alpha_channels
    self.activation = activation
    self.skips = tuple(skips)
    self.predict_norm = predict_norm
    self.norm_dim = norm_dim
    self.concat_input = concat_input
    self.trunk = MLP(in_dim, trunk_depth, trunk_width, skips, activation,
                     generator=generator, hidden_norm=hidden_norm,
                     concat_input=concat_input)
    self.bottleneck = (Dense(trunk_width, trunk_width, generator=generator)
                       if has_condition else None)
    alpha_in = trunk_width + alpha_cond_dim
    self.alpha = MLP(alpha_in, 0, 0, output_channels=(
        alpha_channels + (norm_dim if predict_norm else 0)),
        generator=generator)
    self.rgb = MLP(trunk_width + rgb_cond_dim, rgb_branch_depth,
                   rgb_branch_width, hidden_activation=activation,
                   output_channels=rgb_channels, generator=generator,
                   hidden_norm=hidden_norm, concat_input=concat_input)

  def query_bottleneck(self, x: Blocks, dtype=None, storage_dtype=None,
                       pointwise_norm: bool = False):
    trunk_out = self.trunk(x, dtype=dtype, storage_dtype=storage_dtype,
                           pointwise_norm=pointwise_norm)
    if self.bottleneck is None:
      return trunk_out, trunk_out
    bottleneck = dense_apply(self.bottleneck, trunk_out, dtype)
    if dtype is not None:
      bottleneck = bottleneck.to(trunk_out.dtype)
    else:
      bottleneck = quantize_storage(bottleneck, storage_dtype)
    return trunk_out, bottleneck

  def query_sigma(self, trunk_out, bottleneck, alpha_condition=None,
                  dtype=None):
    alpha_in = ([bottleneck, alpha_condition] if alpha_condition is not None
                else trunk_out)
    if self.concat_input and isinstance(alpha_in, list):
      alpha_in = torch.cat(alpha_in, -1)
    out = self.alpha(alpha_in, dtype=dtype)
    sigma = out[..., :self.alpha_channels]
    norm = (out[..., self.alpha_channels:self.alpha_channels + self.norm_dim]
            if self.predict_norm else None)
    return sigma, norm

  def query_rgb(self, trunk_out, bottleneck, rgb_condition=None,
                extra_rgb_condition=None, screw_condition=None, norm=None,
                dtype=None, storage_dtype=None):
    def extend(acc, cond):
      if isinstance(cond, (list, tuple)):
        acc.extend(cond)
      else:
        acc.append(cond)
    if rgb_condition is not None:
      rgb_in = [bottleneck]
      extend(rgb_in, rgb_condition)
    else:
      rgb_in = [trunk_out]
    if extra_rgb_condition is not None:
      extend(rgb_in, extra_rgb_condition)
    if screw_condition is not None:
      rgb_in.append(screw_condition)
    if norm is not None:
      rgb_in.append(norm)
    return self.rgb(rgb_in, dtype=dtype, storage_dtype=storage_dtype)

  def trunk_weights(self) -> TrunkWeights:
    """The trunk, head and bottleneck weights in the fused kernel's form."""
    layers = [(self.trunk.hidden(i).kernel, self.trunk.hidden(i).bias)
              for i in range(self.trunk.depth)]
    head = (self.alpha.logit.kernel, self.alpha.logit.bias)
    bn = ((self.bottleneck.kernel, self.bottleneck.bias)
          if self.bottleneck is not None else None)
    return TrunkWeights(layers=layers, head=head, bottleneck=bn)
