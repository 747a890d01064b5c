"""MLP core (L3), counterpart of ``nerfds_tpu/models/mlp.py``.

Weights keep the JAX package's layout: every dense layer holds a
``kernel [in, out]`` and a ``bias [out]`` under the same names
(``hidden_i``, ``logit``, ``bottleneck``, ...), so the state dict of a module
is the JAX param tree with ``.`` for ``/`` (see ``nerfds_torch/convert.py``)
and the kernels read the same layout.

A dense layer may take a list of feature blocks: the list stands for their
concatenation, and each block multiplies its own rows of the kernel
(``concat([a, b]) @ W == a @ W[:da] + b @ W[da:]``), as in the JAX package.
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


def dense_apply(dense: Dense, x: Blocks) -> torch.Tensor:
  """Dense layer over a tensor or a list of feature blocks."""
  if isinstance(x, (list, tuple)):
    y, offset = None, 0
    for part in x:
      d = part.shape[-1]
      contrib = part @ dense.kernel[offset:offset + d]
      y = contrib if y is None else y + contrib
      offset += d
    if offset != dense.kernel.shape[0]:
      raise ValueError(f'feature blocks sum to {offset}, kernel rows '
                       f'{dense.kernel.shape[0]}')
  else:
    y = x @ dense.kernel
  if dense.bias is not None:
    y = y + dense.bias
  return y


class MLP(nn.Module):
  """Dense stack with input re-feed skips and an optional output layer.

  At a skip layer the input is ``[h, inputs]``, in that order.
  """

  def __init__(self, in_dim: int, depth: int, width: int,
               skips: Tuple[int, ...] = (), hidden_activation: str = 'relu',
               output_channels: int = 0,
               output_activation: Optional[str] = None,
               use_bias: bool = True, hidden_init: Init = glorot_uniform,
               output_init: Optional[Init] = None, generator=None):
    super().__init__()
    self.in_dim = in_dim
    self.depth, self.width, self.skips = depth, width, tuple(skips)
    self.hidden_activation = hidden_activation
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

  def forward(self, x: Blocks) -> torch.Tensor:
    act = get_activation(self.hidden_activation)
    inputs = list(x) if isinstance(x, (list, tuple)) else [x]
    h = None
    for i in range(self.depth):
      layer_in = inputs if i == 0 else [h]
      if i in self.skips:
        layer_in = layer_in + inputs
      h = act(dense_apply(self.hidden(i), layer_in))
    out = h if self.depth > 0 else inputs
    if self.output_channels > 0:
      out = dense_apply(self.logit, out)
      if self.output_activation is not None:
        out = get_activation(self.output_activation)(out)
    if isinstance(out, list):  # depth 0 and no output layer: identity
      out = out[0] if len(out) == 1 else torch.cat(out, -1)
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
               norm_dim: int = 3, generator=None):
    super().__init__()
    self.trunk_width = trunk_width
    self.alpha_channels = alpha_channels
    self.activation = activation
    self.skips = tuple(skips)
    self.predict_norm = predict_norm
    self.norm_dim = norm_dim
    self.trunk = MLP(in_dim, trunk_depth, trunk_width, skips, activation,
                     generator=generator)
    self.bottleneck = (Dense(trunk_width, trunk_width, generator=generator)
                       if has_condition else None)
    alpha_in = trunk_width + alpha_cond_dim
    self.alpha = MLP(alpha_in, 0, 0, output_channels=(
        alpha_channels + (norm_dim if predict_norm else 0)),
        generator=generator)
    self.rgb = MLP(trunk_width + rgb_cond_dim, rgb_branch_depth,
                   rgb_branch_width, hidden_activation=activation,
                   output_channels=rgb_channels, generator=generator)

  def query_bottleneck(self, x: Blocks):
    trunk_out = self.trunk(x)
    bottleneck = (dense_apply(self.bottleneck, trunk_out)
                  if self.bottleneck is not None else trunk_out)
    return trunk_out, bottleneck

  def query_sigma(self, trunk_out, bottleneck, alpha_condition=None):
    alpha_in = ([bottleneck, alpha_condition] if alpha_condition is not None
                else trunk_out)
    out = self.alpha(alpha_in)
    sigma = out[..., :self.alpha_channels]
    norm = (out[..., self.alpha_channels:self.alpha_channels + self.norm_dim]
            if self.predict_norm else None)
    return sigma, norm

  def query_rgb(self, trunk_out, bottleneck, rgb_condition=None,
                extra_rgb_condition=None, screw_condition=None, norm=None):
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
    return self.rgb(rgb_in)

  def trunk_weights(self) -> TrunkWeights:
    """The trunk, head and bottleneck weights in the fused kernel's form."""
    layers = [(self.trunk.hidden(i).kernel, self.trunk.hidden(i).bias)
              for i in range(self.trunk.depth)]
    head = (self.alpha.logit.kernel, self.alpha.logit.bias)
    bn = ((self.bottleneck.kernel, self.bottleneck.bias)
          if self.bottleneck is not None else None)
    return TrunkWeights(layers=layers, head=head, bottleneck=bn)
