"""Rematerialisation of the σ path (``remat_sigma``, ``remat_feat``),
counterpart of the JAX package's ``jax.checkpoint`` with the policies
``nothing_saveable`` ('nothing') and ``checkpoint_dots_with_no_batch_dims``
('dots').

Both run ``torch.utils.checkpoint`` without reentry, which supports the
second-order backward that ∇σ's loss takes. 'dots' keeps the outputs of the
forward's plain matrix products (``aten.mm`` and ``aten.addmm``, the dense
layers of ``models/mlp.py``; a region that takes its own ∇σ keeps none of
that first-order backward's) and recomputes the rest. PyTorch's own
selective checkpoint serves each kept output to one backward only, and a
region under the ∇σ loss may be recomputed more than once, so 'dots' keeps
the outputs in two dispatch modes of its own that serve them to every
recomputation.

The recomputation runs after the forward has returned, and so outside a
``torch.func.functional_call`` that ran the forward on a parameter dict
(the training step): :func:`remat` binds the module's parameters as the
forward saw them and recomputes under them.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, Tuple

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

REMAT_POLICIES = ('nothing', 'dots')
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

Store = Dict[Tuple[object, int], torch.Tensor]


class _KeepDots(TorchDispatchMode):
  """The forward: keeps each product's output, by op and call index, where
  no autograd node is running (the forward's own products)."""

  def __init__(self, store: Store):
    super().__init__()
    self.store = store
    self.count = collections.Counter()

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    out = func(*args, **(kwargs or {}))
    if func in _DOTS:
      if torch._C._current_autograd_node() is None:
        self.store[(func, self.count[func])] = out.detach()
      self.count[func] += 1
    return out


class _ServeDots(TorchDispatchMode):
  """A recomputation: serves the kept products, recomputes the rest. It
  replays the forward's ops in their order, so the call indices match."""

  def __init__(self, store: Store):
    super().__init__()
    self.store = store
    self.count = collections.Counter()

  def __enter__(self):
    self.count.clear()
    return super().__enter__()

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    if func in _DOTS:
      key = (func, self.count[func])
      self.count[func] += 1
      if key in self.store:
        return self.store[key]
    return func(*args, **(kwargs or {}))


def _dots_contexts():
  store: Store = {}
  return _KeepDots(store), _ServeDots(store)


def remat(fn: Callable, policy: str, module: nn.Module) -> Callable:
  """``fn(p)`` that keeps, of its activations, only what ``policy`` names
  and recomputes the rest in the backward. Without grad mode it is ``fn``
  itself. ``module``: the module whose parameters ``fn`` reads; the
  recomputation reads the tensors that stood for them in the forward. Its
  ``forward`` must take ``method='_run'`` to call ``_run(fn, p)``."""
  if policy not in REMAT_POLICIES:
    raise ValueError(f'remat_policy={policy!r} is not supported; expected '
                     f'one of {sorted(REMAT_POLICIES)}')
  kw = dict(use_reentrant=False, preserve_rng_state=False)
  if policy == 'dots':
    kw['context_fn'] = _dots_contexts

  def wrapped(p):
    if not torch.is_grad_enabled():
      return fn(p)
    bound = dict(module.named_parameters())
    return checkpoint(lambda x: torch.func.functional_call(
        module, bound, (fn, x), {'method': '_run'}), p, **kw)

  return wrapped
