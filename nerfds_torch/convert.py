"""Parameter conversion between the JAX package's param tree and the port.

The JAX package keeps parameters as a nested dict (``nerf/fine/trunk/
hidden_0/kernel``); the port's modules use the same names and the same
``[in, out]`` layout, so a state dict is that tree flattened with ``.``::

  model.load_state_dict(params_from_jax(jax.device_get(params)))

``train_state_from_jax`` and ``train_state_to_jax`` do the same for a whole
training state: the step, the params, and optax's
``ScaleByAdamState(count, mu, nu)`` as the port's ``AdamState``.

No function here imports JAX: the trees hold numpy arrays.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from nerfds_torch.training.step import AdamState, TrainState


def params_from_jax(tree: Mapping[str, Any], prefix: str = ''
                    ) -> Dict[str, torch.Tensor]:
  """Nested dict of arrays -> flat state dict of float32 CPU tensors."""
  out: Dict[str, torch.Tensor] = {}
  for key, value in tree.items():
    name = f'{prefix}{key}'
    if isinstance(value, Mapping):
      out.update(params_from_jax(value, prefix=f'{name}.'))
    else:
      out[name] = torch.from_numpy(
          np.array(value, dtype=np.float32, copy=True))
  return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor]
                  ) -> Dict[str, Any]:
  """Flat state dict -> nested dict of float32 numpy arrays."""
  tree: Dict[str, Any] = {}
  for name, value in state_dict.items():
    *path, leaf = name.split('.')
    node = tree
    for key in path:
      node = node.setdefault(key, {})
    node[leaf] = value.detach().cpu().numpy().astype(np.float32)
  return tree


def train_state_from_jax(state) -> TrainState:
  """A JAX ``TrainState`` (after ``jax.device_get``: ``step``, ``params``,
  ``opt_state`` with ``count``, ``mu``, ``nu``) -> the port's, on the CPU."""
  opt = state.opt_state
  return TrainState(
      step=int(np.asarray(state.step)), params=params_from_jax(state.params),
      opt_state=AdamState(count=int(np.asarray(opt.count)),
                          mu=params_from_jax(opt.mu),
                          nu=params_from_jax(opt.nu)))


def train_state_to_jax(state: TrainState) -> Dict[str, Any]:
  """The port's ``TrainState`` -> ``{'step', 'params', 'opt_state':
  {'count', 'mu', 'nu'}}`` of numpy arrays (int32 counters), the fields of
  the JAX ``TrainState`` and ``ScaleByAdamState``."""
  opt = state.opt_state
  return {
      'step': np.asarray(state.step, np.int32),
      'params': params_to_jax(state.params),
      'opt_state': {'count': np.asarray(opt.count, np.int32),
                    'mu': params_to_jax(opt.mu),
                    'nu': params_to_jax(opt.nu)},
  }
