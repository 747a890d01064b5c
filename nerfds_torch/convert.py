"""Parameter conversion between the JAX package's param tree and the port.

The JAX package keeps parameters as a nested dict (``nerf/fine/trunk/
hidden_0/kernel``); the port's modules use the same names and the same
``[in, out]`` layout, so a state dict is that tree flattened with ``.``::

  model.load_state_dict(params_from_jax(jax.device_get(params)))

Neither function imports JAX: the tree holds numpy arrays.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


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
