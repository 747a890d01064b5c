"""GLO latent-code embeddings (L3), counterpart of
``nerfds_tpu/models/embeddings.py``."""
from __future__ import annotations

import torch
from torch import nn


class GLOEmbed(nn.Module):
  """A table of per-frame latent codes, initialised U[0, init_scale)."""

  def __init__(self, num_embeddings: int, num_dims: int = 8,
               init_scale: float = 0.05, generator=None):
    super().__init__()
    self.embedding = nn.Parameter(torch.empty(num_embeddings, num_dims))
    with torch.no_grad():
      self.embedding.uniform_(0.0, init_scale, generator=generator)

  def lookup(self, ids: torch.Tensor) -> torch.Tensor:
    """ids: integer ``[..., 1]`` or ``[...]``. Out-of-range ids clamp to the
    nearest row (a val frame whose id exceeds the train table)."""
    if ids.dim() > 0 and ids.shape[-1] == 1:
      ids = ids.squeeze(-1)
    ids = ids.long().clamp(0, self.embedding.shape[0] - 1)
    return self.embedding[ids]

  def encode(self, metadata: torch.Tensor) -> torch.Tensor:
    """Encodes an id ``[..., 1]`` or an interpolation triple ``[..., 3]`` of
    (left id, right id, progression)."""
    if metadata.shape[-1] == 3:
      left, right, progression = metadata.split(1, dim=-1)
      left, right = self.lookup(left), self.lookup(right)
      return (1.0 - progression) * left + progression * right
    return self.lookup(metadata)
