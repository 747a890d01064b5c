"""Time-indexed voxel grid of surface normals (L3), counterpart of
``nerfds_tpu/models/norm_voxels.py``.

A ``(T, X, Y, Z, 3)`` grid with trilinear interpolation and an EMA-style
update weighted by occupancy and interpolation distance. No model path
calls it, in either package. The update is functional, as in the JAX
package: :meth:`NormVoxels.lookup_and_update` returns the new grid and
leaves the parameter as it was.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from nerfds_torch.ops.math import get_trilinear_coefficient

# Which of (min, max) each of the 8 vertices takes along x, y and z.
_VERTEX_CHOICE = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
                  (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1))


class NormVoxels(nn.Module):
  """``voxel_array`` ``[T, X, Y, Z, 3]``, every normal sqrt(1/3) at init."""

  def __init__(self, voxel_shape: Tuple[int, int, int, int],
               range_min: Tuple[float, float, float] = (-1.5, -1.5, -1.5),
               range_max: Tuple[float, float, float] = (1.5, 1.5, 1.5)):
    super().__init__()
    self.voxel_shape = tuple(voxel_shape)
    self.range_min, self.range_max = tuple(range_min), tuple(range_max)
    self.voxel_array = nn.Parameter(
        torch.full((*self.voxel_shape, 3), math.sqrt(1.0 / 3.0)))

  def _lo_steps(self, like: torch.Tensor):
    lo = torch.tensor(self.range_min, dtype=torch.float32, device=like.device)
    hi = torch.tensor(self.range_max, dtype=torch.float32, device=like.device)
    dims = torch.tensor(self.voxel_shape[1:], dtype=torch.float32,
                        device=like.device)
    return lo, (hi - lo) / dims

  def vertex_indices(self, t: torch.Tensor, pos: torch.Tensor
                     ) -> torch.Tensor:
    """``t [N]`` integer, ``pos [N, 3]`` -> ``[N, 8, 4]`` (t, x, y, z)
    vertex indices, in :func:`get_trilinear_coefficient`'s vertex order."""
    lo, steps = self._lo_steps(pos)
    mins = torch.floor((pos - lo) / steps).long()                 # N, 3
    maxs = mins + 1
    dims = torch.tensor(self.voxel_shape[1:], device=pos.device)
    mins = torch.minimum(mins.clamp(min=0), dims - 1)
    maxs = torch.minimum(maxs.clamp(min=0), dims - 1)
    choose = torch.tensor(_VERTEX_CHOICE, device=pos.device)
    xyz = torch.where(choose[None] == 1, maxs[:, None, :], mins[:, None, :])
    t_idx = t.long()[:, None, None].expand(*xyz.shape[:2], 1)
    return torch.cat([t_idx, xyz], -1)

  def interpolation_coef(self, pos: torch.Tensor) -> torch.Tensor:
    lo, steps = self._lo_steps(pos)
    local = torch.remainder(pos - lo, steps) / steps
    return get_trilinear_coefficient(local)

  def _gather(self, grid: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return grid[idx[..., 0], idx[..., 1], idx[..., 2], idx[..., 3]]

  def lookup(self, t: torch.Tensor, pos: torch.Tensor):
    """Trilinearly interpolated normals at (t, pos): ``[N, 3]``, with the
    vertices' values ``[N, 8, 3]`` and their weights ``[N, 8]``."""
    coef = self.interpolation_coef(pos)
    values = self._gather(self.voxel_array, self.vertex_indices(t, pos))
    return (coef[..., None] * values).sum(1), values, coef

  def lookup_and_update(self, t: torch.Tensor, pos: torch.Tensor, lr,
                        sigma: torch.Tensor, target_norm: torch.Tensor
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Interpolates, and moves every vertex toward ``target_norm`` by
    sigmoid(lr · (1 − e^{−σ}) · its trilinear weight). Returns (value,
    ``{'voxel_array': new grid}``); repeated vertices add their moves."""
    coef = self.interpolation_coef(pos)
    idx = self.vertex_indices(t, pos)
    grid = self.voxel_array
    values = self._gather(grid, idx)
    value = (coef[..., None] * values).sum(1)
    target = target_norm[:, None, :].expand(values.shape)
    sigma_weight = (1.0 - torch.exp(-sigma))[:, None]
    update_lambda = torch.sigmoid(lr * sigma_weight * coef)[..., None]
    new_values = update_lambda * target + (1.0 - update_lambda) * values
    diff = (new_values - values).reshape(-1, 3)
    flat = idx.reshape(-1, 4)
    new_grid = grid.index_put((flat[:, 0], flat[:, 1], flat[:, 2],
                               flat[:, 3]), diff, accumulate=True)
    return value, {'voxel_array': new_grid}
