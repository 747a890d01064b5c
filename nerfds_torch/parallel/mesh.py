"""The data mesh and its collectives (L6), counterpart of
``nerfds_tpu/parallel/mesh.py``.

The JAX package shards ray batches over a ``'data'`` mesh axis and lets
the partitioner insert the gradient all-reduce. Here each rank is one
process with one device: it takes its contiguous rows of the global batch
(:func:`shard_batch`), computes its gradients, and the step averages them
with one explicit collective (:func:`all_reduce_mean`). Parameters and
optimizer state are replicated: every rank starts from rank 0's
parameters (:func:`broadcast`) and applies the same update.

``DistributedDataParallel`` is not used: the step takes its gradients with
``torch.autograd.grad`` on detached leaves inside ``functional_call``, so
DDP's parameter hooks would never fire.

Gloo reduces and broadcasts CUDA tensors but does not all-gather them, so
:func:`all_gather_rows` sums zero-padded slots with an all-reduce, a form
that both gloo and NCCL take. ``ReduceOp.AVG`` exists only on NCCL: the
mean is a sum divided by the world size, which at one rank is exact.
At world size 1 no process group is needed and no collective runs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from nerfds_torch.device import resolve_device
from nerfds_torch.parallel import distributed

DATA_AXIS = 'data'  # the mesh's one axis: the ranks split the batch's rows


@dataclasses.dataclass(frozen=True)
class DataMesh:
  """This rank, the number of ranks, this rank's device, and the process
  group (None at world size 1)."""
  rank: int
  world_size: int
  device: torch.device
  group: Optional[Any] = None


def create_mesh(device=None, group=None) -> DataMesh:
  """The 1-D data mesh over every process of the job, or over the ranks of
  ``group`` (a ``torch.distributed.new_group``, called by this process
  only if it belongs to it): every collective of the mesh then runs on
  that group alone, so ranks outside it may wait elsewhere. ``device``:
  this rank's device, ``cuda:{LOCAL_RANK}`` unless the caller passes one."""
  if device is None:
    device = f'cuda:{distributed.local_rank()}'
  if group is not None:
    return DataMesh(rank=dist.get_rank(group),
                    world_size=dist.get_world_size(group),
                    device=resolve_device(device), group=group)
  world = distributed.process_count()
  return DataMesh(rank=distributed.process_index(), world_size=world,
                  device=resolve_device(device),
                  group=dist.group.WORLD if world > 1 else None)


def pad_to_multiple(n: int, multiple: int) -> int:
  return ((n + multiple - 1) // multiple) * multiple


def tree_map(fn, tree):
  """``fn`` on every leaf of a nested dict (or on ``tree`` itself)."""
  if isinstance(tree, dict):
    return {k: tree_map(fn, v) for k, v in tree.items()}
  return fn(tree)


def shard_batch(batch, mesh: DataMesh):
  """This rank's contiguous rows of a global batch (a tensor or a nested
  dict of them); raises ValueError when the rows do not divide by the
  world size."""

  def take(x):
    if x.shape[0] % mesh.world_size:
      raise ValueError(f'{x.shape[0]} rows do not divide over '
                       f'{mesh.world_size} ranks')
    n = x.shape[0] // mesh.world_size
    return x[mesh.rank * n:(mesh.rank + 1) * n]

  return tree_map(take, batch)


def _flat(tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
  dtypes = {t.dtype for t in tensors.values()}
  if len(dtypes) != 1:
    raise ValueError(f'one dtype per collective, got {sorted(map(str, dtypes))}')
  return torch.cat([t.detach().reshape(-1) for t in tensors.values()])


def _unflat(flat: torch.Tensor, like: Dict[str, torch.Tensor]
            ) -> Dict[str, torch.Tensor]:
  parts = torch.split(flat, [t.numel() for t in like.values()])
  return {k: p.view(t.shape) for (k, t), p in zip(like.items(), parts)}


def _all_reduce(tensors: Dict[str, torch.Tensor], mesh: DataMesh, op
                ) -> torch.Tensor:
  flat = _flat(tensors)
  dist.all_reduce(flat, op=op, group=mesh.group)
  return flat


def all_reduce_mean(tensors: Dict[str, torch.Tensor], mesh: Optional[DataMesh]
                    ) -> Dict[str, torch.Tensor]:
  """The mean over the ranks of each tensor of ``tensors`` (one dtype):
  one collective on a flattened buffer, split back into views. At world
  size 1 (or no mesh) the tensors come back as they were."""
  if mesh is None or mesh.world_size == 1 or not tensors:
    return tensors
  flat = _all_reduce(tensors, mesh, dist.ReduceOp.SUM)
  return _unflat(flat.div_(mesh.world_size), tensors)


def all_reduce_max(tensors: Dict[str, torch.Tensor], mesh: Optional[DataMesh]
                   ) -> Dict[str, torch.Tensor]:
  """The largest value over the ranks of each element, as
  :func:`all_reduce_mean` does the mean."""
  if mesh is None or mesh.world_size == 1 or not tensors:
    return tensors
  return _unflat(_all_reduce(tensors, mesh, dist.ReduceOp.MAX), tensors)


def broadcast(tensors: Dict[str, torch.Tensor], mesh: Optional[DataMesh],
              src: int = 0) -> Dict[str, torch.Tensor]:
  """The mesh's rank ``src``'s ``tensors`` (one dtype) on every rank: one
  collective on a flattened buffer, split back into views."""
  if mesh is None or mesh.world_size == 1 or not tensors:
    return tensors
  flat = _flat(tensors)
  dist.broadcast(flat, src=dist.get_global_rank(mesh.group, src),
                 group=mesh.group)
  return _unflat(flat, tensors)


def all_gather_rows(tensor: torch.Tensor, mesh: Optional[DataMesh],
                    counts: Optional[Sequence[int]] = None) -> torch.Tensor:
  """Every rank's rows of ``tensor``, concatenated in rank order, on every
  rank (not differentiable). ``counts``: each rank's row count where they
  differ (default: this tensor's on every rank). The slots are summed by
  an all-reduce (module docstring), so a -0.0 comes back as 0.0."""
  if mesh is None or mesh.world_size == 1:
    return tensor
  if counts is None:
    counts = [tensor.shape[0]] * mesh.world_size
  if counts[mesh.rank] != tensor.shape[0]:
    raise ValueError(f'rank {mesh.rank} holds {tensor.shape[0]} rows, '
                     f'counts say {counts[mesh.rank]}')
  slots = tensor.new_zeros((mesh.world_size, max(counts), *tensor.shape[1:]))
  slots[mesh.rank, :tensor.shape[0]] = tensor.detach()
  dist.all_reduce(slots, group=mesh.group)
  return torch.cat([slots[r, :c] for r, c in enumerate(counts)])


def check_batch_norm(norm_type: Optional[str], mesh: Optional[DataMesh]
                     ) -> None:
  """Raises ValueError for ``norm_type='batch'`` across more than one
  rank. The JAX package's sharded step and render take a 'batch' norm's
  statistics over the global batch; the port's ranks would each take
  their own rows' (ROADMAP.md, queue 3)."""
  if norm_type == 'batch' and mesh is not None and mesh.world_size > 1:
    raise ValueError(
        "norm_type='batch' is not supported across ranks: each rank would "
        'take the statistics of its own rows, not of the global batch')
