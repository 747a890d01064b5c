"""Multi-process initialisation (L6), counterpart of
``nerfds_tpu/parallel/distributed.py``.

One process per device over ``torch.distributed``. Set up is one explicit
call before the mesh is made:

    from nerfds_torch.parallel import distributed
    distributed.initialize()           # a no-op for one process
    mesh = parallel.create_mesh()      # this rank, the world, its device

``python -m torch.distributed.run --nproc_per_node N ...`` (torchrun)
gives each process ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``; :func:`initialize` reads them. What
stays with each process: its share of the ray store
(``DataSource.build_ray_store(process_local=True)``), and, on rank 0
alone, the writes of checkpoints, summaries and experiment files
(:func:`is_main_process`).
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None) -> bool:
  """Joins the process group when the job has more than one process;
  True if this call joined it.

  Arguments left None come from torchrun's environment (``WORLD_SIZE``,
  ``RANK``; ``init_method`` defaults to ``env://``, which reads
  ``MASTER_ADDR`` and ``MASTER_PORT``). A no-op when that describes one
  process, or when the group is already joined. ``backend``: 'nccl' where
  CUDA is available, else 'gloo'; pass 'gloo' for ranks that train on the
  CPU, or that share one card (NCCL refuses two ranks on one device).
  """
  if world_size is None:
    world_size = int(os.environ.get('WORLD_SIZE', '1'))
  if rank is None:
    rank = int(os.environ.get('RANK', '0'))
  if world_size <= 1 or dist.is_initialized():
    return False
  if backend is None:
    backend = 'nccl' if torch.cuda.is_available() else 'gloo'
  if backend == 'nccl':
    torch.cuda.set_device(local_rank())
  dist.init_process_group(backend, init_method=init_method or 'env://',
                          world_size=world_size, rank=rank)
  return True


def process_count() -> int:
  return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
  return dist.get_rank() if dist.is_initialized() else 0


def local_rank() -> int:
  """This process's index on its machine (torchrun's ``LOCAL_RANK``)."""
  return int(os.environ.get('LOCAL_RANK', '0'))


def is_main_process() -> bool:
  return process_index() == 0


def barrier() -> None:
  """Waits for every rank; a no-op for one process."""
  if process_count() > 1:
    dist.barrier()


def local_shard_slice(total: int) -> Tuple[int, int]:
  """The [start, stop) range of a length-``total`` axis that this process
  owns (its items of the ray store); the last process takes the
  remainder."""
  n = process_count()
  i = process_index()
  per = total // n
  start = i * per
  stop = total if i == n - 1 else start + per
  return start, stop
