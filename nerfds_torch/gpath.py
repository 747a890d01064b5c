"""Paths of data and experiment directories, counterpart of
``nerfds_tpu/gpath.py``.

The JAX package returns an ``etils.epath.Path`` where etils imports, so
that ``gs://`` directories read like local ones, and a ``pathlib.Path``
otherwise. The port has no remote reader: :func:`GPath` gives a
``pathlib.Path`` and raises ValueError, naming the path, for a remote one.
Every file the port reads or writes by a caller's path goes through it.
"""
from __future__ import annotations

import pathlib


def is_remote(path) -> bool:
  s = str(path)
  return '://' in s or s.startswith('gs:')


def GPath(*parts) -> pathlib.Path:  # noqa: N802 - the JAX package's name
  """``pathlib.Path(*parts)``; raises ValueError for a remote path."""
  path = pathlib.Path(*parts)
  for part in parts:
    if is_remote(part):
      raise ValueError(f'{str(part)!r}: only local paths are supported')
  return path
