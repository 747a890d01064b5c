"""Device choice for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for another device. A
request for ``cuda`` on a machine without a usable card raises: nothing
carries on quietly on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
  """``None`` means ``cuda``; raises if CUDA is asked for but absent."""
  dev = torch.device('cuda' if device is None else device)
  if dev.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(
        'nerfds_torch runs on a CUDA device by default and none is '
        "available; pass device='cpu' to run the plain PyTorch path")
  return dev
