"""Checkpoint save and restore (L4), counterpart of
``nerfds_tpu/training/checkpoints.py``.

A rolling set of the newest ``keep`` checkpoints of a ``TrainState``: the
step, the parameters under their JAX names (the param tree's path joined
with ``.``, as the port's state dicts name them) and Adam's count and
moments. The format is the port's own: one ``torch.save`` file a step,
``ckpt_<step>.pt``, written to a temporary name in the same directory and
then moved into place with ``os.replace``, so a reader never sees half a
file. Restore maps every tensor onto the template's device.
"""
from __future__ import annotations

import os
import re
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from nerfds_torch.training.step import AdamState, TrainState

_NAME = re.compile(r'^ckpt_(\d+)\.pt$')


def _cpu(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
  return {k: v.detach().cpu() for k, v in tensors.items()}


class CheckpointManager:
  """Rolling checkpoints of a ``TrainState`` in ``directory``."""

  def __init__(self, directory, keep: int = 2):
    self._dir = Path(directory).absolute()
    self._dir.mkdir(parents=True, exist_ok=True)
    self._keep = keep

  def path(self, step: int) -> Path:
    return self._dir / f'ckpt_{step}.pt'

  def all_steps(self) -> List[int]:
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(
        self._dir)) if m)

  def latest_step(self) -> Optional[int]:
    steps = self.all_steps()
    return steps[-1] if steps else None

  def save(self, step: int, state: TrainState) -> None:
    opt = state.opt_state
    payload = {'step': int(state.step), 'params': _cpu(state.params),
               'opt_state': {'count': int(opt.count), 'mu': _cpu(opt.mu),
                             'nu': _cpu(opt.nu)}}
    fd, tmp = tempfile.mkstemp(dir=self._dir, suffix='.tmp')
    try:
      with os.fdopen(fd, 'wb') as f:
        torch.save(payload, f)
      os.replace(tmp, self.path(step))
    except BaseException:
      if os.path.exists(tmp):
        os.unlink(tmp)
      raise
    for old in self.all_steps()[:-self._keep]:
      self.path(old).unlink()

  def restore(self, state_template: TrainState, step: Optional[int] = None
              ) -> Tuple[TrainState, int]:
    """(the state at ``step``, or the latest, on the template's device;
    step), or (the template, 0) when there is no checkpoint."""
    if step is None:
      step = self.latest_step()
    if step is None:
      return state_template, 0
    payload = torch.load(self.path(step), map_location='cpu',
                         weights_only=True)

    def like(saved: Dict[str, torch.Tensor],
             template: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
      if saved.keys() != template.keys():
        raise ValueError(
            f'checkpoint {self.path(step)} does not match the template: '
            f'{sorted(saved.keys() ^ template.keys())[:8]}')
      return {k: saved[k].to(device=v.device, dtype=v.dtype)
              for k, v in template.items()}

    opt, topt = payload['opt_state'], state_template.opt_state
    return TrainState(
        step=int(payload['step']),
        params=like(payload['params'], state_template.params),
        opt_state=AdamState(count=int(opt['count']),
                            mu=like(opt['mu'], topt.mu),
                            nu=like(opt['nu'], topt.nu))), step

  def close(self) -> None:
    """Nothing to release: every save is complete when it returns."""
