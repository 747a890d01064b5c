"""Faults planted underneath the timed path, to show that the check fails
each of them: the tests (``tests/test_checks.py``) and the readings that
the limits were set from (``calibrate.py``) plant them; the benchmark's
runs never do.

  * ``unchanged`` (train): the step returns its state's parameters and
    Adam state unchanged;
  * ``half_batch`` (train): the step gathers half of its batch and takes
    the loss's mean over those rays;
  * ``trunk_nu`` (train): Adam's second moment four times too large on the
    NeRF trunk's leaves alone (a third of the leaves), so their updates
    are halved and every other leaf's is sound;
  * ``altered_answer`` (render): the compositing hands back each ray's
    colour with its channels turned round;
  * ``half_rows`` (render): the second half of every chunk gets the first
    half's answers.
"""
from __future__ import annotations

import contextlib

TRAIN_FAULTS = ('unchanged', 'half_batch', 'trunk_nu')
RENDER_FAULTS = ('altered_answer', 'half_rows')


@contextlib.contextmanager
def _patched(owner, name, make):
  original = getattr(owner, name)
  setattr(owner, name, make(original))
  try:
    yield
  finally:
    setattr(owner, name, original)


def _unchanged(original):
  from nerfds_torch.training.step import TrainState

  def apply(state, grads, stats, scalars, train_cfg):
    _, stats = original(state, grads, stats, scalars, train_cfg)
    return TrainState(step=state.step + 1, params=state.params,
                      opt_state=state.opt_state), stats
  return apply


def _half_batch(original):
  def sample_batch(store, generator, batch_size):
    batch = original(store, generator, batch_size)
    half = batch_size // 2

    def cut(x):
      return {k: cut(v) for k, v in x.items()} if isinstance(x, dict) \
          else x[:half]
    return cut(batch)
  return sample_batch


def _trunk_nu(original):
  def adam_update(grads, state, *args, **kwargs):
    updates, new = original(grads, state, *args, **kwargs)
    for k in updates:
      if k.startswith('nerf.') and '.trunk.' in k:
        new.nu[k] = 4 * new.nu[k]
        updates[k] = updates[k] / 2
    return updates, new
  return adam_update


def _altered_answer(original):
  def volumetric_rendering(*args, **kwargs):
    out = original(*args, **kwargs)
    out['rgb'] = out['rgb'].flip(-1)
    return out
  return volumetric_rendering


def _half_rows(original):
  def render(self, *args, **kwargs):
    out = original(self, *args, **kwargs)
    for level in out.values():
      for key, v in level.items():
        half = v.shape[0] // 2
        if half:
          level[key] = v.clone()
          level[key][half:2 * half] = v[:half]
    return out
  return render


@contextlib.contextmanager
def plant(fault: str):
  """Plants ``fault`` in the program for the duration."""
  if fault in TRAIN_FAULTS:
    from nerfds_torch.training import step
    target = {'unchanged': (step, '_apply', _unchanged),
              'half_batch': (step, 'sample_batch', _half_batch),
              'trunk_nu': (step, 'adam_update', _trunk_nu)}[fault]
  elif fault == 'altered_answer':
    from nerfds_torch.ops import rendering
    target = (rendering, 'volumetric_rendering', _altered_answer)
  elif fault == 'half_rows':
    from nerfds_torch.models.nerfds import NerfDSModel
    target = (NerfDSModel, 'render', _half_rows)
  else:
    raise ValueError(f'unknown fault {fault!r}')
  with _patched(*target):
    yield
