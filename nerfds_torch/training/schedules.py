"""Annealing schedules (L4), counterpart of ``nerfds_tpu/training/schedules.py``.

Seven schedule types, each a function of the step that returns a float32
0-d tensor; the step function evaluates them on the host once per step
(``training/step.py:eval_schedules``). A schedule config is any of:

  * None                          -> constant 0.0
  * a number                      -> constant
  * ('linear', a, b, n) tuples    -> positional args of the named type
  * {'type': 'linear', ...} dicts -> keyword args of the named type
"""
from __future__ import annotations

import math
from typing import Any, Callable, Sequence

import torch

ScheduleFn = Callable[[Any], torch.Tensor]


def _f32(step) -> torch.Tensor:
  return torch.as_tensor(step, dtype=torch.float32)


def constant(value) -> ScheduleFn:
  def get(step):
    return torch.full_like(_f32(step), value)
  return get


def linear(initial_value, final_value, num_steps) -> ScheduleFn:
  def get(step):
    step = _f32(step)
    if num_steps == 0:
      return torch.full_like(step, final_value)
    alpha = torch.clamp(step / num_steps, max=1.0)
    return (1.0 - alpha) * initial_value + alpha * final_value
  return get


def exponential(initial_value, final_value, num_steps,
                eps=1e-10) -> ScheduleFn:
  if initial_value <= final_value:
    raise ValueError('Final value must be less than initial value.')

  def get(step):
    step = _f32(step)
    final = max(final_value, eps)
    base = torch.tensor(final / initial_value, dtype=torch.float32)
    value = initial_value * base ** (step / (num_steps - 1))
    return torch.where(step >= num_steps, torch.full_like(step, final_value),
                       value)
  return get


def cosine_easing(initial_value, final_value, num_steps) -> ScheduleFn:
  def get(step):
    step = _f32(step)
    x = torch.clamp(torch.clamp(step / num_steps, max=1.0), 0.0, 1.0)
    scale = final_value - initial_value
    return initial_value + scale * 0.5 * (1 + torch.cos(math.pi * x
                                                        + math.pi))
  return get


def step_schedule(initial_value, decay_interval, decay_factor, max_decays,
                  final_value=None) -> ScheduleFn:
  if final_value is None:
    final_value = initial_value * decay_factor ** max_decays

  def get(step):
    step = _f32(step)
    phase = torch.floor(step / decay_interval)
    value = initial_value * torch.tensor(decay_factor,
                                         dtype=torch.float32) ** phase
    return torch.where(phase >= max_decays,
                       torch.full_like(step, final_value), value)
  return get


def piecewise(schedules: Sequence) -> ScheduleFn:
  """A chain of (duration, sub-schedule config) entries: the milestones are
  the cumulative durations, and the active segment is evaluated at the step
  less its start."""
  fns = [from_config(cfg) for _, cfg in schedules]
  milestones, acc = [], 0
  for duration, _ in schedules[:-1]:
    acc += duration
    milestones.append(acc)
  starts = [0] + milestones

  def get(step):
    step = _f32(step)
    idx = torch.searchsorted(torch.tensor(milestones, dtype=torch.float32),
                             step.reshape(1), right=True)[0]
    values = torch.stack([fn(step - start)
                          for fn, start in zip(fns, starts)])
    return values[idx]
  return get


def delayed(base_schedule, delay_steps, delay_mult) -> ScheduleFn:
  base = from_config(base_schedule)

  def get(step):
    step = _f32(step)
    delay_rate = delay_mult + (1 - delay_mult) * torch.sin(
        0.5 * math.pi * torch.clamp(step / delay_steps, 0, 1))
    return delay_rate * base(step)
  return get


_SCHEDULE_MAP = {
    'constant': constant,
    'linear': linear,
    'exponential': exponential,
    'cosine_easing': cosine_easing,
    'step': step_schedule,
    'piecewise': piecewise,
    'delayed': delayed,
}


def from_config(config: Any) -> ScheduleFn:
  """Builds a schedule function from a reference-style config."""
  if config is None:
    return constant(0.0)
  if callable(config):
    return config
  if isinstance(config, (int, float)):
    return constant(float(config))
  if isinstance(config, (tuple, list)):
    schedule_type, *args = config
    return _SCHEDULE_MAP[schedule_type](*args)
  if isinstance(config, dict):
    d = dict(config)
    schedule_type = d.pop('type')
    return _SCHEDULE_MAP[schedule_type](**d)
  raise ValueError(f'Unknown schedule config {config!r}.')
