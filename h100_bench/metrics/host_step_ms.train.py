"""host_step_ms.train: the host's duration of the program's
``nerfds.train.step`` span, a step, in ms: how long the host takes to
enqueue one step, the profiler's cost included (compare it with the busy
ms of a step)."""
from h100_bench import spans


def read(view):
  return spans.per_unit(view, 'train', ['nerfds.train.step'], host=True)
