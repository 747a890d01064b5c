"""adam_ms.train: the device interval of the program's
``nerfds.train.adam`` span (freeze, clip, Adam and the parameter update),
a step, in ms."""
from h100_bench import spans


def read(view):
  return spans.per_unit(view, 'train', ['nerfds.train.adam'])
