"""gather_ms.train: the device interval of the program's
``nerfds.train.gather`` span (the minibatch drawn from the device store),
a step, in ms."""
from h100_bench import spans


def read(view):
  return spans.per_unit(view, 'train', ['nerfds.train.gather'])
