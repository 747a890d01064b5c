"""backward_ms.train: the device interval of the program's
``nerfds.train.backward`` span (the gradients of the loss), a step, in
ms."""
from h100_bench import spans


def read(view):
  return spans.per_unit(view, 'train', ['nerfds.train.backward'])
