"""forward_ms.train: the device interval of the program's
``nerfds.train.forward`` span (the model's two levels), a step, in ms."""
from h100_bench import spans


def read(view):
  return spans.per_unit(view, 'train', ['nerfds.train.forward'])
