"""trunk_ms_per_chunk.render: the device intervals of the program's
``nerfds.model.trunk`` spans (the NeRF trunk and the posencs of its input,
both levels), a chunk, in ms."""
from h100_bench import spans


def read(view):
  return spans.per_unit(view, 'render', ['nerfds.model.trunk'])
