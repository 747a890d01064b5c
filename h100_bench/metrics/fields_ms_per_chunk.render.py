"""fields_ms_per_chunk.render: the device intervals of the program's
``nerfds.model.warp``, ``nerfds.model.hyper`` and ``nerfds.model.mask``
spans (the deformation fields and the mask MLP, both levels), a chunk, in
ms."""
from h100_bench import spans


def read(view):
  return spans.per_unit(view, 'render', ['nerfds.model.warp',
                                         'nerfds.model.hyper',
                                         'nerfds.model.mask'])
