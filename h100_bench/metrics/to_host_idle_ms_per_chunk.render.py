"""to_host_idle_ms_per_chunk.render: the device's idle time in the traced
window (no kernel, copy or memset) while the host was inside the
program's ``nerfds.render.to_host`` or ``nerfds.render.assemble`` spans,
by their events in the profiler's own trace, a chunk, in ms."""
from h100_bench import spans


def read(view):
  if view.kind != 'render' or view.trace.busy_s <= 0:
    return None
  ms = spans.idle_within_ms(view.trace, ['nerfds.render.to_host',
                                         'nerfds.render.assemble'])
  return None if ms is None else ms / view.units
