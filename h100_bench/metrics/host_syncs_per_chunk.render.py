"""host_syncs_per_chunk.render: the runtime calls inside the traced frames
that made the host wait for the card (``trace.SYNC_CALLS``), a chunk."""


def read(view):
  if view.kind != 'render' or view.trace.busy_s <= 0:
    return None
  return view.trace.host_waits() / view.units
