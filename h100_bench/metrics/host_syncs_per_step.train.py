"""host_syncs_per_step.train: the runtime calls inside the traced steps
that made the host wait for the card (``trace.SYNC_CALLS``), a step."""


def read(view):
  if view.kind != 'train' or view.trace.busy_s <= 0:
    return None
  return view.trace.host_waits() / view.units
