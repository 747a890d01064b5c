"""device_idle_share.train: the share of the traced window in which no
kernel, copy or memset ran on the card, in %."""


def read(view):
  if view.kind != 'train' or view.trace.busy_s <= 0:
    return None
  return 100.0 * (1.0 - view.trace.busy_s / view.trace.window_s)
