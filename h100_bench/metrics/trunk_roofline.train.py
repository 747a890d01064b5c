"""trunk_roofline.train: the least time of K1f and K1b at every launch of
the traced steps (``yardstick.trunk_fwd_bound`` and ``trunk_bwd_bound`` at
each level's N) over their device time in the trace, in %. The kernels are
found by the names their float32 builds have in the trace."""
from h100_bench import yardstick
from h100_bench.metrics_common import k1b, k1f


def read(view):
  if view.kind != 'train' or not view.trunk_rows:
    return None
  device_s = view.trace.device_s(k1f) + view.trace.device_s(k1b)
  if device_s <= 0:
    return None
  spec = yardstick.trunk_spec(view.model_cfg)
  least = view.units * sum(yardstick.trunk_fwd_bound(spec, n)[0]
                           + yardstick.trunk_bwd_bound(spec, n)[0]
                           for n in view.trunk_rows)
  return 100.0 * least / device_s
