"""mfu.render: the model FLOPs of the frames in the traced window (the
forward, ``yardstick.render_flops_per_ray`` × rays) over the window's
seconds × the H100's float32 peak, in %."""
from h100_bench import yardstick


def read(view):
  if view.kind != 'render' or view.trace.busy_s <= 0:
    return None
  flops = yardstick.render_flops_per_ray(view.model_cfg) * view.rays
  return 100.0 * flops / (view.trace.window_s
                          * yardstick.PEAK_F32_FLOP_PER_S)
