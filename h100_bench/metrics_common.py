"""Kernel names as the profiler's trace gives them, for the per-layer
readers: the float32 builds of K1f and K1b (``nerfds_torch/kernels/csrc``)."""

K1B_KERNELS = ('trunk_bwd_sweep_kernel', 'trunk_wgrad_kernel',
               'trunk_wgrad_reduce_kernel')


def k1f(name: str) -> bool:
  return 'fused_trunk_fwd_kernel' in name and 'bf16' not in name


def k1b(name: str) -> bool:
  return 'bf16' not in name and any(k in name for k in K1B_KERNELS)
