"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.

A wrapper takes the plain version only for tensors on the CPU; a CUDA
tensor goes to the kernel or the wrapper raises. Each wrapper adds one to
its entry of ``launch_counts`` where it launches its kernel, so a run can
show that a path really went through the kernels.
"""
from typing import Dict

import torch

# The trunk kernels' bf16-operand instantiations count apart from their
# float32 ones. 'fused_mlp_fwd_prefetched_layers' counts no launch: K3's
# wrapper adds the layers of each launch whose bias the kernel stages into
# shared memory ahead of their epilogue (fused_mlp.prefetched_layers).
launch_counts: Dict[str, int] = {
    'composite_fwd': 0, 'fused_trunk_fwd': 0, 'fused_trunk_bwd': 0,
    'fused_trunk_fwd_bf16': 0, 'fused_trunk_bwd_bf16': 0,
    'fused_mlp_fwd': 0, 'fused_mlp_fwd_prefetched_layers': 0}


def reset_launch_counts() -> None:
  for name in launch_counts:
    launch_counts[name] = 0


def pad_columns(t: torch.Tensor, cols: int) -> torch.Tensor:
  """A contiguous copy of ``t`` with zero columns (last dimension) up to
  ``cols``: the 16-byte rows and padded widths the kernels copy."""
  out = t.new_zeros(*t.shape[:-1], cols)
  out[..., :t.shape[-1]] = t
  return out
