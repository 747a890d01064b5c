"""Image quality metrics (L5), counterpart of
``nerfds_tpu/evaluation/metrics.py``: MSE, PSNR, SSIM and MS-SSIM in
PyTorch, and LPIPS when the ``lpips`` package imports.

SSIM is the Wang et al. 2003 formulation with an 11×11 Gaussian window
(σ = 1.5) applied as two separable ``F.conv2d`` passes with valid padding,
in full float32 (TF32 off). Images are ``[H, W, C]`` arrays or tensors;
tensors are computed where they lie, numpy inputs on the CPU unless
``compute_all`` is given a ``device``.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F


def _tensor(x) -> torch.Tensor:
  if isinstance(x, torch.Tensor):
    return x.float()
  return torch.from_numpy(np.array(x, np.float32))


@contextlib.contextmanager
def _full_float32():
  """cuDNN convolutions without TF32, restored on exit."""
  prev = torch.backends.cudnn.allow_tf32
  torch.backends.cudnn.allow_tf32 = False
  try:
    yield
  finally:
    torch.backends.cudnn.allow_tf32 = prev


def compute_mse(a, b) -> torch.Tensor:
  return ((_tensor(a) - _tensor(b)) ** 2).mean()


def compute_psnr(a, b, max_val: float = 1.0) -> torch.Tensor:
  mse = compute_mse(a, b)
  return (20.0 * torch.log10(torch.tensor(max_val, dtype=torch.float32))
          - 10.0 * torch.log10(mse))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
  x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
  g = torch.exp(-0.5 * (x / sigma) ** 2)
  return g / g.sum()


def _filter2d_separable(img: torch.Tensor, kernel: torch.Tensor
                        ) -> torch.Tensor:
  """Depthwise separable 2D filter, img [H, W, C], valid padding."""
  k = kernel.shape[0]
  x = img.permute(2, 0, 1)[:, None]  # [C, 1, H, W]
  kernel = kernel.to(img.device)
  with _full_float32():
    x = F.conv2d(x, kernel.reshape(1, 1, k, 1))
    x = F.conv2d(x, kernel.reshape(1, 1, 1, k))
  return x[:, 0].permute(1, 2, 0)  # [H', W', C]


def compute_ssim(a, b, max_val: float = 1.0, filter_size: int = 11,
                 filter_sigma: float = 1.5, k1: float = 0.01,
                 k2: float = 0.03, return_map: bool = False):
  """Single-scale SSIM for [H, W, C] float images: (mean SSIM, mean cs),
  or the SSIM map."""
  a, b = _tensor(a), _tensor(b)
  kernel = _gaussian_kernel(filter_size, filter_sigma)
  mu_a = _filter2d_separable(a, kernel)
  mu_b = _filter2d_separable(b, kernel)
  mu_aa = mu_a * mu_a
  mu_bb = mu_b * mu_b
  mu_ab = mu_a * mu_b
  sigma_aa = _filter2d_separable(a * a, kernel) - mu_aa
  sigma_bb = _filter2d_separable(b * b, kernel) - mu_bb
  sigma_ab = _filter2d_separable(a * b, kernel) - mu_ab
  # Cancellation in E[x²]−µ² can give slightly negative variances and
  # covariances beyond the Cauchy–Schwarz bound, which push cs past 1 on
  # near-constant patches; the clamps keep SSIM and MS-SSIM in [−1, 1].
  sigma_aa = torch.clamp(sigma_aa, min=0.0)
  sigma_bb = torch.clamp(sigma_bb, min=0.0)
  bound = torch.sqrt(sigma_aa * sigma_bb)
  sigma_ab = torch.minimum(torch.maximum(sigma_ab, -bound), bound)
  c1 = (k1 * max_val) ** 2
  c2 = (k2 * max_val) ** 2
  luminance = (2 * mu_ab + c1) / (mu_aa + mu_bb + c1)
  cs = (2 * sigma_ab + c2) / (sigma_aa + sigma_bb + c2)
  ssim_map = luminance * cs
  if return_map:
    return ssim_map
  return ssim_map.mean(), cs.mean()


_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _downsample2x(img: torch.Tensor) -> torch.Tensor:
  """2x average-pool downsample, [H, W, C]."""
  h, w, c = img.shape
  h2, w2 = h // 2, w // 2
  img = img[:h2 * 2, :w2 * 2]
  return img.reshape(h2, 2, w2, 2, c).mean(dim=(1, 3))


def compute_msssim(a, b, max_val: float = 1.0) -> torch.Tensor:
  """Multi-scale SSIM (5 scales, the standard weights). Images need
  176×176 for all 5 scales; smaller ones use fewer, with the weights
  renormalised."""
  a, b = _tensor(a), _tensor(b)
  levels = len(_MSSSIM_WEIGHTS)
  min_dim = min(a.shape[0], a.shape[1])
  usable = min(levels, max(1, int(np.floor(np.log2(min_dim / 11))) + 1))
  weights = np.asarray(_MSSSIM_WEIGHTS[:usable])
  weights = (weights / weights.sum()).astype(np.float32)
  mcs = []
  ssim_val = None
  for i in range(usable):
    ssim_val, cs = compute_ssim(a, b, max_val)
    if i < usable - 1:
      mcs.append(torch.clamp(cs, min=0.0))
      a = _downsample2x(a)
      b = _downsample2x(b)
  result = torch.ones((), device=a.device)
  for i, cs in enumerate(mcs):
    result = result * cs ** float(weights[i])
  return result * torch.clamp(ssim_val, min=0.0) ** float(weights[-1])


class LpipsMetric:
  """LPIPS with AlexNet features, as the reference computes it. Building
  one raises ImportError without the ``lpips`` package (its pretrained
  weights cannot be fetched offline)."""

  def __init__(self, net: str = 'alex'):
    import lpips  # optional dependency
    self._model = lpips.LPIPS(net=net)

  @staticmethod
  def prep(x) -> torch.Tensor:
    """[H, W, C] float image in [0, 1] -> [1, C, H, W] tensor in [-1, 1],
    the reference's ``im2tensor`` convention."""
    return _tensor(x).permute(2, 0, 1)[None] * 2.0 - 1.0

  def __call__(self, a, b) -> float:
    with torch.no_grad():
      return float(self._model(self.prep(a), self.prep(b)).item())


def compute_all(pred, target,
                lpips_metric: Optional[LpipsMetric] = None,
                device=None) -> Dict[str, float]:
  """The reference's metric set over one image pair, on ``device`` where
  one is given (LPIPS takes the pair as it came)."""
  pred_t, target_t = _tensor(pred), _tensor(target)
  if device is not None:
    pred_t, target_t = pred_t.to(device), target_t.to(device)
  out = {
      'mse': float(compute_mse(pred_t, target_t)),
      'psnr': float(compute_psnr(pred_t, target_t)),
      'ssim': float(compute_ssim(pred_t, target_t)[0]),
      'ms_ssim': float(compute_msssim(pred_t, target_t)),
  }
  if lpips_metric is not None:
    out['lpips'] = lpips_metric(pred, target)
  return out
