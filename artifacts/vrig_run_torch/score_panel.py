"""Scores the GT | prediction halves of eval panels with the port's image
metrics on the CPU.

  python artifacts/vrig_run_torch/score_panel.py \\
      artifacts/vrig_run/panels/eval_val_right_0000.png \\
      artifacts/vrig_run_torch/panels/eval_val_right_0000.png

An eval panel (``python -m nerfds_torch.eval --save_images``, or the JAX
package's eval script) is the ground truth, the prediction and the depth
side by side, each ``H`` wide, as 8-bit PNG. This prints PSNR, SSIM and
MS-SSIM of the middle third against the first, so that a run's recorded
metrics can be set beside the same metrics computed again on the CPU
(``evaluation/metrics.py``, which the tests hold to the JAX package's).
"""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def score(path):
  from nerfds_torch.evaluation import metrics
  from nerfds_torch.image_utils import image_to_float32, load_image
  panel = image_to_float32(load_image(path))[..., :3]
  size = panel.shape[0]
  return metrics.compute_all(panel[:, size:2 * size], panel[:, :size],
                             device='cpu')


if __name__ == '__main__':
  for arg in sys.argv[1:]:
    print(arg, json.dumps(score(arg)))
