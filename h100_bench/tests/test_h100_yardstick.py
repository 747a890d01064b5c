"""The frozen yardstick: the kernels' least times against the figures of
PERF.md's kernel table, and the FLOP counter against a count by hand."""
import pytest

from h100_bench import yardstick
from h100_bench.tests import toy_cells

NERF_DS = toy_cells.harness.load_json(
    toy_cells.harness.HERE / 'configs' / 'nerf_ds.json')['model']
HYPERNERF = toy_cells.harness.load_json(
    toy_cells.harness.HERE / 'configs' / 'hypernerf.json')['model']


@pytest.mark.parametrize('n, ms', [(65536, 2.03), (524288, 16.23)])
def test_k1f_bound(n, ms):
  spec = yardstick.trunk_spec(NERF_DS)
  seconds, by = yardstick.trunk_fwd_bound(spec, n)
  assert by == 'operations'
  assert round(1e3 * seconds, 2) == ms


def test_k1b_bound():
  seconds, by = yardstick.trunk_bwd_bound(yardstick.trunk_spec(NERF_DS),
                                          65536)
  assert (round(1e3 * seconds, 2), by) == (5.91, 'operations')


def test_k2_bound():
  seconds, by = yardstick.composite_bound(4096, 128)
  assert (round(1e6 * seconds, 2), by) == (5.05, 'bytes')


def test_trunk_spec_of_nerf_ds():
  assert yardstick.trunk_spec(NERF_DS) == yardstick.TrunkSpec(
      depth=8, width=256, skips=(4,), in_dim=52, alpha_channels=1,
      norm_dim=3, has_bottleneck=True)


# By hand, one point's multiply-adds (input widths: posencs of 2 sin/cos
# per channel and band, the embeddings, the mask channel).
NERF_DS_MACS = {
    'mask': 44 * 128 + 7 * 128 * 128 + 44 * 128 + 128 * 1,      # 44 = 36 + 8
    'warp': 33 * 128 + 5 * 128 * 128 + 33 * 128 + 2 * 128 * 3,  # 24 + 8 + 1
    'hyper': 45 * 64 + 5 * 64 * 64 + 45 * 64 + 64 * 2,          # 36 + 8 + 1
    'trunk': 52 * 256 + 7 * 256 * 256 + 52 * 256,               # 48 + 4
    'bottleneck': 256 * 256,
    'head': 256 * 4,
    'rgb': 560 * 128 + 128 * 3,               # 256 + 24 + 256 + 24
}
HYPERNERF_MACS = {
    'warp': 56 * 128 + 5 * 128 * 128 + 56 * 128 + 2 * 128 * 3,  # 48 + 8
    'hyper': 44 * 64 + 5 * 64 * 64 + 44 * 64 + 64 * 2,          # 36 + 8
    'trunk': 52 * 256 + 7 * 256 * 256 + 52 * 256,
    'bottleneck': 256 * 256,
    'head': 256 * 1,
    'rgb': 280 * 128 + 128 * 3,                                  # 256 + 24
}


@pytest.mark.parametrize('cfg, macs, points, grad', [
    (NERF_DS, NERF_DS_MACS, 64 + 128, 52 * 256 + 7 * 256 * 256 + 52 * 256
     + 256),
    (HYPERNERF, HYPERNERF_MACS, 128 + 256, 0)])
def test_flops_per_ray_by_hand(cfg, macs, points, grad):
  assert yardstick.point_macs(cfg) == macs
  per_point = sum(macs.values()) + grad
  assert yardstick.train_flops_per_ray(cfg) == points * 6 * per_point
  assert yardstick.render_flops_per_ray(cfg) == points * 2 * sum(
      macs.values())
