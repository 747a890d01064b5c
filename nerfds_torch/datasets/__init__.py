"""L2 data layer, counterpart of ``nerfds_tpu/datasets``."""
from nerfds_torch.datasets.core import DataSource, RayStore, sample_batch
from nerfds_torch.datasets.synthetic import SyntheticDataSource

__all__ = ['DataSource', 'RayStore', 'sample_batch', 'SyntheticDataSource',
           'from_config']


def from_config(experiment_config) -> DataSource:
  """The datasource named by an ``ExperimentConfig``. The captured-scene
  sources ('nerfies', 'interp') are not ported yet."""
  cfg = experiment_config
  if cfg.datasource_type in ('nerfies', 'interp'):
    raise NotImplementedError(
        f'datasource {cfg.datasource_type!r} is not ported yet; see '
        'ROADMAP.md, queue 1 item 8')
  if cfg.datasource_type == 'synthetic':
    return SyntheticDataSource(num_frames=cfg.synthetic_frames,
                               image_size=cfg.synthetic_image_size,
                               random_seed=cfg.random_seed)
  raise ValueError(f'Unknown datasource type {cfg.datasource_type!r}')
