"""L2 data layer, counterpart of ``nerfds_tpu/datasets``."""
from nerfds_torch.datasets.core import (DataSource, HostRayIterator, RayStore,
                                        sample_batch)
from nerfds_torch.datasets.interp import InterpDataSource
from nerfds_torch.datasets.nerfies import NerfiesDataSource
from nerfds_torch.datasets.synthetic import (SyntheticDataSource,
                                             VrigSyntheticDataSource,
                                             write_nerfies_dataset)

__all__ = ['DataSource', 'HostRayIterator', 'RayStore', 'sample_batch', 'InterpDataSource',
           'NerfiesDataSource', 'SyntheticDataSource',
           'VrigSyntheticDataSource', 'write_nerfies_dataset', 'from_config']


def from_config(experiment_config) -> DataSource:
  """The datasource named by an ``ExperimentConfig``."""
  cfg = experiment_config
  if cfg.datasource_type == 'nerfies':
    return NerfiesDataSource(cfg.data_dir, image_scale=cfg.image_scale,
                             random_seed=cfg.random_seed)
  if cfg.datasource_type == 'interp':
    return InterpDataSource(cfg.data_dir, interval=cfg.interp_interval,
                            image_scale=cfg.image_scale,
                            random_seed=cfg.random_seed)
  if cfg.datasource_type == 'synthetic':
    return SyntheticDataSource(num_frames=cfg.synthetic_frames,
                               image_size=cfg.synthetic_image_size,
                               random_seed=cfg.random_seed)
  raise ValueError(f'Unknown datasource type {cfg.datasource_type!r}')
