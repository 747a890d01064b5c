"""L2 data layer, counterpart of ``nerfds_tpu/datasets``."""
from nerfds_torch.datasets.core import DataSource, RayStore, sample_batch
from nerfds_torch.datasets.synthetic import SyntheticDataSource

__all__ = ['DataSource', 'RayStore', 'sample_batch', 'SyntheticDataSource']
