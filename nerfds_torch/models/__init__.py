"""Modules and the NeRF-DS model, counterpart of ``nerfds_tpu/models``."""
from nerfds_torch.models.nerfds import NerfDSModel, default_extra_params

__all__ = ['NerfDSModel', 'default_extra_params']
