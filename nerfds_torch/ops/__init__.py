"""L0 ops, counterpart of ``nerfds_tpu/ops``."""
