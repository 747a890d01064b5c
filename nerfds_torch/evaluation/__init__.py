"""Chunked rendering, counterpart of ``nerfds_tpu/evaluation``."""
