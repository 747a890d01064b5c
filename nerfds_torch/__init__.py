"""nerfds_torch: the PyTorch + CUDA port of nerfds_tpu for NVIDIA Hopper.

Layout mirrors the JAX package: ``ops/`` (L0 math), ``camera.py`` and
``datasets/`` (rays and ray stores), ``models/`` (modules and the NeRF-DS
model), ``kernels/`` (hand-written CUDA kernels, each with a plain PyTorch
version beside it), ``training/`` (schedules, losses, the train step),
``trainer.py`` (the training loop), ``evaluation/`` (chunked rendering).
The port imports neither ``jax`` nor ``nerfds_tpu``.
"""
from nerfds_torch.device import resolve_device

__all__ = ['resolve_device']
