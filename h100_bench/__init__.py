"""The benchmark of nerfds_torch on one or four NVIDIA H100 cards (see
``BENCHMARK.json`` and ``run.py``)."""
