"""PyTorch/CUDA port of the MPIxThreads serving system.

Mirrors ``src/repro/`` module for module (each file has its twin at the
same relative path) and is held against it by the ``tests/test_torch_*``
suite. The hot-path kernels are written by hand for Hopper (``sm_90a``)
and built at first use from ``kernels/*/csrc``.
"""
