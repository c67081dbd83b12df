"""Paged attention: CUDA kernels (``csrc/``), wrapper (``ops``), plain
version (``ref``)."""
