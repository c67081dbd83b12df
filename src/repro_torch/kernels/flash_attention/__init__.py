"""Flash attention: CUDA kernel (``csrc/``), wrapper (``ops``), plain
version (``ref``)."""
