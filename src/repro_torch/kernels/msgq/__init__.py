"""Message copies of the comm layer: CUDA kernels (``csrc/``), wrapper
(``ops``), plain version (``ref``)."""
