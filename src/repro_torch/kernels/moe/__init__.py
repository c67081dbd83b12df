"""Top-k grouped expert products of the dropless MoE layer: CUDA kernels
(``csrc/``), wrapper (``ops``), plain version (``ref``)."""
