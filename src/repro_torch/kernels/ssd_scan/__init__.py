"""SSD chunk scan (Mamba2): CUDA kernel (``csrc/``), wrapper (``ops``),
plain versions (``ref``)."""
