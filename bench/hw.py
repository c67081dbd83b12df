"""Peaks of one NVIDIA H100 SXM5 80GB at its 700 W board power: the
benchmark's own copy of the constants every per-layer share is read
against.

Source: the NVIDIA H100 Tensor Core GPU data sheet, SXM5 column, dense
rates (no 2:4 sparsity): 989 TFLOP/s bf16 on the tensor cores, 67
TFLOP/s float32 on the CUDA cores, 80 GB of HBM3 at 3.35 TB/s. A card
set below 700 W runs slower under load; the run prints the card's name
and a share is stated against these published peaks.
"""

BF16_FLOPS = 989e12     # FLOP/s, dense tensor core
F32_FLOPS = 67e12       # FLOP/s, CUDA cores (no TF32)
HBM_BYTES_S = 3.35e12   # bytes/s
HBM_BYTES = 80e9        # capacity
