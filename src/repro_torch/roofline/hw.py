"""Target hardware constants: one NVIDIA H100 SXM5 80GB at its 700 W
board power.

Sources: the NVIDIA H100 Tensor Core GPU data sheet (SXM5 column: BF16
tensor core 1,979 TFLOP/s with 2:4 sparsity, so 989 dense; FP32 67
TFLOP/s; 80 GB HBM3 at 3.35 TB/s; NVLink 900 GB/s, both directions
together; max TDP 700 W), the NVIDIA H100 Tensor Core GPU Architecture
whitepaper (up to 228 KB of shared memory per SM) and the DGX H100
data sheet (one 400 Gb/s ConnectX-7 port per GPU for the network
between nodes).

The fields are the reference's ``HW`` (``src/repro/roofline/hw.py``)
where their meaning carries over. Three are renamed because their TPU
meaning does not: ``ici_link_bw`` (one ICI link) is ``nvlink_bw``, the
NVLink bandwidth per GPU per direction; ``dcn_bw`` (per host, between
pods) is ``network_bw``, the inter-node network bandwidth per GPU;
``vmem_bytes`` (the TensorCore's vector memory) is ``smem_per_sm_bytes``,
the shared memory of one SM. ``peak_flops_f32`` is new: the port's f32
kernels are bounded by it.
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class HW:
    name: str
    peak_flops_bf16: float     # FLOP/s per GPU, dense tensor core
    peak_flops_f32: float      # FLOP/s per GPU, CUDA cores
    hbm_bw: float              # bytes/s per GPU
    nvlink_bw: float           # bytes/s per GPU per direction
    network_bw: float          # bytes/s per GPU, between nodes
    hbm_bytes: float           # capacity per GPU
    smem_per_sm_bytes: float   # shared memory per SM


H100 = HW(
    name="h100-sxm5-80gb",
    peak_flops_bf16=989e12,
    peak_flops_f32=67e12,
    hbm_bw=3.35e12,
    nvlink_bw=450e9,
    network_bw=400e9 / 8,
    hbm_bytes=80e9,
    smem_per_sm_bytes=228 * 1024,
)
