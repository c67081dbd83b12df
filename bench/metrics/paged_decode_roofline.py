"""``paged_decode_roofline`` (layer ``kernels/paged_attention``): the
decode-attention calls of the profiled slice against their roofline:
each live row's keys and values read once, q.k and p.v over them
(``bench.work.paged_decode_cost``), bf16 tensor-core peak, over the
device time of the decode kernel and its split combine."""

from bench.readers import roofline

KERNELS = ("paged_decode_kernel", "paged_decode_combine")
COUNTERS = (("repro_torch.kernels.paged_attention.ops", "decode_launches"),)


def read(run):
    return roofline(run, KERNELS, COUNTERS, run.work.paged_decode_cost,
                    run.hw.BF16_FLOPS)
