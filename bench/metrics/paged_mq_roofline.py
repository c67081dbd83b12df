"""``paged_mq_roofline`` (layer ``kernels/paged_attention``): the prompt
chunks' attention calls of the profiled slice (the multi-query paged
kernel) against their roofline: the prompt's keys and values so far
read once, the causal pairs of the chunk's valid queries
(``bench.work.paged_mq_cost``), bf16 tensor-core peak, over the device
time of the kernel and its split combine."""

from bench.readers import roofline

KERNELS = ("paged_mq_kernel", "paged_mq_combine")
COUNTERS = (("repro_torch.kernels.paged_attention.ops", "mq_launches"),)


def read(run):
    return roofline(run, KERNELS, COUNTERS, run.work.paged_mq_cost,
                    run.hw.BF16_FLOPS)
