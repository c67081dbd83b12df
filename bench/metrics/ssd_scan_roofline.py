"""``ssd_scan_roofline`` (layer ``kernels/ssd_scan``): the prompt chunks'
scan calls of the profiled slice against their roofline: per valid
token x, dt, B, C in and y out, each chunk row's state in and out, the
recurrence's ``5 h p n`` FLOPs a token (``bench.work.ssd_scan_cost``),
float32 peak (the scan runs in float32 on the CUDA cores), over the
device time of the scan kernel."""

from bench.readers import roofline

KERNELS = ("ssd_kernel",)
COUNTERS = (("repro_torch.kernels.ssd_scan.ops", "ssd_launches"),)


def read(run):
    return roofline(run, KERNELS, COUNTERS, run.work.ssd_scan_cost,
                    run.hw.F32_FLOPS)
