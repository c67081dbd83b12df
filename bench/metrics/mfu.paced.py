"""``mfu.paced`` (layer ``models/``): the model FLOPs of the window's
steps before the profiled slice (``bench.work.model_flops``: top-k
experts, causal attention, the LM head where a logit is sampled), over
the sum of those steps' host-clock times and the card's bf16 peak."""

from bench.readers import before_slice, mfu_steps


def read(run):
    return mfu_steps(run, before_slice(run))
