"""``mfu.saturated`` (layer ``models/``): the model FLOPs of all the work
of the window (``bench.work.model_flops``) over the window's seconds and
the card's bf16 peak."""


def read(run):
    if run.window_s <= 0 or not run.steps:
        return None
    flops = sum(run.work.model_flops(run.c, s) for s in run.steps)
    return 100.0 * flops / (run.window_s * run.hw.BF16_FLOPS)
