"""What the per-layer metrics' readers share (``bench/metrics/``). Each
takes the run (``run.steps``: the window's engine steps as
:class:`bench.work.Step`; ``run.spans``: the program tracer's events in
window seconds; ``run.dues``: when each request fell due; ``run.reading``:
the profiled slice, :class:`bench.devtrace.Reading`; ``run.counters``:
the program's launch counters over the slice; ``run.slice_at``: where
the slice starts; ``run.c``: the configuration's sizes) and returns a
number, or None where the run has nothing to read. Metrics read from
the program's spans or the host clock take the part of the window
before the slice, which the profiler's cost has not slowed.""" 

from __future__ import annotations


def slice_steps(run) -> list:
    return [s for s in run.steps if s.in_slice]


def before_slice(run) -> list:
    """The window's steps before the profiled slice (``run.slice_at``
    seconds into the window): the profiler off, and no backlog it left."""
    return [s for s in run.steps if s.t1 <= run.slice_at]


def kernels_per_step(run):
    """Device kernels in the profiled slice over the engine steps in it."""
    sl = slice_steps(run)
    if run.reading is None or not sl or not run.reading.kernels:
        return None
    return len(run.reading.kernels) / len(sl)


def idle_share(run):
    """Per cent of the profiled slice with no device operation running."""
    r = run.reading
    if r is None or not r.device or r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s() / r.window_s)


def mfu_steps(run, steps):
    """Per cent of the bf16 peak: the model FLOPs of ``steps`` over their
    host-clock time."""
    secs = sum(s.seconds for s in steps)
    if not steps or secs <= 0:
        return None
    flops = sum(run.work.model_flops(run.c, s) for s in steps)
    return 100.0 * flops / (secs * run.hw.BF16_FLOPS)


def roofline(run, kernels, counters, cost, peak_flops):
    """Per cent of a kernel's roofline over the profiled slice: the least
    time the slice's calls need, max(FLOPs / peak, bytes / HBM
    bandwidth), over the device time of the kernels named ``kernels``.
    A kernel its counter shows launched but the profiler shows under no
    listed name fails the run: a renamed kernel must not read 0."""
    if run.reading is None:
        return None
    launched = sum(run.counters.get(k, 0) for k in counters)
    dev = run.reading.kernel_seconds(kernels)
    if launched and dev <= 0:
        raise RuntimeError(
            f"{launched} launches of {counters} in the profiled slice, but "
            f"no device time under {kernels}")
    flops = byt = 0.0
    for s in slice_steps(run):
        f, b = cost(run.c, s)
        flops += f
        byt += b
    if dev <= 0 or (flops <= 0 and byt <= 0):
        return None
    least = max(flops / peak_flops, byt / run.hw.HBM_BYTES_S)
    return 100.0 * least / dev
