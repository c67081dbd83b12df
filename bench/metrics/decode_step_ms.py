"""``decode_step_ms`` (layer ``serve/engine.py``): the mean of the
program tracer's ``decode`` spans in the window before the profiled
slice. The span ends after the step's token read-back, so it holds the
step's device work."""


def read(run):
    durs = [t1 - t0 for name, t0, t1, _ in run.spans
            if name == "decode" and 0 <= t0 and t1 <= run.slice_at]
    if not durs:
        return None
    return 1e3 * sum(durs) / len(durs)
