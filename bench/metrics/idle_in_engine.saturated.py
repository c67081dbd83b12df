"""``idle_in_engine.saturated`` (layer ``serve/engine.py``, host
bookkeeping): per cent of the profiled slice in which the card ran
nothing while the engine's step was on the host outside any forward:
batch packing, sampling, admissions (``bench/metrics/_idle_split.py``).
With ``idle_in_forward.saturated`` it sums to at most
``idle_share.saturated``; the rest is the harness between steps."""

from bench.metrics._idle_split import split


def read(run):
    parts = split(run)
    return None if parts is None else parts[1]
