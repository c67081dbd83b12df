"""``idle_in_forward.saturated`` (layer ``models/``, the forward's host
launches and syncs): per cent of the profiled slice in which the card
ran nothing while the model's forward (a ``prefill_chunk.forward`` or
``decode.forward`` range) was on the host
(``bench/metrics/_idle_split.py``)."""

from bench.metrics._idle_split import split


def read(run):
    parts = split(run)
    return None if parts is None else parts[0]
