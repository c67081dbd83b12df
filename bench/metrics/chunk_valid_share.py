"""``chunk_valid_share`` (layer ``serve/engine.py``): per cent of the
token positions the prompt-chunk batches ran in the profiled slice that
held a prompt token; the rest is padding, every row of a batch being
run at the full chunk. Read from the engine's always-on counters
``prefill_valid_tokens`` and ``prefill_positions`` over the slice. A
program without those counters declares none, and the metric reads
nothing."""

import importlib

ENGINE = "repro_torch.serve.engine"
COUNTERS = tuple((ENGINE, name) for name in
                 ("prefill_valid_tokens", "prefill_positions")
                 if hasattr(importlib.import_module(ENGINE), name))


def read(run):
    positions = run.counters.get((ENGINE, "prefill_positions"), 0)
    if not positions:
        return None
    return 100.0 * run.counters[(ENGINE, "prefill_valid_tokens")] / positions
