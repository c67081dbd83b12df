"""Phase 13(a) and 13(f) of ``chip_smoke.py`` alone on the card, their
gates recorded, not fatal; the last line (``TRIAL {...}``) holds each
step's bytes held beyond the state, the temporaries and the times. It
runs the ``chip_smoke.py`` and ``src/`` of the directory it starts in,
so a tree unpacked with ``git archive`` (given this ``chip_smoke.py``)
is read by the same readings as the working tree.

Run:  python3 tests/chip_train_held.py                 # from the repo root
      cd OTHER_TREE && python3 ROOT/tests/chip_train_held.py
"""
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402

fails = []
C.require = lambda ok, msg: None if ok else fails.append(msg)
if not torch.cuda.is_available():
    sys.exit("no card")
dev = torch.device("cuda")
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip(), flush=True)
a = C.train_gemma_full(dev)
f = C.train_4k_chunked(dev)
keys = ("median_step_ms", "max_memory_allocated", "temp_bytes",
        "predicted_temp_bytes", "measured_over_predicted", "step_ms",
        "state_bytes", "held_beyond_state", "collected_after_loop", "losses")
print("TRIAL " + json.dumps({"tree": os.getcwd(), "a": {
    k: a.get(k) for k in ("held_beyond_state", "step_ms", "median_step_ms",
                          "max_memory_allocated", "losses")},
    "f": {k: f.get(k) for k in keys}, "fails": fails}), flush=True)
