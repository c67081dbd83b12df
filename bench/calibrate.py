#!/usr/bin/env python3
"""The readings a cell's ``correct`` limit is set from, on the card, in
one process.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--control 3]

Each seed is one run of the cell by the path that decides ``correct``
(``bench.run.run_cell``): set-up, a window of ``--seconds`` at the
cell's own load, the seeded sample of finished requests against the
float32 reference (the program's readings); for the first ``--control``
seeds also the fp8 control on the same sample (the control's readings).
One JSON line a seed, then the largest program reading and the smallest
control reading of each number.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench.run import _prepare, cell_spec, run_cell  # noqa: E402


def readings(spec, seeds, seconds: float, control: int, *,
             device: str = "cuda"):
    """One row a seed (see the module's docstring) for the cell ``spec``
    (``bench.run.cell_spec``)."""
    import torch
    for i, seed in enumerate(seeds):
        res = run_cell(spec, seed, seconds, False, device=device,
                       t_start=time.perf_counter(), control=i < control)
        row = {"seed": seed, "correct": res["correct"],
               "program": res["readings"]}
        if "control_readings" in res:
            row["control"] = res["control_readings"]
        yield row
        del res
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    spec = cell_spec(args.workload)
    _prepare()
    from bench import check
    rows = []
    for row in readings(spec, [int(s) for s in args.seeds.split(",")],
                        args.seconds, args.control):
        rows.append(row)
        print(json.dumps(row), flush=True)
    out = {"workload": args.workload, "seeds": len(rows),
           "control_seeds": sum("control" in r for r in rows)}
    for k in check.NUMBERS:
        out[f"program_max.{k}"] = max(r["program"][k] for r in rows)
        ctrl = [r["control"][k] for r in rows if "control" in r]
        out[f"control_min.{k}"] = min(ctrl) if ctrl else None
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
