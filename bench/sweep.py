#!/usr/bin/env python3
"""Find an open-loop cell's knee once, by a sweep on the card: one
process, one engine, a window of ``--seconds`` at each offered rate.

    python3 bench/sweep.py --workload <cell> --seed <n> --seconds <s> \
        --rates 4,6,8,10

For each rate it prints one JSON line: requests due, finished, left in
the engine at the window's end, finished a second, and the TTFT and
inter-token tails. The knee is the highest rate the engine keeps up
with: what it leaves at the end stays about one window's worth of rows,
not a queue that grows with the window. The cell's file then states 0.8
of it as a number; the sweep is not run again by the benchmark.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import warnings
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench.run import (Drive, _prepare, cell_spec, make_engine,  # noqa: E402
                       make_model, reference)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    spec = cell_spec(args.workload)
    _prepare()
    import torch

    from bench import stats

    cfg, wl = spec.cfg, spec.wl
    port = cfg["port"]
    model = make_model(cfg, "cuda")
    params = reference(cfg).make_params(port, args.seed, "cuda",
                                        dtype=getattr(torch, cfg["dtype"]))
    eng = make_engine(model, params, wl, args.seed, "cuda")
    for rate in [float(r) for r in args.rates.split(",")]:
        w = dict(wl, arrival=dict(wl["arrival"], rate=rate))
        drive = Drive(eng, w, args.seed, args.seconds,
                      int(port["vocab_size"]), traced=False)
        win = drive.run(time.perf_counter())
        end = win.t_close
        row = {"rate": rate, "due": len(drive.clocks),
               "finished": len(drive.finished),
               "left": len(drive.live), "finished_s":
               len(drive.finished) / end,
               "tokens_s": sum(s.tokens for s in drive.steps) / end,
               "ttft_p95_ms": stats.ttft_p95_ms(drive.clocks, end),
               "ttft_p50_ms": 1e3 * stats.percentile(
                   [c.ttft(end) for c in drive.clocks], 50),
               "itl_p95_ms": stats.itl_p95_ms(drive.clocks),
               # a queue that grows shows as later requests waiting longer
               "ttft_p50_ms_halves": [
                   1e3 * stats.percentile([c.ttft(end) for c in drive.clocks
                                           if (c.due < end / 2) == first],
                                          50) for first in (True, False)],
               "steps": len(drive.steps)}
        print(json.dumps(row), flush=True)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            eng.reset()
    return 0


if __name__ == "__main__":
    sys.exit(main())
