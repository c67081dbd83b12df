"""Multi-rank serving fabric demo — the port of
``examples/serve_fabric.py``: the same mixed short/long greedy trace
through a single paged ContinuousEngine, a 2-rank replicated fabric
(join-shortest-queue data parallelism), and a prefill/decode-
disaggregated fabric whose finished prompts migrate block-by-block over
the request-based KV transport. The engine ranks are threads on one
device; on the card their chunks and decode steps run the
paged-attention kernels.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_fabric
          [--device cpu]     # the smoke config on the CPU, gemma-2b's
                             # published widths on the card
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.config import ServeConfig, TrainConfig
from repro_torch.examples import report, reset_counts, serving_config
from repro_torch.models.registry import build_model, make_synthetic_batch
from repro_torch.serve import (ContinuousEngine, ServeRequest, ServingFabric,
                               make_trace)


def requests_for(cfg, trace, seed=0):
    out = []
    for rid, e in enumerate(trace):
        b = make_synthetic_batch(cfg, 1, e.prompt_len, seed=seed + rid,
                                 compute_dtype="float32", device="cpu")
        out.append(ServeRequest(rid=rid,
                                batch={"tokens": b["tokens"].numpy()},
                                max_new_tokens=e.max_new,
                                arrival=e.arrival, seed=seed))
    return out


def drain(target, reqs):
    for r in reqs:
        target.submit(r, 0.0)
    steps = 0
    while not target.idle:
        target.step(0.0)
        steps += 1
    return steps


def main(argv=None):
    ap = argparse.ArgumentParser(description="serving fabric demo")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = args.device
    reset_counts()
    cfg = serving_config(dev)
    tcfg = TrainConfig(param_dtype="float32", compute_dtype="float32",
                       remat=False, loss_chunk=64)
    model = build_model(cfg, ServeConfig(param_dtype="float32",
                                         compute_dtype="float32"),
                        device=dev, train=tcfg)
    params = model.init(0)
    cache_len = 64 + 16

    trace = make_trace(8, prompt_len=(16, 64), max_new=(4, 16),
                       arrival="all", seed=0)

    single = ContinuousEngine(model, params, cache_len=cache_len,
                              num_slots=4, prefill_chunk=16,
                              kv_layout="paged", block_size=8, device=dev)
    base = requests_for(cfg, trace)
    print(f"single engine: drained in {drain(single, base)} steps")
    checks = {}

    for placement in ("replicated", "disagg"):
        fab = ServingFabric(model, params, ranks=2, placement=placement,
                            cache_len=cache_len, slots_per_rank=4,
                            prefill_chunk=16, block_size=8, device=dev)
        reqs = requests_for(cfg, trace)
        steps = drain(fab, reqs)
        ident = all(np.array_equal(a.output[:a.generated],
                                   b.output[:b.generated])
                    for a, b in zip(base, reqs))
        st = fab.stats()
        print(f"{placement:>10}: {steps} fabric steps, "
              f"token_identical={ident}")
        for row in st["per_rank"]:
            print(f"            rank {row['rank']} [{row['role']}] "
                  f"util={row['utilization']:.2f} "
                  f"tokens={row['tokens']:.0f}")
        if "n_migrations" in st:
            print(f"            kv_migration: {st['n_migrations']:.0f} "
                  f"handoffs, {st['blocks_moved']:.0f} blocks, "
                  f"{st['kv_migration_modeled_s']*1e6:.1f}us modeled")
            checks["migrations"] = st["n_migrations"] == len(reqs)
        checks[f"token_identical_{placement}"] = ident
        fab.close()
    return report("serve_fabric", checks)


if __name__ == "__main__":
    main()
