"""Continuous-batching serving demo against the threadcomm substrate —
the port of ``examples/serve_continuous.py``.

Requests stream in on a Poisson trace with mixed prompt lengths; the
cell-queue scheduler admits them against the paper's bounded cell pool
(eager buffering for small prompts, rendezvous deferral for large ones),
prompts *stream into their cache in fixed-size chunks* interleaved with
decode micro-steps (one chunk shape for every prompt length), the KV
cache is *paged*: fixed-size blocks leased from one global pool through
per-request block tables, admission gated on free blocks, and
prefill/decode micro-steps are ordered on two distinct ``CommStream``s
(CUDA streams on the card) of a root threadcomm. On the card the chunks
and decode steps run the paged-attention kernels (``paged_mq``,
``paged_decode``).

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_continuous
          [--device cpu]     # the smoke config on the CPU, gemma-2b's
                             # published widths on the card
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.config import ServeConfig, TrainConfig
from repro_torch.core import threadcomm_init
from repro_torch.core.compat import make_mesh
from repro_torch.examples import report, reset_counts, serving_config
from repro_torch.models.registry import build_model, make_synthetic_batch
from repro_torch.serve import (CellQueueScheduler, ContinuousEngine,
                               ServeRequest, StaticEngine, make_trace)

SLOTS, PROMPTS, REQUESTS, CHUNK = 4, (16, 48), 12, 16


def main(argv=None):
    ap = argparse.ArgumentParser(description="continuous batching demo")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = args.device
    reset_counts()
    cfg = serving_config(dev)
    tcfg = TrainConfig(param_dtype="float32", compute_dtype="float32",
                       remat=False, loss_chunk=64, attn_chunk_threshold=4096)
    model = build_model(cfg, ServeConfig(param_dtype="float32",
                                         compute_dtype="float32"),
                        device=dev, train=tcfg)
    params = model.init(0)

    # serving threadcomm: prefill and decode get their own MPIX streams
    mesh = make_mesh((1,), ("ranks",), device=dev)
    root = threadcomm_init(mesh, process_axes=(), thread_axes=("ranks",))
    root.start()

    eng = ContinuousEngine(model, params, cache_len=80, num_slots=SLOTS,
                           comm=root, prefill_chunk=CHUNK,
                           max_prefill_per_step=2,
                           kv_layout="paged", block_size=16,
                           scheduler=CellQueueScheduler(
                               num_cells=8, prefill_chunk_bytes=4 * CHUNK,
                               block_bytes=4 * 16), device=dev)
    trace = make_trace(REQUESTS, prompt_len=PROMPTS, max_new=(4, 24), seed=0)
    reqs = []
    for rid, entry in enumerate(trace):
        batch = make_synthetic_batch(cfg, 1, entry.prompt_len,
                                     seed=100 + rid, compute_dtype="float32",
                                     device="cpu")
        req = ServeRequest(rid=rid,
                           batch={"tokens": batch["tokens"].numpy()},
                           max_new_tokens=entry.max_new,
                           arrival=entry.arrival)
        reqs.append(req)
        where = eng.submit(req, now=entry.arrival)
        print(f" req {rid:2d} arrive {entry.arrival * 1e3:6.1f}ms "
              f"prompt={entry.prompt_len:3d} "
              f"max_new={entry.max_new:2d} -> {where}")

    steps = 0
    while not eng.idle:
        done = eng.step(now=float(steps))
        steps += 1
        for r in done:
            print(f"   finished req {r.rid:2d} after {r.generated:2d} "
                  f"tokens, {r.prefill_chunks} prefill chunks "
                  f"(micro-step {steps}, live={eng.num_active}, "
                  f"prefilling={eng.num_prefilling}, "
                  f"free_blocks={eng.kv.num_free_blocks})")
    print(f" drained {len(reqs)} requests in {steps} micro-steps over "
          f"{eng.kv.pool.num_blocks} KV blocks / {SLOTS} rows "
          f"(peak {eng.peak_live} concurrent, one chunk shape (C={CHUNK}) "
          f"for {len(set(PROMPTS))} prompt lengths)")
    checks = {"drained": all(r.generated == r.max_new_tokens
                             for r in reqs)}

    # greedy parity against the static baseline (same-arrival batch of
    # the LONG prompts: a multi-chunk deposit, still token-identical)
    batch = make_synthetic_batch(cfg, SLOTS, max(PROMPTS),
                                 compute_dtype="float32", device="cpu")
    prompt = {"tokens": batch["tokens"].numpy()}
    static = StaticEngine(model, params, cache_len=80,
                          device=dev).generate(prompt, 8)
    cont = ContinuousEngine(model, params, cache_len=80, num_slots=SLOTS,
                            prefill_chunk=CHUNK,
                            device=dev).generate(prompt, 8)
    paged = ContinuousEngine(model, params, cache_len=80, num_slots=SLOTS,
                             prefill_chunk=CHUNK, kv_layout="paged",
                             block_size=16, device=dev).generate(prompt, 8)
    checks["parity_continuous"] = bool(np.array_equal(static, cont))
    checks["parity_paged"] = bool(np.array_equal(static, paged))
    print(" parity vs StaticEngine:", checks["parity_continuous"],
          "paged:", checks["parity_paged"])

    root.finish()
    root.free()
    print("done.")
    return report("serve_continuous", checks)


if __name__ == "__main__":
    main()
