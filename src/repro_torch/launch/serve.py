"""Serving traffic runner of the port: a Poisson arrival trace through the
paged continuous engine, in wall-clock time.

Builds the model (parameters from a seed), warms the engine on one short
request off the clock, then submits every trace request at its arrival
time and runs micro-steps until all have finished. Reports useful-token
throughput, TTFT and latency percentiles, KV accounting and the
paged-attention kernel launch counts; ``--json`` writes them out.

On the card (the default):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
      --requests 16 --slots 8 --prompt-len 16,256 --prefill-chunk 64 \\
      --kv-block-size 16 --json serve_torch.json
On the CPU, at the smoke config (the plain attention path):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
      --smoke --device cpu --requests 4 --slots 2 --prompt-len 16,40
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.config import ServeConfig
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.kernels.paged_attention import ops
from repro_torch.models.registry import build_model
from repro_torch.serve import ContinuousEngine, ServeRequest, make_trace
from repro_torch.serve.scheduler import latency_stats_over


def requests_from_trace(cfg, trace, *, seed: int = 0) -> List[ServeRequest]:
    """One ServeRequest per trace entry, each with its own prompt drawn by
    numpy from ``seed + 1000 + rid``."""
    reqs = []
    for rid, entry in enumerate(trace):
        rng = np.random.default_rng(seed + 1000 + rid)
        tokens = rng.integers(0, cfg.vocab_size, size=(1, entry.prompt_len),
                              dtype=np.int32)
        reqs.append(ServeRequest(rid=rid, batch={"tokens": tokens},
                                 max_new_tokens=entry.max_new,
                                 seed=seed, arrival=entry.arrival))
    return reqs


def device_info(device: torch.device) -> Dict:
    """The device a result ran on: the card's name and power limit (as
    ``nvidia-smi`` reports them), or the CPU."""
    if device.type != "cuda":
        return {"name": "cpu", "count": 0}
    info = {"name": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count(), "power_limit": None}
    smi = shutil.which("nvidia-smi")
    if smi:
        res = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30, check=False)
        if res.returncode == 0 and res.stdout.strip():
            info["nvidia_smi"] = res.stdout.strip()
            info["power_limit"] = res.stdout.strip().split(",")[-1].strip()
    return info


def drive_continuous(eng: ContinuousEngine, requests: List[ServeRequest]
                     ) -> Dict[str, float]:
    """Submit each request at its arrival time, run micro-steps until all
    have finished; return latency/throughput stats."""
    pending = sorted(requests, key=lambda r: r.arrival)
    n, i, done = len(pending), 0, 0
    sync = (torch.cuda.synchronize if eng.device.type == "cuda"
            else (lambda: None))
    t0 = time.perf_counter()
    while done < n:
        now = time.perf_counter() - t0
        while i < n and pending[i].arrival <= now:
            eng.submit(pending[i], now)
            i += 1
        if eng.idle and i < n:
            time.sleep(min(1e-3, max(0.0, pending[i].arrival - now)))
            continue
        done += len(eng.step(time.perf_counter() - t0))
    sync()
    makespan = time.perf_counter() - t0
    toks = sum(r.generated for r in requests)
    stats = latency_stats_over(eng.scheduler.finished)
    stats.update(makespan_s=makespan, useful_tokens=float(toks),
                 tok_s=toks / makespan,
                 eager_admits=float(eng.scheduler.n_eager_admits),
                 deferred=float(eng.scheduler.n_deferred),
                 block_deferrals=float(eng.scheduler.n_block_deferrals),
                 modeled_admit_cost_us=1e6
                 * eng.scheduler.modeled_admit_cost_s)
    stats.update(eng.kv_accounting())
    return stats


def run_serve(arch: str = "gemma-2b", *, smoke: bool = False,
              device="cuda", requests: int = 16, slots: int = 8,
              prompt_len=(16, 256), max_new=(4, 48), rate: float = 50.0,
              prefill_chunk: int = 64, max_prefill_per_step: int = 2,
              block_size: int = 16, seed: int = 0) -> Dict:
    """Build the model, warm the engine, drive the trace; return the
    result dict (``backend: "torch"``). The kernel counters in it count
    the measured drive only."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    dtype = "float32" if smoke else "bfloat16"
    model = build_model(cfg, ServeConfig(param_dtype=dtype,
                                         compute_dtype=dtype), device=device)
    params = model.init(seed)
    plens = ((int(prompt_len),) if isinstance(prompt_len, int)
             else tuple(int(p) for p in prompt_len))
    hi = max_new if isinstance(max_new, int) else max_new[1]
    cache_len = max(plens) + hi
    eng = ContinuousEngine(model, params, cache_len=cache_len,
                           num_slots=slots, prefill_chunk=prefill_chunk,
                           max_prefill_per_step=max_prefill_per_step,
                           block_size=block_size, device=model.device)
    # warm-up off the clock (kernel build and load, library handles),
    # then a clean engine for the measured drive
    warm = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(min(2, slots), plens[0]), dtype=np.int32)
    eng.generate({"tokens": warm}, 2)
    eng.reset()
    trace = make_trace(requests, prompt_len=plens, max_new=max_new,
                       rate=rate, seed=seed)
    reqs = requests_from_trace(cfg, trace, seed=seed)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(model.device)
    ops.reset_counters()
    stats = drive_continuous(eng, reqs)
    result: Dict = {
        "backend": "torch",
        "arch": cfg.name,
        "device": device_info(model.device),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "dtype": dtype,
        "requests": requests, "slots": slots, "prompt_len": list(plens),
        "max_new": list(max_new) if not isinstance(max_new, int) else max_new,
        "rate": rate, "cache_len": cache_len,
        "prefill_chunk": eng.prefill_chunk,
        "max_prefill_per_step": eng.max_prefill_per_step,
        "block_size": block_size, "num_blocks": eng.kv.pool.num_blocks,
        "continuous_tok_s": stats["tok_s"],
        "ttft_p50_ms": 1e3 * stats["ttft_p50_s"],
        "ttft_p95_ms": 1e3 * stats["ttft_p95_s"],
        "continuous": stats,
        "kernels": ops.counters(),
        # eager PyTorch compiles no programs; the field stays for schema
        # parity with the reference's artifact
        "prefill_compiles": None,
        "outputs": [r.output[:r.generated].tolist() for r in reqs],
    }
    if model.device.type == "cuda":
        result["max_memory_allocated"] = torch.cuda.max_memory_allocated(
            model.device)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gemma-2b", choices=list(ARCH_NAMES))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--prompt-len", default="16,256", metavar="N[,N...]")
    ap.add_argument("--max-new-lo", type=int, default=4)
    ap.add_argument("--max-new-hi", type=int, default=48)
    ap.add_argument("--rate", type=float, default=50.0)
    ap.add_argument("--prefill-chunk", type=int, default=64)
    ap.add_argument("--max-prefill-per-step", type=int, default=2)
    ap.add_argument("--kv-block-size", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None, metavar="PATH")
    args = ap.parse_args(argv)
    result = run_serve(
        args.arch, smoke=args.smoke, device=args.device,
        requests=args.requests, slots=args.slots,
        prompt_len=tuple(int(p) for p in args.prompt_len.split(",")),
        max_new=(args.max_new_lo, args.max_new_hi), rate=args.rate,
        prefill_chunk=args.prefill_chunk,
        max_prefill_per_step=args.max_prefill_per_step,
        block_size=args.kv_block_size, seed=args.seed)
    summary = {k: result[k] for k in (
        "backend", "arch", "device", "continuous_tok_s", "ttft_p50_ms",
        "ttft_p95_ms", "kernels")}
    print(json.dumps(summary))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=2)


if __name__ == "__main__":
    main()
