"""Serving traffic runner of the port: arrival traces through the
continuous-batching engine against the static-batch baseline, in
wall-clock time (the reference's ``launch/serve.py``).

:func:`run_traffic` (the CLI's ``--engine both``) builds the model once
(parameters from a seed), warms each engine on one short prompt shape
off the clock, then drives one Poisson trace through:

* the static-batch baseline (``StaticEngine``: batches of ``slots``
  prompts of one length, monolithic prefill, lockstep decode);
* the continuous engine on the slot layout with chunked prefill, and
  once more with monolithic prefill (``prefill_chunk=0``);
* the continuous engine on the paged layout at the slot pool's HBM
  budget;

and a greedy parity check (static vs continuous vs paged on one batch of
the longest prompt). With ``spec_compare`` the trace runs once more
through a speculative paged engine (k-token draft-verify rounds); with
``prefix_compare`` a shared-prefix trace runs through a paged engine
without the radix prefix cache, with it cold, and with it warm; with
``ring`` the slot cache is a ring buffer of the sliding window. It
reports useful-token throughput, latency and TTFT percentiles, KV
accounting, the comparison flags and the kernel launch counts (of the
whole run, and of each arm's measured drive); ``--json`` writes them
out. :func:`run_serve` drives the paged
continuous engine alone. :func:`run_family_rows` (the CLI's
``--config``) drives each named family through the paged chunked engine
and holds its tokens to the family's static monolithic baseline.

Traces are Poisson (the default), bursts (``--arrival burst``: groups of
``--burst`` at 1/rate spacing) or all at once, greedy or sampled at
``--temperature`` (the speculative arm runs on greedy traces only). The
prefix and speculative comparisons run by default, as the reference's
do; ``--no-prefix-compare`` / ``--no-spec-compare`` skip them.

Telemetry: under ``REPRO_TRACE=1`` (or after ``repro_torch.obs.install()``)
each continuous arm's stats carry the registry's snapshot
(``"metrics"``), its residual report and flat ``residual_<hop>_ratio``
keys and ``serialization_stall_s``; ``--json`` merges them into one
payload-level report (the reference's v8 keys) and ``--trace-out PATH``
writes the tracer's ring as Chrome trace_event JSON for Perfetto.

On the card (the default):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
      --engine both --requests 16 --slots 8 --prompt-len 16,256 \\
      --prefill-chunk 64 --kv-block-size 16 --json serve_torch.json
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
      --engine both --prompt-len 16,256
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --config mamba2-370m,hymba-1.5b --prompt-len 256 --max-new-hi 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \\
      --engine both --requests 8 --slots 4 --prompt-len 16,128
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \\
      --engine both --requests 8 --slots 4 --prompt-len 16,128
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \\
      --engine both --requests 8 --slots 4 --prompt-len 16,128
  PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx-132b \\
      --layers 8 --engine continuous --no-chunk-compare
On the CPU, at the smoke config (the plain attention path):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
      --smoke --device cpu --engine both --requests 4 --slots 2 \\
      --prompt-len 16,40
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
      --smoke --device cpu --engine continuous --requests 6 --slots 3 \\
      --prompt-len 40 --max-new-hi 12
  REPRO_TRACE=1 PYTHONPATH=src python -m repro_torch.launch.serve \\
      --smoke --device cpu --engine continuous --requests 6 --slots 3 \\
      --arrival burst --temperature 0.7 --trace-out trace.json
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
      --smoke --device cpu --ring --no-paged-compare --requests 4 \\
      --slots 2 --prompt-len 24 --max-new-hi 8
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --config families
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import subprocess
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import ServeConfig, ShapeConfig
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.moe import ops as moe_ops
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import encdec, transformer
from repro_torch.models.registry import build_model, cache_len_for
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import residuals as obs_residuals
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import (ContinuousEngine, ServeRequest,
                               ServingFabric, StaticEngine, make_trace)
from repro_torch.serve.engine import sequence_len

#: registry families the ``--config`` sweep covers by default: one per
#: serving structure (dense, MoE, SSM, hybrid, enc-dec), as the
#: reference's
FAMILY_ARCHS = ("gemma-2b", "olmoe-1b-7b", "mamba2-370m", "hymba-1.5b",
                "whisper-tiny")


def arch_config(arch: str, smoke: bool = False,
                layers: Optional[int] = None):
    """``arch``'s published (or smoke) config; ``layers`` cuts its depth
    to the first ``layers`` blocks (a model whose weights do not fit the
    card), every width as published."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if layers is not None and layers < cfg.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=int(layers))
    return cfg


def synthetic_tokens(cfg, batch: int, seq_len: int, seed: int) -> np.ndarray:
    """Prompt tokens (batch, seq_len) int32, drawn by numpy from ``seed``."""
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(batch, seq_len), dtype=np.int32)


def frontend_arrays(cfg, batch: int, seed: int) -> Dict[str, np.ndarray]:
    """The frontend stub's inputs of ``batch`` requests, float32 standard
    normal drawn by numpy from ``seed``: ``frames`` (batch, encoder_seq,
    d) for an encoder-decoder, ``patch_embeds`` (batch,
    num_frontend_tokens, d) for the patch_stub frontend, none otherwise."""
    if cfg.is_encoder_decoder:
        shape, name = (batch, cfg.encoder_seq, cfg.d_model), "frames"
    elif cfg.frontend == "patch_stub":
        shape = (batch, cfg.num_frontend_tokens, cfg.d_model)
        name = "patch_embeds"
    else:
        return {}
    rng = np.random.default_rng((seed, 1))
    return {name: rng.standard_normal(shape, dtype=np.float32)}


def synthetic_batch(cfg, batch: int, seq_len: int, seed: int) -> Dict:
    """A prompt batch: ``tokens`` (:func:`synthetic_tokens`) and the
    frontend's inputs (:func:`frontend_arrays`), both from ``seed``."""
    return {"tokens": synthetic_tokens(cfg, batch, seq_len, seed),
            **frontend_arrays(cfg, batch, seed)}


def requests_from_trace(cfg, trace, *, seed: int = 0) -> List[ServeRequest]:
    """One ServeRequest per trace entry, each with its own prompt drawn
    from ``seed + 1000 + rid``; one seed gives byte-identical prompts to
    every engine driven from the trace. An entry of a shared-prefix
    group opens with its group's template (drawn from ``seed + 131 +
    group``, as long as the group's longest ``prefix_len``), sliced to its
    own ``prefix_len``. A request of a family with a frontend stub also
    carries its inputs (:func:`frontend_arrays`, from ``seed + 1000 +
    rid``)."""
    longest: Dict[int, int] = {}
    for e in trace:
        if e.prefix_group >= 0 and e.prefix_len > 0:
            longest[e.prefix_group] = max(longest.get(e.prefix_group, 0),
                                          e.prefix_len)
    templates = {g: synthetic_tokens(cfg, 1, n, seed + 131 + g)
                 for g, n in longest.items()}
    reqs = []
    for rid, entry in enumerate(trace):
        tok = synthetic_tokens(cfg, 1, entry.prompt_len, seed + 1000 + rid)
        if entry.prefix_group >= 0 and entry.prefix_len > 0:
            tok = tok.copy()
            tok[:, :entry.prefix_len] = \
                templates[entry.prefix_group][:, :entry.prefix_len]
        reqs.append(ServeRequest(rid=rid, batch={
            "tokens": tok, **frontend_arrays(cfg, 1, seed + 1000 + rid)},
                                 max_new_tokens=entry.max_new,
                                 temperature=entry.temperature, seed=seed,
                                 arrival=entry.arrival))
    return reqs


def effective_chunk(caps, prefill_chunk: int) -> int:
    """Capability-aware chunk size: floored to the family's
    ``chunk_multiple``, never below one multiple; 0 (monolithic) when the
    family cannot chunk at all."""
    if prefill_chunk <= 0 or not caps.chunked_prefill:
        return 0
    m = max(1, int(caps.chunk_multiple))
    return max(m, (prefill_chunk // m) * m)


def useful_tokens(row: np.ndarray, eos_id: int) -> int:
    """Tokens a request actually produced: up to and including the first
    EOS (or the full row when EOS never fires / is disabled)."""
    if eos_id >= 0:
        hits = np.flatnonzero(row == eos_id)
        if hits.size:
            return int(hits[0]) + 1
    return int(row.size)


def kernel_counters() -> Dict[str, int]:
    """Every launch counter of the port's model-path kernels, the
    monolithic prefill calls (on the card each launches the flash kernel
    once per layer with attention, the SSD scan once per layer with an
    SSM; an encoder-decoder's twice per decoder layer, self and cross),
    the chunk forwards (each launches the SSD scan once per layer with an
    SSM; an encoder-decoder's the flash kernel once per decoder layer),
    and an encoder-decoder's encoder passes (the flash kernel once per
    encoder layer) and decode forwards (once per decoder layer). A MoE
    layer's experts are one ``moe_launches`` a call on the card."""
    fl, sd, mo = flash_ops.counters(), ssd_ops.counters(), moe_ops.counters()
    return {**ops.counters(), "flash_launches": fl["flash_launches"],
            "flash_ref_calls": fl["ref_calls"],
            "ssd_launches": sd["ssd_launches"],
            "ssd_ref_calls": sd["ref_calls"],
            "moe_launches": mo["moe_launches"],
            "moe_ref_calls": mo["ref_calls"],
            "prefill_calls": transformer.prefill_calls,
            "chunk_calls": transformer.chunk_calls,
            "verify_calls": transformer.verify_calls,
            "encode_calls": encdec.encode_calls,
            "cross_decode_calls": encdec.decode_calls}


def reset_kernel_counters() -> None:
    ops.reset_counters()
    flash_ops.reset_counters()
    ssd_ops.reset_counters()
    moe_ops.reset_counters()
    transformer.reset_counters()
    encdec.reset_counters()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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


def _attach_telemetry(stats: Dict) -> None:
    """When the tracer is live, stamp the trial's residual report, flat
    per-hop ratios and the serialization-stall total onto the stats. The
    capture is trial-clean: the engine's post-warm-up ``reset`` flushed
    the ledger before the measured drive started."""
    tr = obs_trace.active()
    if tr is None:
        return
    rep = tr.residuals.report()
    stats["residual_report"] = rep
    for kind, row in rep["hops"].items():
        if row["n"]:
            stats[f"residual_{kind}_ratio"] = row["ratio"]
    stats["serialization_stall_s"] = rep["serialization_stall_s"]


def _drive_wall_clock(target, requests: List[ServeRequest]) -> float:
    """The wall-clock traffic loop over anything with the serving drive
    surface (``submit`` / ``step`` / ``idle`` / ``device``: an engine or
    a fabric): submit each request at its arrival time, run micro-steps
    until everything has finished, return the makespan in seconds (the
    device's queued work included)."""
    pending = sorted(requests, key=lambda r: r.arrival)
    n, i, done = len(pending), 0, 0
    t0 = time.perf_counter()
    while done < n:
        now = time.perf_counter() - t0
        while i < n and pending[i].arrival <= now:
            target.submit(pending[i], now)
            i += 1
        if target.idle and i < n:
            time.sleep(min(1e-3, max(0.0, pending[i].arrival - now)))
            continue
        done += len(target.step(time.perf_counter() - t0))
    _sync(target.device)
    return time.perf_counter() - t0


def drive_continuous(eng: ContinuousEngine, requests: List[ServeRequest]
                     ) -> Dict[str, float]:
    """Submit each request at its arrival time, run micro-steps until all
    have finished; return latency/throughput stats from the one merged
    surface (:func:`repro_torch.obs.metrics.snapshot`: latency
    percentiles, KV/prefix/spec accounting and, when the registry is
    live, its counters, gauges and histograms) and the trial's residuals
    when the tracer is live."""
    makespan = _drive_wall_clock(eng, requests)
    toks = sum(useful_tokens(r.output[:r.generated], eng.eos_id)
               for r in requests)
    stats = obs_metrics.snapshot(engine=eng)
    stats.update(makespan_s=makespan, useful_tokens=float(toks),
                 tok_s=toks / makespan,
                 eager_admits=float(eng.scheduler.n_eager_admits),
                 deferred=float(eng.scheduler.n_deferred),
                 block_deferrals=float(eng.scheduler.n_block_deferrals),
                 modeled_admit_cost_us=1e6
                 * eng.scheduler.modeled_admit_cost_s)
    _attach_telemetry(stats)
    return stats


def drive_static(eng: StaticEngine, requests: List[ServeRequest],
                 batch_size: int) -> Dict[str, float]:
    """Static-batch baseline: wait for ``batch_size`` arrivals, prefill
    them together, decode the whole batch to the slowest member. Requests
    are bucketed by prompt length (a static batch needs rectangular
    prompts), batches form FIFO within a bucket and run in order of their
    last member's arrival. The last partial batch is padded (repeat of its
    final row) to the batch shape; padding rows are not counted. Sampling
    is per-row; heterogeneous seeds in one group cannot be honored and
    raise."""
    reqs = sorted(requests, key=lambda r: r.arrival)
    n = len(reqs)
    buckets: Dict[int, List[ServeRequest]] = {}
    for r in reqs:
        buckets.setdefault(r.prompt_len, []).append(r)
    groups = [rs[start:start + batch_size]
              for rs in buckets.values()
              for start in range(0, len(rs), batch_size)]
    groups.sort(key=lambda g: max(r.arrival for r in g))
    t0 = time.perf_counter()
    for group in groups:
        latest = max(r.arrival for r in group)
        while time.perf_counter() - t0 < latest:
            time.sleep(1e-3)
        seeds = {r.seed for r in group}
        if len(seeds) > 1:
            raise ValueError("drive_static: heterogeneous seeds in one "
                             f"static batch group: {sorted(seeds)}")
        rows = [r.batch for r in group]
        temps = [r.temperature for r in group]
        while len(rows) < batch_size:          # shape-stable padding
            rows.append(rows[-1])
            temps.append(temps[-1])
        batch = {k: np.concatenate([row[k] for row in rows])
                 for k in rows[0]}
        max_new = max(r.max_new_tokens for r in group)
        out = eng.generate(batch, max_new,
                           temperature=np.asarray(temps, np.float32),
                           seed=group[0].seed)
        now = time.perf_counter() - t0
        for j, r in enumerate(group):
            r.output = out[j, :r.max_new_tokens].copy()
            r.generated = useful_tokens(r.output, eng.eos_id)
            r.finish_time = now
    makespan = time.perf_counter() - t0
    toks = sum(r.generated for r in reqs)
    lat = np.array([r.finish_time - r.arrival for r in reqs])
    return {"n": float(n), "makespan_s": makespan,
            "useful_tokens": float(toks), "tok_s": toks / makespan,
            "batches": float(len(groups)),
            "latency_p50_s": float(np.percentile(lat, 50)),
            "latency_p95_s": float(np.percentile(lat, 95)),
            "latency_mean_s": float(lat.mean())}


def _rows(reqs: List[ServeRequest]) -> List[np.ndarray]:
    """Each request's generated tokens."""
    return [r.output[:r.generated] for r in reqs]


def _identical(a, b) -> bool:
    """Two sets of output rows are token-identical."""
    return bool(all(np.array_equal(x, y) for x, y in zip(a, b)))


def _equal_share(a, b) -> float:
    """Share of equal tokens, position by position, between two sets of
    output rows; a length mismatch counts as unequal tokens."""
    same = total = 0
    for x, y in zip(a, b):
        m = min(len(x), len(y))
        same += int((np.asarray(x[:m]) == np.asarray(y[:m])).sum())
        total += max(len(x), len(y))
    return same / max(1, total)


def _drafter(draft_arch: str, arch: str, smoke: bool, serve_cfg, device,
             seed: int):
    """The speculative arm's drafter: ``(None, None)`` for ``"self"`` (or
    the target's own arch), else that config's model and its seeded
    parameters. The engine decides whether it can draft (its capability
    and a vocabulary equal to the target's)."""
    if draft_arch in ("self", arch):
        return None, None
    dcfg = get_smoke_config(draft_arch) if smoke else get_config(draft_arch)
    dmodel = build_model(dcfg, serve_cfg, device=device)
    return dmodel, dmodel.init(seed)


def run_traffic(arch: str = "gemma-2b", *, smoke: bool = True,
                device="cuda", requests: int = 12, slots: int = 4,
                prompt_len=16, max_new=(4, 32), arrival: str = "poisson",
                rate: float = 50.0, burst: int = 4, temperature: float = 0.0,
                engine: str = "both", ring: bool = False, eos_id: int = -1,
                seed: int = 0, parity_check: bool = True,
                prefill_chunk: int = 64, max_prefill_per_step: int = 2,
                chunk_compare: bool = True, paged_compare: bool = True,
                block_size: int = 16, prefix_compare: bool = True,
                shared_prefix_len: int = 0, share_ratio: float = 0.9,
                spec_compare: bool = True, speculate: int = 3,
                draft_arch: str = "self", dtype: Optional[str] = None,
                params=None, layers: Optional[int] = None) -> Dict:
    """Build the model once, warm each engine off the clock, then drive a
    trace (``arrival``: ``"poisson"`` at ``rate``, ``"burst"`` of
    ``burst`` at 1/rate spacing, or ``"all"``; every request sampled at
    ``temperature``, 0 = greedy) through the requested engine(s). Returns
    the full measurement dict (the reference's keys, plus the port's
    ``backend``, ``device``, ``kernels``, per-arm outputs and equal-token
    shares).

    ``prompt_len`` is an int or a sequence cycled across the trace (e.g.
    ``(16, 256)`` interleaves short and long prompts). With
    ``chunk_compare`` the continuous engine runs chunked and again
    monolithic (``prefill_chunk=0``), recording the TTFT comparison. With
    ``paged_compare`` it runs once more over a paged pool sized to the
    slot pool's token budget (``slots * cache_len`` tokens in
    ``block_size``-token blocks, request rows no longer the scarce
    resource): token identity against the slot run, bytes per resident
    token and peak concurrency at equal HBM. ``parity_check`` runs one
    batch of the longest prompt through static, continuous and paged
    engines.

    With ``spec_compare`` (a greedy trace on a family with the
    'speculative' capability) the trace runs once more through a paged
    engine at the equal-HBM pool with ``speculate`` draft tokens a
    round: ``draft_arch="self"``
    self-speculates, another dense config drafts from its own seeded
    parameters. The result records ``spec_tok_s``, accepted tokens per
    dispatch and token identity with the non-speculative paged run.
    With ``prefix_compare`` (a family with the 'prefix_cache'
    capability) a shared-prefix trace (``shared_prefix_len`` template
    tokens, by default 3/4 of the longest prompt rounded down to
    blocks; ``share_ratio`` of the requests in one of two template
    families) runs through a paged engine without the radix cache, with
    it cold, and with it warm (``reset(preserve_prefix=True)``); all
    three must be token-identical, and the warm run's hit rate and
    prefill work saved are reported. With ``ring`` the cache is bounded
    by the family's sliding window (a ring buffer on the slot layout;
    paged arms cannot hold a prompt longer than it and raise at submit,
    as the reference's do).

    ``params`` replaces the seeded random parameters (the tests move the
    reference's over). ``layers`` cuts the depth (:func:`arch_config`).
    ``dtype`` is the parameter and compute dtype: float32 at the smoke
    configs and bfloat16 at full width unless given. The kernel counters are zeroed at the start and cover the
    whole run, warm-ups included; each continuous arm's ``kernels``
    counts its measured drive alone. The cache holds the longest prompt,
    the frontend's prepended tokens (patch_stub) and ``max_new``."""
    if engine not in ("static", "continuous", "both"):
        raise ValueError(f"unknown engine {engine!r} "
                         "(static, continuous or both)")
    cfg = arch_config(arch, smoke, layers)
    dtype = dtype or ("float32" if smoke else "bfloat16")
    serve_cfg = ServeConfig(param_dtype=dtype, compute_dtype=dtype,
                            attn_chunk_threshold=4096, ring_buffer=ring)
    model = build_model(cfg, serve_cfg, device=device)
    dev = model.device
    caps = model.capabilities
    prefill_chunk = effective_chunk(caps, prefill_chunk)
    slot_chunk = prefill_chunk if caps.slot_chunk else 0
    if params is None:
        params = model.init(seed)
    plens = ((int(prompt_len),) if isinstance(prompt_len, int)
             else tuple(int(p) for p in prompt_len))
    pmax = max(plens)
    hi = max_new if isinstance(max_new, int) else max_new[1]
    # a ring cache holds the sliding window, no more
    cache_len = cache_len_for(
        cfg, ShapeConfig("serve", sequence_len(cfg, pmax) + hi, slots,
                         "decode"), serve_cfg)
    reset_kernel_counters()

    trace = make_trace(requests, prompt_len=plens, max_new=max_new,
                       arrival=arrival, rate=rate, burst=burst,
                       temperature=temperature, seed=seed)
    result: Dict = {"backend": "torch", "arch": cfg.name,
                    "layers": cfg.num_layers, "device": device_info(dev),
                    "torch_version": torch.__version__,
                    "cuda_version": torch.version.cuda, "dtype": dtype,
                    "requests": requests, "slots": slots,
                    "prompt_len": list(plens), "cache_len": cache_len,
                    "ring": ring,
                    "arrival": arrival, "rate": rate, "eos_id": eos_id,
                    "prefill_chunk": 0,     # effective value set below
                    "max_prefill_per_step": max_prefill_per_step,
                    "distinct_prompt_lens": len(set(plens)),
                    # eager PyTorch compiles no programs; the fields stay
                    # for schema parity with the reference's artifact
                    "prefill_compiles": None,
                    "prefill_compiles_prompt_len_independent": None,
                    "outputs_by_arm": {}}
    warm = synthetic_batch(cfg, 1, plens[0], seed)

    def _make_engine(chunk: int, kv_layout: str = "slot", num_blocks=None,
                     n_rows=None, **kw):
        eng = ContinuousEngine(
            model, params, cache_len=cache_len, num_slots=n_rows or slots,
            eos_id=eos_id, prefill_chunk=chunk,
            max_prefill_per_step=max_prefill_per_step, kv_layout=kv_layout,
            block_size=block_size, num_blocks=num_blocks, device=dev, **kw)
        # warm on one prompt shape off the clock (kernel build and load,
        # library handles), then a clean engine for the measured drive
        eng.generate({k: np.concatenate([v] * min(2, eng.kv.num_slots))
                      for k, v in warm.items()}, 2)
        eng.reset()
        return eng

    def _measure(eng, tr):
        """Drive the trace ``tr``; the stats carry this drive's own
        kernel launch counts, ``paged_mq``'s also by query width K."""
        reqs = requests_from_trace(cfg, tr, seed=seed)
        _sync(dev)
        before = kernel_counters()
        before_k = dict(ops.mq_launches_by_k)
        stats = drive_continuous(eng, reqs)
        stats["kernels"] = {k: v - before[k]
                            for k, v in kernel_counters().items()}
        stats["mq_launches_by_k"] = {
            K: n - before_k.get(K, 0)
            for K, n in sorted(ops.mq_launches_by_k.items())
            if n > before_k.get(K, 0)}
        stats["prefill_chunk"] = float(eng.prefill_chunk)
        stats["prefill_compiles_total"] = None
        stats["prefill_compiles_drive"] = None
        if eng.speculate:
            stats["decode_tokens_per_dispatch"] = \
                eng.decode_tokens_per_dispatch
            stats["spec_rounds"] = float(eng.spec_rounds)
        return stats, reqs

    def _drive_continuous(chunk: int, kv_layout: str = "slot",
                          num_blocks=None, n_rows=None, **kw):
        return _measure(_make_engine(chunk, kv_layout, num_blocks, n_rows,
                                     **kw), trace)

    def _prefix_compare() -> Dict:
        """One shared-prefix trace through a paged engine without the
        radix cache, then one engine with it, cold and warm
        (``reset(preserve_prefix=True)``: rows drain, the index and the
        pool's contents stay). The pool holds the live requests plus the
        parked index (the templates, every request's private tail and
        headroom), so the run measures hits, not eviction churn."""
        bs, groups = block_size, 2
        spl = (int(shared_prefix_len) if shared_prefix_len > 0
               else (3 * pmax // 4) // bs * bs)
        spl = max(bs, min(spl, pmax - 1))
        tr = make_trace(requests, prompt_len=pmax, max_new=max_new,
                        arrival=arrival, rate=rate, burst=burst,
                        temperature=temperature, shared_prefix_len=spl,
                        share_ratio=share_ratio, prefix_groups=groups,
                        seed=seed)
        nblocks = (slots * -(-cache_len // bs) + groups * -(-spl // bs)
                   + requests * (-(-(pmax - spl) // bs) + 2))
        base_stats, base_reqs = _measure(
            _make_engine(prefill_chunk, "paged", nblocks, slots), tr)
        eng = _make_engine(prefill_chunk, "paged", nblocks, slots,
                           prefix_cache=True)
        cold_stats, cold_reqs = _measure(eng, tr)
        eng.reset(preserve_prefix=True)
        warm_stats, warm_reqs = _measure(eng, tr)
        base, cold, warm = (_rows(r)
                            for r in (base_reqs, cold_reqs, warm_reqs))
        out = {"prefix": {
            "shared_prefix_len": spl, "share_ratio": share_ratio,
            "prefix_groups": groups, "num_blocks": nblocks,
            "prompt_len": pmax, "baseline": base_stats, "cold": cold_stats,
            "warm": warm_stats,
            "outputs_by_arm": {name: [r.tolist() for r in rows]
                               for name, rows in (("baseline", base),
                                                  ("cold", cold),
                                                  ("warm", warm))}}}
        out["prefix_token_identical"] = (_identical(base, cold)
                                         and _identical(base, warm))
        out["prefix_cold_equal_token_share"] = _equal_share(base, cold)
        out["prefix_warm_equal_token_share"] = _equal_share(base, warm)
        for key in ("prefix_hit_rate", "prefill_tokens_saved",
                    "prefill_dispatches_saved"):
            out[key] = warm_stats[key]
        if "ttft_p95_s" in warm_stats and "ttft_p95_s" in cold_stats:
            out["prefix_ttft_p95_improved"] = bool(
                warm_stats["ttft_p95_s"] < cold_stats["ttft_p95_s"])
        return out

    if engine in ("continuous", "both"):
        result["continuous"], slot_reqs = _drive_continuous(slot_chunk)
        slot_rows = _rows(slot_reqs)
        result["outputs_by_arm"]["continuous"] = [r.tolist()
                                                  for r in slot_rows]
        eff_chunk = int(result["continuous"]["prefill_chunk"])
        result["prefill_chunk"] = eff_chunk
        if eff_chunk and chunk_compare:
            result["continuous_monolithic"], mono_reqs = _drive_continuous(0)
            mono_rows = _rows(mono_reqs)
            result["outputs_by_arm"]["continuous_monolithic"] = [
                r.tolist() for r in mono_rows]
            c, m = result["continuous"], result["continuous_monolithic"]
            if "ttft_p95_s" in c and "ttft_p95_s" in m:
                result["ttft_p95_chunked_s"] = c["ttft_p95_s"]
                result["ttft_p95_monolithic_s"] = m["ttft_p95_s"]
                result["chunked_ttft_p95_improved"] = bool(
                    c["ttft_p95_s"] < m["ttft_p95_s"])
            result["monolithic_token_identical_trace"] = _identical(
                slot_rows, mono_rows)
            result["monolithic_equal_token_share"] = _equal_share(
                slot_rows, mono_rows)
        if prefill_chunk and paged_compare and caps.paged_decode:
            # equal-HBM paged run: the slot pool's token capacity
            # repartitioned into leased blocks; request rows stop being
            # the scarce resource, blocks gate admission
            nblocks = max(1, (slots * cache_len) // block_size)
            rows = min(requests, nblocks)
            result["continuous_paged"], paged_reqs = _drive_continuous(
                prefill_chunk, kv_layout="paged", num_blocks=nblocks,
                n_rows=rows)
            paged_rows = _rows(paged_reqs)
            result["outputs_by_arm"]["continuous_paged"] = [
                r.tolist() for r in paged_rows]
            c, p = result["continuous"], result["continuous_paged"]
            result["block_size"] = block_size
            result["paged_num_blocks"] = nblocks
            result["paged_token_identical_trace"] = _identical(slot_rows,
                                                               paged_rows)
            result["paged_equal_token_share"] = _equal_share(slot_rows,
                                                             paged_rows)
            result["paged_hbm_within_budget"] = bool(
                p["kv_bytes_total"] <= c["kv_bytes_total"])
            result["paged_max_concurrency"] = p["peak_concurrent"]
            result["slot_max_concurrency"] = c["peak_concurrent"]
            result["paged_more_concurrent_verified"] = bool(
                p["peak_concurrent"] > c["peak_concurrent"])
            result["paged_bytes_per_resident_token"] = \
                p["kv_bytes_per_resident_token"]
            result["slot_bytes_per_resident_token"] = \
                c["kv_bytes_per_resident_token"]
        result["continuous_tok_s"] = result["continuous"]["tok_s"]
        if (prefill_chunk and spec_compare and speculate > 0
                and temperature == 0.0 and caps.speculative):
            # the same trace and equal-HBM pool as the paged comparison,
            # in draft-verify rounds: greedy tokens must not change (a
            # sampled trace skips the arm, as the reference's does)
            dmodel, dparams = _drafter(draft_arch, arch, smoke, serve_cfg,
                                       dev, seed)
            nblocks = max(1, (slots * cache_len) // block_size)
            result["continuous_spec"], spec_reqs = _drive_continuous(
                prefill_chunk, kv_layout="paged", num_blocks=nblocks,
                n_rows=min(requests, nblocks), speculate=speculate,
                draft_model=dmodel, draft_params=dparams)
            spec_rows = _rows(spec_reqs)
            result["outputs_by_arm"]["continuous_spec"] = [
                r.tolist() for r in spec_rows]
            base = ("continuous_paged" if "continuous_paged" in result
                    else "continuous")
            base_rows = paged_rows if base == "continuous_paged" \
                else slot_rows
            sp = result["continuous_spec"]
            result["speculate_k"] = speculate
            result["draft_arch"] = draft_arch
            result["spec_baseline_arm"] = base
            result["spec_tok_s"] = sp["tok_s"]
            result["continuous_tok_s"] = result[base]["tok_s"]
            result["spec_accepted_per_dispatch"] = \
                sp["accepted_per_dispatch"]
            result["spec_acceptance_rate"] = sp["acceptance_rate"]
            result["spec_token_identical_trace"] = _identical(base_rows,
                                                              spec_rows)
            result["spec_equal_token_share"] = _equal_share(base_rows,
                                                            spec_rows)
        if prefill_chunk and prefix_compare and caps.prefix_cache:
            result.update(_prefix_compare())
        result["ttft_p50_ms"] = 1e3 * result["continuous"]["ttft_p50_s"]
        result["ttft_p95_ms"] = 1e3 * result["continuous"]["ttft_p95_s"]
        result["outputs"] = result["outputs_by_arm"]["continuous"]

    if engine in ("static", "both"):
        seng = StaticEngine(model, params, cache_len=cache_len,
                            eos_id=eos_id, device=dev)
        seng.generate({k: np.concatenate([v] * slots)
                       for k, v in warm.items()}, 2)
        static_reqs = requests_from_trace(cfg, trace, seed=seed)
        _sync(dev)
        result["static"] = drive_static(seng, static_reqs, batch_size=slots)
        static_rows = _rows(static_reqs)
        result["outputs_by_arm"]["static"] = [r.tolist()
                                              for r in static_rows]
        if engine == "both":
            result["static_token_identical_trace"] = _identical(
                slot_rows, static_rows)
            result["static_equal_token_share"] = _equal_share(
                slot_rows, static_rows)

    if engine == "both":
        spd = result["continuous"]["tok_s"] / result["static"]["tok_s"]
        result["speedup_tok_s"] = spd
        result["continuous_faster_verified"] = bool(spd > 1.0)

    if parity_check:
        # parity at the LONGEST prompt length: a multi-chunk deposit must
        # be token-identical to the monolithic static prefill; the decode
        # budget is capped by the trace's max_new ceiling (cache_len)
        B = min(4, slots)
        par_new = min(8, hi)
        prompt = synthetic_batch(cfg, B, pmax, seed + 1)
        s_out = StaticEngine(model, params, cache_len=cache_len,
                             eos_id=eos_id, device=dev).generate(prompt,
                                                                 par_new)
        c_out = ContinuousEngine(
            model, params, cache_len=cache_len, num_slots=B, eos_id=eos_id,
            prefill_chunk=slot_chunk,
            max_prefill_per_step=max_prefill_per_step,
            device=dev).generate(prompt, par_new)
        result["parity_token_identical"] = _identical(s_out, c_out)
        result["parity_equal_token_share"] = _equal_share(s_out, c_out)
        result["parity_prompt_len"] = pmax
        if paged_compare and caps.paged_decode and prefill_chunk:
            p_out = ContinuousEngine(
                model, params, cache_len=cache_len, num_slots=B,
                eos_id=eos_id, prefill_chunk=prefill_chunk,
                max_prefill_per_step=max_prefill_per_step,
                kv_layout="paged", block_size=block_size,
                device=dev).generate(prompt, par_new)
            result["parity_token_identical_paged"] = _identical(s_out,
                                                                p_out)
            result["parity_equal_token_share_paged"] = _equal_share(s_out,
                                                                    p_out)
    _sync(dev)
    result["kernels"] = kernel_counters()
    if dev.type == "cuda":
        result["max_memory_allocated"] = torch.cuda.max_memory_allocated(
            dev)
    return result


def run_serve(arch: str = "gemma-2b", *, smoke: bool = False,
              device="cuda", requests: int = 16, slots: int = 8,
              prompt_len=(16, 256), max_new=(4, 48),
              arrival: str = "poisson", rate: float = 50.0, burst: int = 4,
              temperature: float = 0.0, prefill_chunk: int = 64,
              max_prefill_per_step: int = 2, block_size: int = 16,
              seed: int = 0, layers: Optional[int] = None) -> Dict:
    """Build the model, warm the engine, drive the trace (``arrival``,
    ``rate``, ``burst`` and ``temperature`` as in :func:`run_traffic`);
    return the result dict (``backend: "torch"``). The chunk is floored
    to the family's ``chunk_multiple`` (:func:`effective_chunk`). The
    kernel counters in it (:func:`kernel_counters`) count the measured
    drive only. ``layers`` cuts the depth (:func:`arch_config`)."""
    cfg = arch_config(arch, smoke, layers)
    dtype = "float32" if smoke else "bfloat16"
    model = build_model(cfg, ServeConfig(param_dtype=dtype,
                                         compute_dtype=dtype), device=device)
    prefill_chunk = effective_chunk(model.capabilities, prefill_chunk)
    params = model.init(seed)
    plens = ((int(prompt_len),) if isinstance(prompt_len, int)
             else tuple(int(p) for p in prompt_len))
    hi = max_new if isinstance(max_new, int) else max_new[1]
    cache_len = sequence_len(cfg, max(plens)) + hi
    eng = ContinuousEngine(model, params, cache_len=cache_len,
                           num_slots=slots, prefill_chunk=prefill_chunk,
                           max_prefill_per_step=max_prefill_per_step,
                           kv_layout="paged", block_size=block_size,
                           device=model.device)
    # warm-up off the clock (kernel build and load, library handles),
    # then a clean engine for the measured drive
    eng.generate(synthetic_batch(cfg, min(2, slots), plens[0], seed), 2)
    eng.reset()
    trace = make_trace(requests, prompt_len=plens, max_new=max_new,
                       arrival=arrival, rate=rate, burst=burst,
                       temperature=temperature, seed=seed)
    reqs = requests_from_trace(cfg, trace, seed=seed)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(model.device)
    reset_kernel_counters()
    stats = drive_continuous(eng, reqs)
    result: Dict = {
        "backend": "torch",
        "arch": cfg.name,
        "layers": cfg.num_layers,
        "device": device_info(model.device),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "dtype": dtype,
        "requests": requests, "slots": slots, "prompt_len": list(plens),
        "max_new": list(max_new) if not isinstance(max_new, int) else max_new,
        "arrival": arrival, "rate": rate, "temperature": temperature,
        "cache_len": cache_len,
        "prefill_chunk": eng.prefill_chunk,
        "max_prefill_per_step": eng.max_prefill_per_step,
        "block_size": block_size, "num_blocks": eng.kv.pool.num_blocks,
        "state_bytes_per_slot": eng._carried_state_bytes(),
        "continuous_tok_s": stats["tok_s"],
        "ttft_p50_ms": 1e3 * stats["ttft_p50_s"],
        "ttft_p95_ms": 1e3 * stats["ttft_p95_s"],
        "continuous": stats,
        "kernels": kernel_counters(),
        # eager PyTorch compiles no programs; the field stays for schema
        # parity with the reference's artifact
        "prefill_compiles": None,
        "outputs": [r.output[:r.generated].tolist() for r in reqs],
    }
    if model.device.type == "cuda":
        result["max_memory_allocated"] = torch.cuda.max_memory_allocated(
            model.device)
    return result


def run_family_rows(archs=FAMILY_ARCHS, *, smoke: bool = True,
                    device="cuda", requests: int = 6, slots: int = 4,
                    prompt_len: int = 24, max_new: int = 4,
                    prefill_chunk: int = 16, block_size: int = 8,
                    eos_id: int = -1, seed: int = 0,
                    dtype: Optional[str] = None) -> List[Dict]:
    """Per-family serving rows (``--config``): drive a small same-arrival
    trace through each family's continuous *paged* chunked engine and
    report ``continuous_tok_s`` plus token identity against the family's
    static monolithic baseline, as the reference's. A family the port
    does not serve yet gives a row whose ``"skipped"`` holds the
    ``NotImplementedError`` message; a family whose structure forbids the
    path reports its capability reason. Each served row also carries the
    share of equal tokens and its kernel counters (zeroed at the start of
    the family's drive, read after its static baseline). ``dtype`` is the
    parameter and compute dtype: float32 at the smoke configs and
    bfloat16 at full width unless given."""
    rows: List[Dict] = []
    for arch in archs:
        cfg = get_smoke_config(arch) if smoke else get_config(arch)
        dt = dtype or ("float32" if smoke else "bfloat16")
        model = build_model(cfg, ServeConfig(
            param_dtype=dt, compute_dtype=dt, attn_chunk_threshold=4096),
            device=device)
        caps = model.capabilities
        row: Dict = {"family": cfg.name, "block": cfg.block,
                     "chunked_prefill": bool(caps.chunked_prefill),
                     "paged_decode": bool(caps.paged_decode),
                     "carried_state": bool(caps.carried_state),
                     "prefix_cache": bool(caps.prefix_cache),
                     "kv_migration": bool(caps.kv_migration),
                     "speculative": bool(caps.speculative)}
        chunk = effective_chunk(caps, prefill_chunk)
        if not (chunk and caps.paged_decode):
            row["skipped"] = caps.reason
            rows.append(row)
            continue
        row["prefill_chunk"] = chunk
        row["dtype"] = dt
        params = model.init(seed)
        cache_len = prompt_len + max_new
        trace = make_trace(requests, prompt_len=prompt_len,
                           max_new=max_new, arrival="all", seed=seed)
        reqs = requests_from_trace(cfg, trace, seed=seed)
        eng = ContinuousEngine(model, params, cache_len=cache_len,
                               num_slots=slots, eos_id=eos_id,
                               prefill_chunk=chunk, kv_layout="paged",
                               block_size=block_size, device=model.device)
        _sync(model.device)
        reset_kernel_counters()
        stats = drive_continuous(eng, reqs)
        row["n"] = stats["n"]
        row["continuous_tok_s"] = stats["tok_s"]
        row["ttft_p50_s"] = stats.get("ttft_p50_s")
        row["ttft_p95_s"] = stats.get("ttft_p95_s")
        row["state_bytes_per_slot"] = eng._carried_state_bytes()
        # static monolithic baseline on the same prompts: the greedy
        # tokens must be identical (the family-parity contract)
        batch = {k: np.concatenate([r.batch[k] for r in reqs])
                 for k in reqs[0].batch}
        s_out = StaticEngine(model, params, cache_len=cache_len,
                             eos_id=eos_id, device=model.device).generate(
            batch, max_new)
        _sync(model.device)
        row["kernels"] = kernel_counters()
        cont = _rows(reqs)
        static = [s_out[j, :r.generated] for j, r in enumerate(reqs)]
        row["static_tok_identical"] = _identical(static, cont)
        row["static_equal_token_share"] = _equal_share(static, cont)
        row["outputs"] = [r.tolist() for r in cont]
        rows.append(row)
    return rows


def drive_fabric(fab: ServingFabric, requests: List[ServeRequest]
                 ) -> Dict[str, float]:
    """The wall-clock traffic loop through the serving fabric (router
    dispatch, every rank's micro-step, migration): latency, TTFT and
    throughput over every finished request, the router's census, the
    per-rank rows and (disaggregated) the migration accounting."""
    makespan = _drive_wall_clock(fab, requests)
    eos = fab.workers[0].engine.eos_id
    toks = sum(useful_tokens(r.output[:r.generated], eos) for r in requests)
    stats = obs_metrics.snapshot(extra=fab.stats())
    stats.update(makespan_s=makespan, useful_tokens=float(toks),
                 tok_s=toks / makespan)
    _attach_telemetry(stats)
    return stats


def _warm_fabric(fab: ServingFabric, cfg, *, seed: int,
                 prompt_len: int) -> None:
    """Warm every rank off the clock (kernel build and load, the chunk
    and decode paths, and on the disaggregated path the migration and
    the state import), then reset the whole fabric: warm requests leave
    no queue entries, leases, decode state or accounting behind."""
    trace = make_trace(2 * fab.ranks, prompt_len=prompt_len, max_new=2,
                       arrival="all", seed=seed + 7)
    for req in requests_from_trace(cfg, trace, seed=seed + 7):
        fab.submit(req, 0.0)
    guard = 0
    while not fab.idle:
        fab.step(0.0)
        guard += 1
        if guard > 10_000:
            raise RuntimeError("fabric warm-up failed to drain")
    fab.reset()


def run_fabric(arch: str = "gemma-2b", *, smoke: bool = True,
               device="cuda", requests: int = 16, ranks: int = 2,
               slots: int = 4, prompt_len=(16, 256), max_new=(4, 32),
               arrival: str = "poisson", rate: float = 50.0,
               burst: int = 4, temperature: float = 0.0, eos_id: int = -1,
               seed: int = 0, prefill_chunk: int = 64,
               max_prefill_per_step: int = 2, block_size: int = 16,
               placements=("replicated", "disagg"),
               n_prefill_ranks: int = 1, speculate: int = 0,
               dtype: Optional[str] = None, params=None,
               layers: Optional[int] = None) -> Dict:
    """Fabric against one engine: drive the same arrival trace through a
    single paged ``ContinuousEngine`` of one rank's size, then through an
    N-rank :class:`~repro_torch.serve.fabric.ServingFabric` under each
    placement in ``placements``. Records tok/s and TTFT p50/p95 per
    placement, per-rank utilization, the disaggregated path's migration
    accounting, and the token identity of each placement against the
    single engine (every rank runs the same chunked paged engine, so
    placement must not change a token; a sampled request's generator
    migrates with it). ``speculate`` > 0 makes the replicated ranks
    speculative (greedy traces only). The reference's keys, plus the
    port's ``backend``, ``layers``, ``device``, ``torch_version``,
    ``cuda_version``, ``dtype``, ``kernels`` (the launch counts of the
    measured drives summed; each measured drive's stats carry its own,
    counted from zero just before it, so no warm-up is in them) and
    ``fabric_equal_token_share_<placement>``.

    ``params`` replaces the seeded random parameters; ``layers`` cuts
    the depth (:func:`arch_config`); ``dtype`` is float32 at the smoke
    configs and bfloat16 at full width unless given."""
    cfg = arch_config(arch, smoke, layers)
    dtype = dtype or ("float32" if smoke else "bfloat16")
    model = build_model(cfg, ServeConfig(param_dtype=dtype,
                                         compute_dtype=dtype,
                                         attn_chunk_threshold=4096),
                        device=device)
    if model.decode_step_paged is None:
        raise ValueError(f"arch {cfg.name!r} has no paged decode path; "
                         "the serving fabric runs paged engines only")
    dev = model.device
    prefill_chunk = effective_chunk(model.capabilities, prefill_chunk)
    if params is None:
        params = model.init(seed)
    plens = ((int(prompt_len),) if isinstance(prompt_len, int)
             else tuple(int(p) for p in prompt_len))
    pmax = max(plens)
    hi = max_new if isinstance(max_new, int) else max_new[1]
    cache_len = pmax + hi

    trace = make_trace(requests, prompt_len=plens, max_new=max_new,
                       arrival=arrival, rate=rate, burst=burst,
                       temperature=temperature, seed=seed)
    result: Dict = {"arch": cfg.name, "requests": requests, "ranks": ranks,
                    "slots_per_rank": slots, "prompt_len": list(plens),
                    "cache_len": cache_len, "arrival": arrival,
                    "rate": rate, "eos_id": eos_id,
                    "prefill_chunk": prefill_chunk,
                    "block_size": block_size,
                    "n_prefill_ranks": n_prefill_ranks,
                    "placements": list(placements),
                    "backend": "torch", "layers": cfg.num_layers,
                    "device": device_info(dev),
                    "torch_version": torch.__version__,
                    "cuda_version": torch.version.cuda, "dtype": dtype}

    def _measure(target, drive):
        reqs = requests_from_trace(cfg, trace, seed=seed)
        _sync(dev)
        reset_kernel_counters()
        stats = drive(target, reqs)
        stats["kernels"] = kernel_counters()
        return stats, reqs

    # -- single-engine baseline (one paged engine, one rank's size) --
    eng = ContinuousEngine(model, params, cache_len=cache_len,
                           num_slots=slots, eos_id=eos_id,
                           prefill_chunk=prefill_chunk,
                           max_prefill_per_step=max_prefill_per_step,
                           kv_layout="paged", block_size=block_size,
                           device=dev)
    warm = synthetic_batch(cfg, 1, plens[0], seed)
    eng.generate({k: np.concatenate([v] * min(2, eng.kv.num_slots))
                  for k, v in warm.items()}, 2)
    eng.reset()
    result["single"], base_reqs = _measure(eng, drive_continuous)
    base_rows = _rows(base_reqs)
    del eng

    # -- fabric runs, one per placement --
    for placement in placements:
        # speculative ranks are replicated-only (a decode rank imports
        # leases its drafter's pool cannot host) and greedy-only
        spec_k = (speculate if (placement == "replicated"
                                and temperature == 0.0
                                and model.verify_step_paged is not None)
                  else 0)
        result[f"fabric_speculate_k_{placement}"] = spec_k
        fab = ServingFabric(model, params, ranks=ranks,
                            placement=placement, cache_len=cache_len,
                            slots_per_rank=slots, eos_id=eos_id,
                            prefill_chunk=prefill_chunk,
                            max_prefill_per_step=max_prefill_per_step,
                            block_size=block_size,
                            n_prefill_ranks=n_prefill_ranks,
                            speculate=spec_k, device=dev)
        try:
            _warm_fabric(fab, cfg, seed=seed, prompt_len=plens[0])
            stats, reqs = _measure(fab, drive_fabric)
            rows = _rows(reqs)
            result[f"fabric_{placement}"] = stats
            result[f"fabric_token_identical_{placement}"] = _identical(
                base_rows, rows)
            result[f"fabric_equal_token_share_{placement}"] = _equal_share(
                base_rows, rows)
            spd = stats["tok_s"] / result["single"]["tok_s"]
            stats["speedup_vs_single"] = spd
            result[f"speedup_vs_single_{placement}"] = spd
        finally:
            fab.close()
    result["kernels"] = {k: sum(result[name]["kernels"][k] for name in (
        "single", *(f"fabric_{p}" for p in placements)))
        for k in result["single"]["kernels"]}
    return result


def print_fabric(result: Dict) -> None:
    """Human-readable summary of a :func:`run_fabric` result."""
    print(f"arch={result['arch']} layers={result['layers']} "
          f"device={result['device']['name']} dtype={result['dtype']} "
          f"requests={result['requests']} ranks={result['ranks']} "
          f"slots/rank={result['slots_per_rank']} "
          f"prompt_len={result['prompt_len']}", flush=True)
    for name in ("single", "fabric_replicated", "fabric_disagg"):
        if name not in result:
            continue
        m = result[name]
        print(f"{name:>18}: {m['tok_s']:9.2f} tok/s  makespan "
              f"{m['makespan_s']:.3f} s  latency p50 "
              f"{m['latency_p50_s'] * 1e3:.2f} ms p95 "
              f"{m['latency_p95_s'] * 1e3:.2f} ms  ttft p50 "
              f"{m['ttft_p50_s'] * 1e3:.2f} ms p95 "
              f"{m['ttft_p95_s'] * 1e3:.2f} ms", flush=True)
        for row in m.get("per_rank", ()):
            print(f"{'':>18}  rank {row['rank']} [{row['role']:>7}] util "
                  f"{row['utilization']:.3f}  dispatched "
                  f"{row['dispatched']:.0f}  migrated "
                  f"{row['migrated_in']:.0f} in / "
                  f"{row['migrated_out']:.0f} out  tokens "
                  f"{row['tokens']:.0f}", flush=True)
        if "n_migrations" in m:
            print(f"{'':>18}  kv_migration: {m['n_migrations']:.0f} "
                  f"handoffs, {m['blocks_moved']:.0f} blocks, "
                  f"{m['bytes_moved']:.0f} bytes, modeled "
                  f"{m['kv_migration_us_per_block']:.4f} us a block",
                  flush=True)
    for p in result["placements"]:
        print(f"   token_identical[{p}]="
              f"{result.get(f'fabric_token_identical_{p}')} (equal share "
              f"{result.get(f'fabric_equal_token_share_{p}', 0.0):.3f})  "
              f"speedup_vs_single[{p}]="
              f"{result.get(f'speedup_vs_single_{p}', 0.0):.3f}x  "
              f"speculate_k={result.get(f'fabric_speculate_k_{p}')}",
              flush=True)
    print("kernels: " + json.dumps(result["kernels"]), flush=True)


def print_family_rows(rows: List[Dict]) -> None:
    for row in rows:
        if "skipped" in row:
            print(f"{row['family']:>14}: skipped ({row['skipped']})",
                  flush=True)
            continue
        print(f"{row['family']:>14}: {row['continuous_tok_s']:8.1f} tok/s  "
              f"chunk {row['prefill_chunk']}  "
              f"state_bytes/slot {row['state_bytes_per_slot']}  "
              f"token_identical={row['static_tok_identical']} "
              f"(equal share {row['static_equal_token_share']:.3f})",
              flush=True)


ARMS = ("static", "continuous_monolithic", "continuous",
        "continuous_paged", "continuous_spec")


def print_traffic(result: Dict) -> None:
    """Human-readable summary of a :func:`run_traffic` result."""
    print(f"arch={result['arch']} layers={result['layers']} "
          f"device={result['device']['name']} "
          f"requests={result['requests']} slots={result['slots']} "
          f"cache_len={result['cache_len']} "
          f"prompt_len={result['prompt_len']} "
          f"prefill_chunk={result['prefill_chunk']}", flush=True)
    for name in ARMS:
        if name not in result:
            continue
        m = result[name]
        ttft = (f"  ttft p50 {m['ttft_p50_s'] * 1e3:.2f} ms "
                f"p95 {m['ttft_p95_s'] * 1e3:.2f} ms"
                if "ttft_p95_s" in m else "  ttft not measured")
        print(f"{name:>21}: {m['tok_s']:9.2f} tok/s  "
              f"makespan {m['makespan_s']:.3f} s  "
              f"latency p50 {m['latency_p50_s'] * 1e3:.2f} ms "
              f"p95 {m['latency_p95_s'] * 1e3:.2f} ms{ttft}", flush=True)
    keys = ("speedup_tok_s", "continuous_faster_verified",
            "chunked_ttft_p95_improved", "paged_more_concurrent_verified",
            "paged_max_concurrency", "slot_max_concurrency",
            "paged_hbm_within_budget", "parity_token_identical",
            "parity_token_identical_paged", "paged_token_identical_trace",
            "monolithic_token_identical_trace",
            "static_token_identical_trace", "parity_equal_token_share",
            "parity_equal_token_share_paged", "paged_equal_token_share",
            "monolithic_equal_token_share", "static_equal_token_share",
            "speculate_k", "draft_arch", "spec_tok_s",
            "spec_accepted_per_dispatch", "spec_acceptance_rate",
            "spec_token_identical_trace", "spec_equal_token_share",
            "prefix_token_identical", "prefix_hit_rate",
            "prefill_tokens_saved", "prefill_dispatches_saved",
            "prefix_ttft_p95_improved", "prefix_cold_equal_token_share",
            "prefix_warm_equal_token_share")
    print("flags: " + json.dumps({k: result[k] for k in keys
                                  if k in result}), flush=True)
    if "prefix" in result:
        pfx = result["prefix"]
        print(f"prefix: shared_prefix_len {pfx['shared_prefix_len']}, "
              + ", ".join(
                  f"{name} {pfx[name]['tok_s']:.2f} tok/s ttft p95 "
                  f"{pfx[name]['ttft_p95_s'] * 1e3:.2f} ms"
                  for name in ("baseline", "cold", "warm")), flush=True)
    print("kernels: " + json.dumps(result["kernels"]), flush=True)


def _collect_reports(obj) -> List[dict]:
    """Every sub-run residual report nested anywhere in a payload (the
    drivers stamp one per measured trial)."""
    reps: List[dict] = []
    if isinstance(obj, dict):
        rep = obj.get("residual_report")
        if isinstance(rep, dict):
            reps.append(rep)
        for v in obj.values():
            if isinstance(v, (dict, list)):
                reps.extend(_collect_reports(v))
    elif isinstance(obj, list):
        for v in obj:
            reps.extend(_collect_reports(v))
    return reps


def _finalize_payload(payload: Dict) -> Dict:
    """The reference's v8 keys: every sub-run's residual report merged
    into one payload-level ``residual_report``, with flat
    ``residual_<hop>_ratio`` keys and the summed ``serialization_stall_s``
    (all absent when telemetry was off)."""
    reps = _collect_reports(payload)
    if reps:
        merged = obs_residuals.merge_reports(reps)
        payload["residual_report"] = merged
        for kind, row in merged["hops"].items():
            if row["n"]:
                payload[f"residual_{kind}_ratio"] = row["ratio"]
        payload["serialization_stall_s"] = merged["serialization_stall_s"]
    return payload


def _write_trace(path) -> None:
    """``--trace-out``: export the tracer's ring as Chrome trace_event
    JSON (Perfetto / chrome://tracing)."""
    if not path:
        return
    tr = obs_trace.active()
    if tr is None:
        print(f"--trace-out {path}: tracing is off (set REPRO_TRACE=1)")
        return
    tr.write_chrome(path)
    print(f"wrote {path} ({tr.n_events} events, {tr.dropped} dropped)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gemma-2b", choices=list(ARCH_NAMES))
    ap.add_argument("--config", default=None, metavar="NAME[,NAME...]",
                    help="per-family serving rows: drive each named "
                         "registry config (or 'families' = one per "
                         "serving structure) through the continuous paged "
                         "engine instead of the engine comparison")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to the first N blocks, widths as "
                         "published (a model too large for the card)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--engine", default="both",
                    choices=("static", "continuous", "both"))
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--prompt-len", default="16,256", metavar="N[,N...]")
    ap.add_argument("--max-new-lo", type=int, default=4)
    ap.add_argument("--max-new-hi", type=int, default=48)
    ap.add_argument("--arrival", default="poisson",
                    choices=("poisson", "burst", "all"))
    ap.add_argument("--rate", type=float, default=50.0,
                    help="arrival rate (req/s); burst spacing is 1/rate")
    ap.add_argument("--burst", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature of every request (0 = "
                         "greedy; the speculative arm needs greedy)")
    ap.add_argument("--prefill-chunk", type=int, default=64)
    ap.add_argument("--max-prefill-per-step", type=int, default=2)
    ap.add_argument("--no-chunk-compare", action="store_true")
    ap.add_argument("--kv-block-size", type=int, default=16)
    ap.add_argument("--no-paged-compare", action="store_true")
    ap.add_argument("--ring", action="store_true",
                    help="ring-buffer slot caches bounded by the sliding "
                         "window (the paged arms cannot hold a longer "
                         "prompt: pair with --no-paged-compare)")
    ap.add_argument("--no-spec-compare", action="store_true",
                    help="skip the speculative-decoding arm")
    ap.add_argument("--speculate", type=int, default=3,
                    help="draft tokens a draft-verify round")
    ap.add_argument("--draft-arch", default="self",
                    help="the drafter: 'self' or another config with the "
                         "target's vocabulary")
    ap.add_argument("--no-prefix-compare", action="store_true",
                    help="skip the shared-prefix trace without, cold and "
                         "warm with the radix prefix cache")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="template tokens of the shared-prefix trace (0 = "
                         "3/4 of the longest prompt, in whole blocks)")
    ap.add_argument("--share-ratio", type=float, default=0.9)
    ap.add_argument("--fabric", default="off",
                    choices=("off", "replicated", "disagg", "both"),
                    help="run the multi-rank serving fabric comparison "
                         "instead of the engine comparison")
    ap.add_argument("--ranks", type=int, default=2,
                    help="engine ranks in the serving fabric")
    ap.add_argument("--prefill-ranks", type=int, default=1,
                    help="dedicated prefill ranks (disaggregated fabric)")
    ap.add_argument("--fabric-speculate", type=int, default=0,
                    help="draft tokens a round on the fabric's replicated "
                         "ranks (0 = off; greedy traces only)")
    ap.add_argument("--eos-id", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None, metavar="PATH")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the telemetry ring as Chrome trace_event "
                         "JSON for Perfetto (needs REPRO_TRACE=1)")
    args = ap.parse_args(argv)
    plens = tuple(int(p) for p in args.prompt_len.split(","))
    if args.config is not None:
        archs = (FAMILY_ARCHS if args.config in ("families", "all")
                 else tuple(x for x in args.config.split(",") if x))
        for a in archs:
            if a not in ARCH_NAMES:
                ap.error(f"--config: unknown arch {a!r} "
                         f"(known: {sorted(ARCH_NAMES)})")
        rows = run_family_rows(
            archs, smoke=args.smoke, device=args.device,
            requests=args.requests, slots=args.slots, prompt_len=plens[0],
            max_new=args.max_new_hi, prefill_chunk=args.prefill_chunk,
            block_size=args.kv_block_size, eos_id=args.eos_id,
            seed=args.seed)
        print_family_rows(rows)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(_finalize_payload(
                    {"backend": "torch", "families": rows}), f, indent=1)
        _write_trace(args.trace_out)
        return
    if args.fabric != "off":
        placements = (("replicated", "disagg") if args.fabric == "both"
                      else (args.fabric,))
        result = run_fabric(
            args.arch, smoke=args.smoke, device=args.device,
            requests=args.requests, ranks=args.ranks, slots=args.slots,
            prompt_len=plens[0] if len(plens) == 1 else plens,
            max_new=(args.max_new_lo, args.max_new_hi),
            arrival=args.arrival, rate=args.rate, burst=args.burst,
            temperature=args.temperature, eos_id=args.eos_id,
            seed=args.seed, prefill_chunk=args.prefill_chunk,
            max_prefill_per_step=args.max_prefill_per_step,
            block_size=args.kv_block_size, placements=placements,
            n_prefill_ranks=args.prefill_ranks,
            speculate=args.fabric_speculate, layers=args.layers)
        print_fabric(result)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(_finalize_payload(
                    {"schema": "repro-serve-bench-v8", **result}), f,
                    indent=1)
        _write_trace(args.trace_out)
        return
    result = run_traffic(
        args.arch, smoke=args.smoke, device=args.device,
        requests=args.requests, slots=args.slots,
        prompt_len=plens[0] if len(plens) == 1 else plens,
        max_new=(args.max_new_lo, args.max_new_hi), arrival=args.arrival,
        rate=args.rate, burst=args.burst, temperature=args.temperature,
        engine=args.engine, eos_id=args.eos_id, seed=args.seed,
        prefill_chunk=args.prefill_chunk,
        max_prefill_per_step=args.max_prefill_per_step,
        chunk_compare=not args.no_chunk_compare,
        paged_compare=not args.no_paged_compare,
        block_size=args.kv_block_size, ring=args.ring,
        spec_compare=not args.no_spec_compare, speculate=args.speculate,
        draft_arch=args.draft_arch,
        prefix_compare=not args.no_prefix_compare,
        shared_prefix_len=args.shared_prefix_len,
        share_ratio=args.share_ratio, layers=args.layers)
    print_traffic(result)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(_finalize_payload(result), f, indent=2)
    _write_trace(args.trace_out)


if __name__ == "__main__":
    main()
