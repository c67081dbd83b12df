#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. Environment: Python, torch and CUDA versions, ``nvcc --version``,
   the card's name and power limit.
2. Build: both paged-attention kernels compiled by nvcc for sm_90a from
   ``src/repro_torch/kernels/paged_attention/csrc``.
3. Kernels vs their plain versions (``ref.py``) on the card, at gemma-2b's
   head shapes (H=8, Hkv=1, hd=256, bs=16) — long decode rows, chunks at
   pos0 0/64/192, and the serve phase's own batch and table widths —
   plus a GQA case with a window and a softcap, in float32 and
   bfloat16. Each kernel's time
   (CUDA events, median of 30, L2 flushed before each launch), its bound
   (bytes this run's data needs over 3.35 TB/s, or flops over the peak
   for the dtype), the plain version's time and the time of
   ``F.scaled_dot_product_attention`` on the pre-gathered pages (a
   yardstick only; the port never calls it).
4. Model: full-width gemma-2b in bfloat16 from seed 0; one prefill chunk
   and one decode step on a filled pool, kernel path vs the same step
   through the plain attention.
5. Serve: ``repro_torch.launch.serve.run_serve`` — the paged continuous
   engine answering 16 requests of a mixed 16/256-token Poisson trace —
   with the launch counters zeroed just before and read just after.

The last lines are the kernel table (JSON), the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
CU_SOURCE = "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu"
TPU_KERNELS = {
    "paged_decode":
        "src/repro/kernels/paged_attention/paged_attention.py:57",
    "paged_mq":
        "src/repro/kernels/paged_attention/paged_attention.py:113",
}
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
#: kernel vs plain version, per dtype: float32 sums in another order
#: (the reference's own kernel tolerance); bfloat16 outputs are rounded
#: once on each side from identical float32 math: two bf16 ulps
TOL = {torch.float32: 2e-5, torch.bfloat16: 1.6e-2}
#: full model, bfloat16, 18 layers: max |logit difference| relative to
#: max(1, max |logit|) between the kernel path and the plain path
MODEL_REL_TOL = 3e-2
PARK_POS = -(2 ** 30)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def run(cmd):
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                         check=False)
    require(res.returncode == 0, f"{cmd[0]} failed: {res.stderr.strip()}")
    return res.stdout.strip()


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Median CUDA-event time of one call, with the L2 flushed before each
    (a 256 MB memset, which also covers the call's host-side launch
    cost so the events time the device work)."""

    def __init__(self, dev):
        self.flush = torch.empty(64 * 2 ** 20, dtype=torch.float32,
                                 device=dev)

    def ms(self, fn, iters: int = 30) -> float:
        for _ in range(3):
            fn()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions
# ---------------------------------------------------------------------------

def make_case(dev, dtype, *, B, K, H, Hkv, hd, bs, lengths, parked=(),
              hole=None, padding=(), NB=0, seed=0):
    """Pool, tables and q on the card. ``lengths`` are attention lengths;
    ``parked`` rows get a valid table and a parked (far negative) length,
    ``padding`` rows an all -1 table, ``hole`` = (row, entry) a -1 entry
    inside a live range; ``NB`` widens the tables (trailing -1)."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths, np.int64)
    nbs = [-(-max(int(n), 1) // bs) for n in lengths]
    NB = max(NB, *nbs)
    P = sum(nbs) + 8
    perm = rng.permutation(P)
    tables = np.full((B, NB), -1, np.int32)
    used = 0
    for b in range(B):
        tables[b, :nbs[b]] = perm[used:used + nbs[b]]
        used += nbs[b]
    for b in parked:
        lengths[b] = PARK_POS + 1
    for b in padding:
        tables[b] = -1
    if hole is not None:
        tables[hole[0], hole[1]] = -1
    kp = torch.from_numpy(rng.standard_normal((P, bs, Hkv, hd),
                                              dtype=np.float32))
    vp = torch.from_numpy(rng.standard_normal((P, bs, Hkv, hd),
                                              dtype=np.float32))
    qshape = (B, H, hd) if K == 0 else (B, K, H, hd)
    q = torch.from_numpy(rng.standard_normal(qshape, dtype=np.float32))
    return dict(q=q.to(dev, dtype), k_pages=kp.to(dev, dtype),
                v_pages=vp.to(dev, dtype),
                block_tables=torch.from_numpy(tables).to(dev),
                lengths=torch.from_numpy(lengths.astype(np.int32)).to(dev),
                live=[b for b in range(B)
                      if b not in parked and b not in padding])


def needs(case, window=0):
    """Bytes and flops this case's data needs: each K/V block a live row
    can see read once, q read once, the output written once."""
    q = case["q"]
    K = 1 if q.dim() == 3 else q.shape[1]
    B, H, hd = q.shape[0], q.shape[-2], q.shape[-1]
    _, bs, Hkv, _ = case["k_pages"].shape
    item = q.element_size()
    tables = case["block_tables"].cpu().numpy()
    lengths = case["lengths"].cpu().numpy()
    blocks = 0
    pairs = 0                          # (query, token) pairs attended
    for b in range(B):
        for j in range(K):
            qpos = int(lengths[b]) - K + j
            lo = max(0, qpos - window + 1) if window > 0 else 0
            for t in range(lo, qpos + 1):
                if t // bs < tables.shape[1] and tables[b, t // bs] >= 0:
                    pairs += 1
        last = int(lengths[b]) - 1
        first = max(0, int(lengths[b]) - K - window + 1) if window else 0
        if last >= 0:
            row = tables[b, first // bs:min(tables.shape[1], last // bs + 1)]
            blocks += int((row >= 0).sum())
    nbytes = (2 * q.numel() * item + blocks * 2 * bs * Hkv * hd * item
              + tables.size * 4 + lengths.size * 4)
    flops = 4 * pairs * H * hd
    return nbytes, flops


def library_call(case, window=0, softcap=0.0):
    """F.scaled_dot_product_attention on pages gathered up front into a
    dense (B, H, T, hd) layout, with the same masks; None where SDPA
    cannot express the computation (softcap)."""
    if softcap > 0:
        return None
    q = case["q"]
    multi = q.dim() == 4
    q4 = q if multi else q[:, None]
    B, K, H, hd = q4.shape
    _, bs, Hkv, _ = case["k_pages"].shape
    tables = case["block_tables"].long()
    NB = tables.shape[1]
    flat = tables.clamp(min=0).reshape(-1)
    kg = case["k_pages"][flat].reshape(B, NB * bs, Hkv, hd)
    vg = case["v_pages"][flat].reshape(B, NB * bs, Hkv, hd)
    kg = kg.repeat_interleave(H // Hkv, dim=2).transpose(1, 2).contiguous()
    vg = vg.repeat_interleave(H // Hkv, dim=2).transpose(1, 2).contiguous()
    dev = q.device
    tok = torch.arange(NB * bs, device=dev)[None, None, :]
    qpos = (case["lengths"].long()[:, None] - K
            + torch.arange(K, device=dev)[None, :])[:, :, None]
    ok = (tok <= qpos) & tables.ge(0).repeat_interleave(bs, 1)[:, None, :]
    if window > 0:
        ok = ok & (tok > qpos - window)
    mask = ok[:, None]                                   # (B, 1, K, T)
    qt = q4.transpose(1, 2).contiguous()                 # (B, H, K, hd)
    return lambda: F.scaled_dot_product_attention(qt, kg, vg, attn_mask=mask)


def phase_kernels(dev, timer):
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    lengths16 = np.linspace(1, 560, 16).astype(np.int64)
    specs = []          # (kernel, label, dtype, case kwargs, window, softcap)
    for dtype in (torch.float32, torch.bfloat16):
        specs.append(("paged_decode", "gemma decode", dtype, dict(
            B=16, K=0, H=8, Hkv=1, hd=256, bs=16, lengths=lengths16,
            parked=(3,), hole=(9, 5)), 0, 0.0))
        specs.append(("paged_mq", "gemma chunk", dtype, dict(
            B=4, K=64, H=8, Hkv=1, hd=256, bs=16,
            lengths=[0 + 64, 64 + 64, 192 + 64, 0 + 64], padding=(3,),
            hole=(2, 7)), 0, 0.0))
        specs.append(("paged_decode", "gqa window softcap", dtype, dict(
            B=6, K=0, H=8, Hkv=2, hd=256, bs=16,
            lengths=[1, 17, 100, 300, 421, 560], parked=(0,)), 100, 30.0))
        specs.append(("paged_mq", "gqa window softcap", dtype, dict(
            B=3, K=64, H=8, Hkv=2, hd=256, bs=16,
            lengths=[64, 200, 512]), 100, 30.0))
        # the serve phase's own shapes: 8 rows, 19-entry tables
        # (cache_len 304 / bs 16), prompts of 16 and 256, chunks of 2 rows
        specs.append(("paged_decode", "serve decode", dtype, dict(
            B=8, K=0, H=8, Hkv=1, hd=256, bs=16, NB=19,
            lengths=[17, 40, 100, 257, 270, 290, 300, 303], parked=(2,)),
            0, 0.0))
        specs.append(("paged_mq", "serve chunk", dtype, dict(
            B=2, K=64, H=8, Hkv=1, hd=256, bs=16, NB=19,
            lengths=[64, 256]), 0, 0.0))
        specs.append(("paged_mq", "K=1 vs decode", dtype, dict(
            B=16, K=1, H=8, Hkv=1, hd=256, bs=16, lengths=lengths16,
            parked=(3,), hole=(9, 5)), 0, 0.0))

    table = {k: {"name": k, "route": "cuda", "source": CU_SOURCE,
                 "replaces": TPU_KERNELS[k], "launches": 0,
                 "max_abs_err": 0.0} for k in TPU_KERNELS}
    for kernel, label, dtype, kw, window, softcap in specs:
        case = make_case(dev, dtype, seed=len(label) + kw["B"], **kw)
        args = [case[k] for k in ("q", "k_pages", "v_pages", "block_tables",
                                  "lengths")]
        before = ops.counters()
        out = ops.launch(*args, window=window, softcap=softcap)
        after = ops.counters()
        launched = {"paged_decode": "decode_launches",
                    "paged_mq": "mq_launches"}[kernel]
        require(after[launched] == before[launched] + 1,
                f"{label}: {kernel} was not launched")
        ref = paged_attention_ref(*args, window=window, softcap=softcap)
        torch.cuda.synchronize()
        live = case["live"]
        require(bool(torch.isfinite(out.float()).all()),
                f"{kernel} {label} {dtype}: non-finite output")
        err = (out[live].float() - ref[live].float()).abs()
        tol = TOL[dtype]
        bad = err > tol + tol * ref[live].float().abs()
        max_err = float(err.max())
        print(f"check {kernel:12s} {label:20s} {str(dtype):14s} "
              f"max_abs_err={max_err:.3e} tol={tol:g} "
              f"{'ok' if not bad.any() else 'MISMATCH'}", flush=True)
        require(not bool(bad.any()),
                f"{kernel} {label} {dtype}: disagrees with ref.py")
        if label == "K=1 vs decode":          # out came from paged_mq
            single = ops.launch(args[0][:, 0], *args[1:])
            torch.cuda.synchronize()
            same = torch.equal(single[live], out[live][:, 0])
            print(f"check paged_mq K=1 bit-identical to paged_decode "
                  f"({dtype}): {same}", flush=True)
            require(same, "paged_mq at K=1 differs from paged_decode")
        row = table[kernel]
        row["max_abs_err"] = max(row["max_abs_err"], max_err)
        if dtype == torch.bfloat16 and label.startswith("gemma"):
            nbytes, flops = needs(case, window)
            t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
            t_ops = 1e3 * flops / PEAK_FLOPS[dtype]
            lib = library_call(case, window, softcap)
            row.update(
                shape=label, dtype="bfloat16",
                ms=timer.ms(lambda: ops.paged_attention(*args)),
                plain_ms=timer.ms(lambda: paged_attention_ref(*args)),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=nbytes, bound_flops=flops,
                library_ms=timer.ms(lib) if lib is not None else None)
            print(f"time  {kernel:12s} {label:20s} bf16 ms={row['ms']:.4f} "
                  f"plain_ms={row['plain_ms']:.4f} "
                  f"library_ms={row['library_ms']} "
                  f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}: "
                  f"{nbytes} bytes, {flops} flops)", flush=True)
    return table


# ---------------------------------------------------------------------------
# phase 4: full-width model, kernel path vs plain path
# ---------------------------------------------------------------------------

def phase_model(dev):
    from repro_torch.config import ServeConfig
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.models.registry import build_model

    cfg = get_config("gemma-2b")
    t0 = time.perf_counter()
    model = build_model(cfg, ServeConfig(), device=dev)
    params = model.init(0)
    torch.cuda.synchronize()
    print(f"model {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads}x{cfg.head_dim} heads (kv "
          f"{cfg.num_kv_heads}), d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.param_count() / 1e9:.3f} B params, {model.dtype}, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)

    B, C, bs, NB = 4, 64, 16, 16
    rng = np.random.default_rng(0)
    tables = torch.from_numpy(
        rng.permutation(B * NB).astype(np.int32).reshape(B, NB)).to(dev)
    pool = model.init_paged_cache(B * NB, bs)
    prompts = rng.integers(0, cfg.vocab_size, size=(B, 3 * C))
    n_last = np.array([C, C, C, 40])            # row 3: a partial chunk

    def chunk(pool, off, n_valid, attention=None):
        tok = np.zeros((B, C), np.int64)
        for b in range(B):
            tok[b, :n_valid[b]] = prompts[b, off:off + n_valid[b]]
        kw = {} if attention is None else {"attention": attention}
        return model.prefill_chunk_paged(
            params, pool, torch.from_numpy(tok).to(dev), tables,
            torch.full((B,), off, device=dev),
            torch.from_numpy(n_valid).to(dev), **kw)

    for off in (0, C):
        chunk(pool, off, np.full(B, C))
    ref_pool = {k: v.clone() for k, v in pool.items()}
    logits = chunk(pool, 2 * C, n_last)
    ref_logits = chunk(ref_pool, 2 * C, n_last, paged_attention_ref)
    results = {}
    results["chunk"] = compare("prefill chunk (pos0=128)", logits,
                               ref_logits, cfg)

    tokens = logits.argmax(-1, keepdim=True)
    positions = torch.from_numpy(2 * C + n_last).to(dev)
    ref_pool = {k: v.clone() for k, v in pool.items()}
    dec = model.decode_step_paged(params, pool, tokens, positions, tables)
    ref_dec = model.decode_step_paged(params, ref_pool, tokens, positions,
                                      tables, attention=paged_attention_ref)
    results["decode"] = compare("decode step (pos 192/168)", dec, ref_dec,
                                cfg)

    # one step's device time on the kernel path (re-running a step
    # rewrites the same pool entries with the same values)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    for _ in range(2):
        ev[0].record()
        model.decode_step_paged(params, pool, tokens, positions, tables)
        ev[1].record()
        chunk(pool, 2 * C, n_last)
        ev[2].record()
    torch.cuda.synchronize()
    results["decode_step_ms"] = ev[0].elapsed_time(ev[1])
    results["chunk_step_ms"] = ev[1].elapsed_time(ev[2])
    print(f"model step time (B={B}, kernel path): decode "
          f"{results['decode_step_ms']:.3f} ms, prefill chunk "
          f"{results['chunk_step_ms']:.3f} ms", flush=True)
    results["decode_profile"] = profile_step(
        "decode", lambda: model.decode_step_paged(params, pool, tokens,
                                                  positions, tables),
        results["decode_step_ms"])
    results["chunk_profile"] = profile_step(
        "chunk", lambda: chunk(pool, 2 * C, n_last), results["chunk_step_ms"])
    del model, params, pool, ref_pool
    torch.cuda.empty_cache()
    return results


def profile_step(label, step, step_ms):
    """Where one step's time goes: device kernel time by name
    (torch.profiler) against the step's CUDA-event time; the rest of the
    step the device sat idle, waiting for the host to launch work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()

    def dev_us(e):
        return (getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))

    # device-side events only: a CPU op such as aten::mm also carries the
    # device time of the kernels it launched, which would count twice
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA
               and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    if busy_ms == 0:
        print(f"profile {label}: the profiler saw no device time (not "
              "measured)", flush=True)
        return None
    attn_ms = sum(dev_us(e) for e in kernels
                  if "paged_decode" in e.key or "paged_mq" in e.key) / 1e3
    launches = sum(e.count for e in kernels)
    out = {"step_ms": step_ms, "device_busy_ms": busy_ms,
           "attention_kernel_ms": attn_ms, "device_launches": launches,
           "idle_share": max(0.0, 1.0 - busy_ms / step_ms),
           "top": [(e.key[:60], dev_us(e) / 1e3, e.count) for e in
                   sorted(kernels, key=dev_us, reverse=True)[:6]]}
    print(f"profile {label}: step {step_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({launches} kernels), paged attention "
          f"{attn_ms:.3f} ms, idle share {out['idle_share']:.3f}", flush=True)
    for name, ms, n in out["top"]:
        print(f"profile {label}:   {ms:8.3f} ms  x{n:<4d} {name}", flush=True)
    return out


def compare(label, logits, ref_logits, cfg):
    V = cfg.vocab_size
    a, r = logits[:, :V].float(), ref_logits[:, :V].float()
    require(bool(torch.isfinite(a).all()), f"{label}: non-finite logits")
    rel = float((a - r).abs().max()) / max(1.0, float(r.abs().max()))
    agree = int((a.argmax(-1) == r.argmax(-1)).sum())
    print(f"check model {label}: max|dlogit|/max(1,|logit|)={rel:.3e} "
          f"(tol {MODEL_REL_TOL:g}), argmax agreement {agree}/{a.shape[0]}",
          flush=True)
    require(rel <= MODEL_REL_TOL, f"model {label}: kernel path disagrees "
            "with the plain attention path")
    return {"rel_err": rel, "argmax_agree": agree, "rows": a.shape[0]}


# ---------------------------------------------------------------------------
# phase 5: serve
# ---------------------------------------------------------------------------

def phase_serve():
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.launch.serve import run_serve

    ops.reset_counters()
    res = run_serve("gemma-2b", device="cuda", requests=16, slots=8,
                    prompt_len=(16, 256), max_new=(4, 48), rate=50.0,
                    prefill_chunk=64, max_prefill_per_step=2,
                    block_size=16, seed=0)
    counts = ops.counters()
    vocab = get_config("gemma-2b").vocab_size
    stats = res["continuous"]
    require(stats.get("n") == 16.0, f"served {stats.get('n')} of 16")
    for rid, toks in enumerate(res["outputs"]):
        require(len(toks) > 0, f"request {rid} produced no token")
        require(all(0 <= t < vocab for t in toks),
                f"request {rid}: token out of [0, {vocab})")
    require(counts["decode_launches"] > 0, "decode kernel never launched")
    require(counts["mq_launches"] > 0, "multi-query kernel never launched")
    require(counts["ref_calls"] == 0,
            f"plain attention ran {counts['ref_calls']} times on the card")
    require(counts == res["kernels"], "counter mismatch")
    print(f"serve: {int(stats['n'])} requests, "
          f"{stats['useful_tokens']:.0f} tokens in {stats['makespan_s']:.3f} "
          f"s: {res['continuous_tok_s']:.2f} tok/s, TTFT p50 "
          f"{res['ttft_p50_ms']:.2f} ms p95 {res['ttft_p95_ms']:.2f} ms, "
          f"latency p50 {1e3 * stats['latency_p50_s']:.2f} ms p95 "
          f"{1e3 * stats['latency_p95_s']:.2f} ms, peak concurrent "
          f"{stats['peak_concurrent']:.0f}, max_memory_allocated "
          f"{res['max_memory_allocated']} bytes", flush=True)
    print("serve kernels: " + json.dumps(counts), flush=True)
    return res, counts


def main() -> None:
    require((SRC / "repro_torch").is_dir(),
            "src/repro_torch not found: run from the root of a checkout")
    require(torch.cuda.is_available(), "no CUDA device is available")
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    # phase 1: environment
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader", "--id=0"])
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    print("nvcc: " + run([nvcc, "--version"]).splitlines()[-1], flush=True)
    print(f"card: {smi}", flush=True)

    # phase 2: build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc "
          f"{_build.build_seconds:.1f} s)", flush=True)
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    timer = Timer(dev)
    table = phase_kernels(dev, timer)
    del timer
    torch.cuda.empty_cache()
    model = phase_model(dev)
    res, counts = phase_serve()

    table["paged_decode"]["launches"] = counts["decode_launches"]
    table["paged_mq"]["launches"] = counts["mq_launches"]
    print("model: " + json.dumps(model), flush=True)
    print(json.dumps({"kernels": list(table.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
