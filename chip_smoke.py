#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. Environment: Python, torch and CUDA versions, ``nvcc --version``,
   the card's name and power limit.
2. Build: every kernel (``src/repro_torch/kernels/*/csrc/*.cu``: both
   paged-attention kernels and their combine pass, the flash-attention
   kernel, both msgq message copies, eager and 1-copy, the SSD chunk
   scan and the MoE layer's top-k expert kernels) compiled by nvcc for
   sm_90a, one nvcc per source, all at once;
   ptxas's registers and spills, and the spill bytes summed by source
   (phases 3 and 8(a) print them again per instantiation of the flash
   kernel and the scan, demangled, and carry them in the kernel table).
3. Kernels vs their plain versions (``ref.py``) on the card, in float32
   and bfloat16. Paged attention at gemma-2b's head shapes (H=8, Hkv=1,
   hd=256, bs=16) — long decode rows, chunks at pos0 0/64/192, and the
   serve phase's own batch and table widths — plus a GQA case with a
   window and a softcap, and hymba-1.5b's head shapes (H=25, Hkv=5,
   hd=64) at the serve phase's decode batch (8) and chunk (2 x 128) with
   its 2048 window and without it (global layers), and past the window;
   then both paged kernels at the split boundaries of their launch plan
   (``ops.plan``), at hymba's heads and at hd 128 (H=16, Hkv=2): lengths
   at a split's edge and one either side, a split wholly of -1 entries, a
   split wholly before the window, tables of 163 entries against lengths
   up to 300. Every paged case runs twice and must agree bit for bit
   (the combine pass merges the splits in a fixed order). Flash
   attention at the monolithic prefill's shapes (B=1 and 8 at S=16 and
   256, B=4 at S=256), a ragged length, a q_offset continuation, a
   window, an H = Hkv case and B=1 at S=2048; then hymba's prefill (B=4
   and 8 at S=256, window 2048 and a global layer), past its window, and
   B=2 at S=200 (R = 5 rows that fill no whole 64-row tile); every flash
   case runs twice and must agree bit for bit.
   Each kernel's time (CUDA events, median of 30, L2 flushed and the
   card kept busy by a spin before each launch), its bound (bytes this
   run's data needs over 3.35 TB/s, or flops over the peak for the
   dtype) and its share of that bound, the paged kernels' launch plan
   (and their times with the split aimed at 2, 4 and 8 CTAs an SM), the
   plain version's time and the time of
   ``F.scaled_dot_product_attention`` on the same data (pages gathered up
   front, or kv heads repeated up front; a yardstick only, the port never
   calls it). Then the top-k expert kernels of the dropless MoE layer
   (``kernels/moe``, :func:`phase_moe`): against their plain version at
   olmoe-1b-7b's chunk (T = 4096, K = 8 of 64) and decode (T = 64)
   shapes, dbrx-132b's full width (16 experts, K = 4, d 6144, f 10752)
   and the smoke widths (ragged tiles), bfloat16 and float32, twice bit
   for bit; the dispatch kernel's tables equal to the plain ones; a
   token's output bit for bit alone and among other neighbours; one
   ``moe_apply_dropless`` call under ``torch.cuda.set_sync_debug_mode
   ("error")`` (no host sync), one launch count a call; times at the
   chunk and decode shapes beside the bound and the plain version's.
4. Model: full-width gemma-2b in bfloat16 from seed 0; one paged prefill
   chunk, one paged decode step and one monolithic prefill (B=4, S=256),
   each kernel path vs the same step through the plain attention; a
   profile of one static prefill and one slot decode step. A profile
   fails when a ported kernel launched in the step (by its counter) but
   shows no device time under its CUDA name.
5. Serve: ``repro_torch.launch.serve.run_serve`` — the paged continuous
   engine answering 16 requests of a mixed 16/256-token Poisson trace —
   with the launch counters zeroed just before and read just after.
6. Engine comparison: ``repro_torch.launch.serve.run_traffic`` (the
   launcher's ``--engine both``) at gemma-2b's full width and depth —
   static batches, the slot continuous engine chunked and monolithic,
   the paged engine at equal HBM, and the greedy parity batch — with the
   counters zeroed just before and read just after; every request must
   finish and every monolithic prefill must launch the flash kernel once
   per layer.
7. Threadcomm: (a) both msgq kernels against ``ref.py``, bitwise —
   single messages of 64 B to 4 MiB (bench_p2p's sizes) and ragged ones
   in f32, bf16 and int32, auto and both forced protocols; rounds of 8
   ranks (a ring, a partial round), 0 elements to 256 KiB a rank, and
   the halo exchange's strided planes at 128^3 and 256^3, through the
   eager kernel (4 and 16 KiB cells: the latter the staged 1-copy
   variant) and the 1-copy direct copy, on the
   bulk (16-byte) and vector paths; round programs (every folded
   schedule of (b), one of every combine, chunk rounds of both segment
   combines) in f32 / bf16 / int32 with -0.0, NaN, tiny negatives and
   overflowing int32 sums, and in f16 / f64 / int64, each in ONE launch,
   against ``msgq_program_ref`` — then the empty kernel's time (the
   floor of a launch under this timer), each kernel's time at its path
   shape (an eager 4 KiB ring round, the 1-copy 64 KiB halo round of
   128^3) beside its byte bound, the plain version and one
   ``index_select`` by the inverse permutation, the three copies at the
   4 KiB and 64 KiB rounds, a 256 KiB-a-rank round and a 4 MiB message
   (GB/s and share of 3.35 TB/s), and the host-inclusive time of one
   64-byte message.
   (b) The Comm API on a 2 x 4 threadcomm at 1024 and 65536 f32 a rank:
   every allreduce schedule, hierarchical and hierarchical_tree against
   psum (rtol 1e-5), the bf16 wire, barriers, p2p rings, and the
   ireduce_scatter -> iallreduce -> iallgather pipeline on a "grad" CUDA
   stream, each with the msgq launches its schedule implies (a folded
   collective: one launch; hierarchical_tree: two). Every folded
   collective is also held bitwise to the same collective run round by
   round on the card (``by_rounds``: ``msgq_round`` and the torch ops of
   each step), with the device (CUDA events, L2 flushed) and
   host-inclusive times of both and of the native psum / pmax. (c) The
   PETSc case study: the slab-decomposed 27-point MatMult at 128^3 and
   256^3 on 8 unified ranks against the single-rank oracle (max abs err
   <= 1e-4 x max|y|, two 1-copy launches each) and CG(10) at 128^3
   against ``cg_solve_ref`` (max |x - x_ref| <= 1e-3). The msgq counters
   are zeroed just before (b); the path's launches are the sum of each
   call's own, read around it.
8. The SSM and hybrid families (mamba2-370m, hymba-1.5b). (a) The SSD
   scan kernel against its plain versions (``ssd_chunked_scan``, the
   model path's chunked algorithm, and ``ssd_scan_ref``, the sequential
   recurrence) in float32 and with bfloat16 x: mamba2's heads (H=32,
   p=64, n=128) at S=128/256 and B=1/2/8, hymba's (H=50, p=64, n=16) at
   B=2 S=256, a ragged S=200 and a seeded initial state, every case on
   the chunk grid l=128 with the model's strided views; one call over 256
   tokens against two calls over 128 + 128 threaded through the state,
   bitwise; two rows alone against the same rows inside a batch of 8
   (the kernel splits each (b, h) over CTAs by columns of p, narrower at
   small batch), bitwise; the kernel's time at the path shape (a mamba2
   chunk dispatch: B=2, S=128, with a carried state; at least one CTA an
   SM) beside its bound, its CTAs, column slice and shared memory, the
   plain version's time and no library call (no single PyTorch call
   computes the scan). (b) Each model at its published widths and full depth in
   bfloat16 from seed 0: a monolithic prefill (B=4, S=256), a slot chunk
   and a paged chunk at pos0 0 and 128, a slot and a paged decode step,
   each through the kernels and again through the plain versions (scan
   and attention), logits compared as phase 4 compares gemma's, within
   the larger of its tolerance and 3x the bf16 noise floor (the same step
   through the sequential plain scan against the chunked one); then the
   same steps in float32, kernel path vs plain path within 1e-3; parked
   rows and rows outside a chunk keep their carried state byte for byte;
   mamba2's paged chunk and decode steps timed and profiled. (c)
   ``run_serve`` for each arch (the paged engine, 16 requests of phase
   5's mixed 16/256 trace, chunk 128) and ``run_family_rows`` for both
   (6 requests of 256 tokens, 16 new, against the static monolithic
   baseline), then hymba's row again in float32 (does its chunked stream
   part from the monolithic one without bf16 rounding?); every request
   must finish. (d) Across each serve run the
   scan launches exactly ``num_layers`` x (chunk dispatches + monolithic
   prefills) times and no plain version runs.
9. Speculative decoding, prefix caching and ring-buffer caches. (a)
   ``paged_mq`` at the speculative shapes, float32 and bfloat16: the
   verify (K = 4, k = 3 drafts) and the drafter's resync (K = 2), at
   gemma-2b's heads and at hymba-1.5b's (GQA 25/5, hd 64, window 2048);
   8 rows with 1..K valid queries, whose leases end before their padding
   queries' positions, a parked row, and (gemma) queries past the
   table's width; against the plain version and the split emulation
   (``paged_attention_split_ref``), twice bit for bit; the bfloat16 cases
   timed against their byte bound and SDPA on the same gathered K/V. (b)
   gemma-2b at full width, in float32 and in bfloat16: one verify step
   through the kernels against the plain attention; then
   ``run_traffic`` with the speculative arm (k = 3, self-drafted) beside
   the plain paged arm and the prefix comparison (3/4 of the longest
   prompt shared by 2 template groups, share 0.9: no cache, cold, warm),
   8 requests of the mixed 16/256 trace; every arm's launches exact
   (``paged_mq`` once a layer per chunk, resync and verify forward;
   ``paged_decode`` once a layer per drafter step); accepted tokens per
   dispatch above 1 and a warm hit rate and saved dispatches above 0;
   float32 streams token-identical (bfloat16 shares reported). (c)
   hymba-1.5b with a ring cache of its window: a monolithic prefill of
   2600-token prompts through the kernels against the plain path, logits
   and the rotated cache, its flash and scan launches and peak memory;
   ``run_traffic(ring=True)`` on the slot engines in float32, where the
   static and monolithic slot arms must emit the same tokens. The
   phase's seconds are printed.
10. The model families. (a) The attention kernels at the new shapes
   against their plain versions, float32 and bfloat16, twice bit for
   bit: ``paged_decode`` and ``paged_mq`` at hd 128 with (H, Hkv) =
   (40, 8), (32, 4), (16, 16), (48, 8) (qwen3 / qwen2.5, yi, olmoe,
   dbrx) at the serving runs' widths (8 decode rows, one parked,
   17-entry tables; chunks of 2 x 64); flash causal at qwen3's static
   batch (B=8, S=256) and internvl2's 256 patch + 128 text tokens, and
   non-causal at whisper-tiny's encoder (B=2, 1500 x 1500, 6/6, hd 64)
   and cross-attention (Sq = 1 and 64 against Sk = 1500: too few work
   items to fill the card, so each splits its key stages across CTAs,
   ``flash_ops.splits_for``); bf16 timed against the bound and SDPA. (b) qwen3-14b, olmoe-1b-7b and
   whisper-tiny at full width and depth in bf16 from seed 0: paged
   chunks and a decode step (whisper: the encoder pre-chunk, a decoder
   chunk, a decode step) and a monolithic prefill, kernel path vs plain
   path under phase 4's rule; qwen3's and olmoe's paged decode step
   profiled. (c) ``run_traffic`` (every arm the family's capabilities
   allow, 6 requests of 16/128 tokens) on the same three in bf16 (equal
   shares printed) and float32 (every arm token-identical);
   ``run_family_rows`` over all five families; ``run_serve`` on yi-9b
   and qwen2.5-14b; internvl2-76b cut to 20 of 80 layers
   (``run_traffic``: static and slot monolithic) and dbrx-132b to 8 of
   40 (``run_serve``): neither fits one card whole. Every run's flash
   launches are exactly what its forwards imply (an encoder-decoder's
   encoder passes, static prefills, chunks and decode forwards), the
   paged kernels launch wherever a run pages, and no plain version runs.
11. The engine's comm binding, burst and sampled traces, and tracing, on
   gemma-2b at full width in bfloat16 from seed 0. (a) The paged engine
   bound to a one-rank threadcomm on the card (its prefill, decode,
   draft and verify streams CUDA streams) against an unbound one, on 8
   requests of phase 5's 16/256 Poisson trace replayed on a step clock:
   per step the same block tables, admissions, finishes and tokens, the
   final K/V pools equal bit for bit, the same ``paged_decode`` and
   ``paged_mq`` launches (each launched, no plain version); again with
   ``speculate=3`` (the drafter's pool too). (b) A burst trace (4 at a
   time, 1/50 s apart) sampled at temperature 0.8 twice through the
   bound engine: the same tokens (each request has its own generator),
   and the admissions and tables of the greedy run of the same trace
   (``eos_id=-1``). (c) ``run_traffic(engine="continuous")`` on the same
   trace, untraced, then under ``repro_torch.obs.install()``: the Chrome
   trace written (``_write_trace``) and parsed, with ``prefill_chunk``
   and ``decode`` spans, ``admit`` instants, ``hop:admission`` spans
   carrying their residuals, ``block_pool`` counters and no dropped
   event; the payload's ``residual_admission_ratio`` and
   ``serialization_stall_s``. Printed, not gated: the event count, the
   residual ratio of each hop kind, one untraced and one traced decode
   step of the bound engine profiled, tok/s with tracing off and on, and
   the phase's seconds.
12. The serving fabric (a router rank and two engine ranks of 4 rows on
   threads, ``repro_torch.serve.fabric``) on gemma-2b at full width from
   seed 0, on 16 requests of phase 5's mixed 16/256 Poisson trace (50
   req/s, 4-48 new tokens), chunk 64, 16-token blocks. (a) Float32:
   ``run_fabric`` (the launcher's ``--fabric both``), the replicated and
   the disaggregated placement each token-identical to the single
   engine; 16 migrations of sum(ceil(prompt_len / 16)) blocks; the
   prefill rank emits no token; a lease leaked at any close fails. (b)
   The disaggregated fabric driven once under a fresh tracer: no
   ``decode`` span on the prefill rank's lane, no ``prefill_chunk`` on
   the decode rank's, one ``hop:migration`` and one ``kv_transfer`` a
   request, a ``hop:router_dispatch`` a request, no dropped event;
   ``paged_decode`` and ``paged_mq`` launched 18x the decode and chunk
   forwards the trace records, no plain version; both pools free after
   the drain and ``close(strict=True)`` clean. (c) Float32: the
   replicated fabric with ``speculate=3``, and a trace sampled at 0.8
   through the disaggregated one, each token-identical to the single
   engine. (d) The transport at full width: 16 blocks of a random bf16
   pool (294,912 B a block) moved between two pools, bitwise; the
   per-block copy's device time (CUDA events, L2 flushed) and the
   host-inclusive ``migrate`` time beside the byte bound and the
   modeled price. The bf16 ``run_fabric``: each fabric drive, counted
   from zero just before it, launches ``paged_decode`` and ``paged_mq``
   and no plain version; printed, not gated: its tok/s, TTFT p50/p95,
   per-rank utilization, equal-token shares and ``speedup_vs_single_*``,
   and the phase's seconds.
13. Training (``repro_torch.train``, ``launch.train``). (a) gemma-2b at
   full width and depth in bf16 through ``launch.train.run_train`` (the
   launcher's defaults: remat on, loss_chunk 64, lr 3e-3 with 10 warmup
   steps), B=8 S=128, 4 steps: every loss finite; the median step (host
   wall clock, synchronised), tokens/s, peak memory and the idle share of
   the 4th step, profiled. (b) gemma-2b's widths at 2 of 18 layers
   (0.74 B parameters) in float32 on a pod 2 x data 2 x model 1 mesh (R
   = 4 ranks, M = 2 threads a process), 3 steps each on the same
   batches: ``spmd``, ``threadcomm`` and ``flat`` losses within rtol =
   atol = 1e-4 of each other, every rank's new parameters equal
   (``params_rank_spread`` 0), the largest parameter difference
   printed; then ``threadcomm`` over a bf16 wire: losses within 2e-2 of
   float32's and ``msgq_one_copy`` launched (counted each step; the
   float32 syncs launch none); each run's peak memory. (c)
   ``msgq_one_copy`` at (b)'s wire message (4 ranks x plen / 2 bf16, the
   pod pairs of the recursive doubling) bitwise against ``ref.py``, timed
   (CUDA events, median of 30, L2 flushed) beside its byte bound, the
   plain version and ``index_select``; its launches and this time join
   the msgq row of the kernel table. (d) (b)'s float32 threadcomm state
   checkpointed after step 2 (under the git-ignored ``build/``), restored
   into a fresh state, takes step 3: bitwise the uninterrupted step 3.
   (e) gemma-2b's widths at 1 layer in float32, B=2 S=64, the same
   parameters on the card and the CPU: loss and gradient norm within
   1e-4 relative; every other architecture's smoke config, 2 spmd steps
   in float32 on both: finite, within 1e-4. (f) gemma-2b at full width
   and depth in bf16 at the train_4k shape through the chunked attention
   (the dry run's one-device train_4k knobs: remat, threshold 2048,
   chunks 512 x 2048, loss_chunk 512, one microbatch), B=4 S=4096, 3
   steps from seed 0: every loss finite, the chunked attention called
   twice a layer a step, the median step (host wall clock, synchronised),
   tokens/s, the peak, and each step's temporaries against the dry run's
   prediction for the cell (``trace_counts`` / ``temp_bytes`` at tp 1),
   their ratio gated. (a)'s first run and (f)'s steps run with the cyclic
   collector disabled: after every step the bytes allocated beyond the
   phase's start and the train state (parameters, AdamW's m, v, master)
   stay under 64 MiB, so a step frees what it made by reference
   counting alone; (f) reads its baselines without a collection, and
   the collector, run once after its loop, frees under 64 MiB. No
   training path reaches the attention or scan kernels (they have no
   backward).
14. Analysis (``repro_torch.analysis``): the runtime sanitizer armed on
   the card, and the lint. (a) Phase 12's disaggregated fabric (gemma-2b
   at full width and depth, 2 ranks of 4 rows, chunk 64, 16-token
   blocks) on its 16 requests, driven on a step clock unarmed and then
   under ``install(strict=True)`` from construction to close, in float32
   and in bfloat16: the armed run has no finding and passes
   ``assert_clean()``; its tokens and its ``paged_decode`` / ``paged_mq``
   launches equal the unarmed run's (no plain version); every migration
   reaches its end; each dtype runs unarmed, armed, armed, unarmed.
   Printed, not gated: the hooks' counts (requests issued and completed,
   blocks leased and released, migrations, pool resets) and the four
   drives' host wall clocks. (b) 13(b)'s explicit
   trainer (2 layers, pod 2 x data 2) under the strict sanitizer, 2 steps
   with each wire: clean, the losses of 13(b)'s unarmed runs within
   1e-4, ``msgq_one_copy`` once a step on the bf16 wire. (c) Seeded
   faults, each giving exactly its finding: a Request on a CUDA
   CommStream never waited, the same op from two unordered streams of
   one comm, a double free, a migration interrupted mid-chain. (d)
   ``python -m repro_torch.analysis.lint`` returns 0 on the port.
15. The roofline (``repro_torch.roofline``, ``launch/dryrun.py``) and
   the examples. (a) ``roofline.hw.H100`` beside what the card reports
   (total memory, SM count, shared memory per block opt-in and per SM)
   and ``nvidia-smi``'s name and power limit; fails if ``hbm_bytes``
   exceeds the card's memory. (b) The dry run at full width on meta
   tensors through ``run_cell``: gemma-2b x train_4k, prefill_32k,
   decode_32k x single_pod, multi_pod; mamba2-370m x decode_32k and
   long_500k x multi_pod; olmoe-1b-7b x train_4k x multi_pod; each cell's
   terms, dominant term, ``fits_hbm``, counted / analytic and trace
   seconds, and the part's seconds. Then gemma-2b x train_4k x single_pod
   in both of the reference's residual layouts (``build_cell(act_mode=
   "sp" | "none")`` then ``analyze_cell``): collective operand bytes by
   op and temp bytes a device of each; fails unless only ``"sp"`` is
   sequence-parallel and it holds fewer temporaries. And
   ``make_production_mesh()`` on the card: (16, 16) over ``("data",
   "model")``, (2, 16, 16) over ``("pod", "data", "model")``, or it
   fails. (c) Phase 4's paged decode step
   (B=4) and static prefill (B=8, S=256) and 13(a)'s bf16 train step,
   from those phases' records: ``cell_compute_flops`` and
   ``cell_memory_bytes`` at each step's shape, the measured step (host
   wall clock, synchronised, median) and its device-busy time (the
   phases' profiles), and two bounds on ``H100``, each max(compute,
   memory) with bound / step and bound / busy (a share over 1.05 fails:
   the count would be wrong): the formula's, and the step's own count
   (its FlopCounterMode total plus the ported kernels' attention flops,
   which ctypes launches hide from it); phase 4 launched
   ``paged_decode``, ``paged_mq`` and the flash kernel, no plain
   version. (d) Each example's ``main`` in process on the card at its
   reference's size (the serving examples at gemma-2b's published
   widths, which they take on the card: the kernels take head dims
   64/128/256, the smoke config's is 32; ``train_lm --steps 20``): its
   checks pass, the comm examples launch ``msgq_*``, the serving examples
   ``paged_decode`` and ``paged_mq``, and none calls a plain version.

The last lines are the kernel table (JSON), the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

import contextlib
import functools
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
CU_SOURCE = "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu"
FLASH_SOURCE = \
    "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
MSGQ_SOURCE = "src/repro_torch/kernels/msgq/csrc/msgq.cu"
SSD_SOURCE = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
MOE_SOURCE = "src/repro_torch/kernels/moe/csrc/moe.cu"
TPU_KERNELS = {
    "paged_decode":
        "src/repro/kernels/paged_attention/paged_attention.py:57",
    "paged_mq":
        "src/repro/kernels/paged_attention/paged_attention.py:113",
    "flash_attention":
        "src/repro/kernels/flash_attention/flash_attention.py:29",
    "msgq_eager": "src/repro/kernels/msgq/msgq.py:27",
    "msgq_one_copy": "src/repro/kernels/msgq/msgq.py:34",
    "ssd_scan": "src/repro/kernels/ssd_scan/ssd_scan.py:26",
}
# the card's peaks, from one source: the port's roofline constants (the
# H100 SXM5 80GB data sheet); a directory without the port fails here
if not (SRC / "repro_torch").is_dir():
    sys.exit("chip_smoke: FAILED: src/repro_torch not found: run from the "
             "root of a checkout")
sys.path.insert(0, str(SRC))
from repro_torch.roofline.hw import H100  # noqa: E402

HBM_BYTES_PER_S = H100.hbm_bw
PEAK_FLOPS = {torch.bfloat16: H100.peak_flops_bf16,
              torch.float32: H100.peak_flops_f32}
#: kernel vs plain version, per dtype: float32 sums in another order
#: (the reference's own kernel tolerance); bfloat16 outputs are rounded
#: once on each side from identical float32 math: two bf16 ulps
TOL = {torch.float32: 2e-5, torch.bfloat16: 1.6e-2}
#: flash kernel vs plain version: the reference's own kernel tolerances.
#: In bfloat16 the kernel rounds the unnormalised p before p.v (as the
#: Pallas kernel does) and the plain version the normalised output only,
#: so outputs of magnitude 2-4 differ by up to one bf16 ulp (0.0156)
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: full model, bfloat16, 18 layers: max |logit difference| relative to
#: max(1, max |logit|) between the kernel path and the plain path
MODEL_REL_TOL = 3e-2
PARK_POS = -(2 ** 30)
#: hymba-1.5b's sliding window (``configs/hymba_1p5b.py``)
HYMBA_WINDOW = 2048
#: SSD scan vs its plain versions: the reference's own kernel tolerances
#: (float32: the chunked kernel, the chunked einsums and the sequential
#: recurrence sum in different orders; bfloat16 x: y is rounded to bf16)
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
#: a bf16 model step through the scan kernel vs the same step through the
#: plain chunked scan, in units of the step's noise floor: the same step
#: through a second plain scan (the sequential recurrence), which differs
#: from the chunked one by float32 reassociation alone (~1e-6 in the
#: scan, as the kernel does), amplified by bf16 rounding over the model's
#: depth (48 layers for mamba2, against gemma's 18). The tolerance is the
#: larger of MODEL_REL_TOL and this multiple of the floor. The same
#: steps run again in float32 (MODEL_F32_REL_TOL), where no such noise
#: hides a fault
NOISE_FLOOR_FACTOR = 3.0
#: a float32 step of a full-depth model through the kernels vs the same
#: step through the plain versions, relative as MODEL_REL_TOL: both paths
#: compute in float32 and sum in other orders only (single kernel calls
#: agree within 1e-4 for the scan, 2e-5 for attention); a fault in the
#: logic moves the logits by O(1)
MODEL_F32_REL_TOL = 1e-3


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

#: GPU clock cycles of the spin before each timed call: ~0.25 ms at the
#: H100's 1.98 GHz boost clock
SPIN_CYCLES = 500_000


class Timer:
    """Median CUDA-event time of one call's device work. Before each call
    the L2 is flushed (a 256 MB memset) and a spin kernel keeps the card
    busy, so the call's host-side cost (~0.05-0.1 ms for a message round
    of the comm layer, more than the memset takes) is spent while the
    card is busy and the events time the device work only."""

    def __init__(self, dev):
        self.flush = torch.empty(64 * 2 ** 20, dtype=torch.float32,
                                 device=dev)

    def ms(self, fn, iters: int = 30, spin: int = SPIN_CYCLES) -> float:
        """``spin``: cycles of the spin, longer than the host takes to
        issue ``fn`` (a collective of many rounds needs more)."""
        for _ in range(3):
            fn()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(spin)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


# ---------------------------------------------------------------------------
# phase 2: what ptxas said
# ---------------------------------------------------------------------------

def ptxas_report(source: str):
    """Registers and spill bytes of each kernel ptxas compiled from
    ``source`` in this run's build (``_build.build_log``, ``-Xptxas
    -v``), printed one line a kernel; the names demangled by c++filt
    where the toolkit has it. None when the library came from the cache
    (a checkout's first run always builds)."""
    from repro_torch.kernels import _build

    if source not in _build.build_log:
        print(f"ptxas {source}: not built in this run (the library was "
              "cached): registers and spills not reported", flush=True)
        return None
    rows, cur = [], None
    for line in _build.build_log[source].splitlines():
        if "Compiling entry function" in line:
            cur = {"function": line.split("'")[1], "registers": None,
                   "spill_store_bytes": None, "spill_load_bytes": None}
            rows.append(cur)
        elif cur is not None and "bytes spill stores" in line:
            w = line.replace(",", "").split()
            cur["spill_store_bytes"] = int(w[w.index("spill") - 2])
            cur["spill_load_bytes"] = int(w[w.index("loads") - 3])
        elif cur is not None and "Used" in line and "registers" in line:
            w = line.replace(",", "").split()
            cur["registers"] = int(w[w.index("registers") - 1])
    names = [r["function"] for r in rows]
    filt = shutil.which("c++filt")
    if filt and names:
        res = subprocess.run([filt], input="\n".join(names), text=True,
                             capture_output=True, check=False)
        if res.returncode == 0 and len(res.stdout.splitlines()) == len(rows):
            for r, name in zip(rows, res.stdout.splitlines()):
                r["function"] = name.replace("(anonymous namespace)::", "")
    for r in rows:
        print(f"ptxas {source} {r['function']}: {r['registers']} registers, "
              f"{r['spill_store_bytes']} bytes spill stores, "
              f"{r['spill_load_bytes']} bytes spill loads", flush=True)
    require(bool(rows), f"ptxas printed nothing for {source}: its registers "
            "and spills are unknown")
    return rows


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions
# ---------------------------------------------------------------------------

def make_case(dev, dtype, *, B, K, H, Hkv, hd, bs, lengths, parked=(),
              hole=None, padding=(), NB=0, dead=(), seed=0):
    """Pool, tables and q on the card. ``lengths`` are attention lengths;
    ``parked`` rows get a valid table and a parked (far negative) length,
    ``padding`` rows an all -1 table, ``hole`` = (row, entry) a -1 entry
    inside a live range, ``dead`` = [(row, lo, hi)] -1 over entries
    ``[lo, hi)``; ``NB`` widens the tables (trailing -1)."""
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
    for b, lo, hi in dead:
        tables[b, lo:hi] = -1
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


def split_edge_specs(dtype):
    """Cases at the split boundaries of the kernels' launch plan
    (``ops.plan``), at hymba-1.5b's heads (H=25, Hkv=5, hd=64) and at hd
    128 (H=16, Hkv=2), on 40-entry tables: lengths at a split's edge and
    one either side, a split wholly of -1 entries, a split wholly before
    the window; then tables far wider (NB=163) than the longest length
    (300)."""
    from repro_torch.kernels.paged_attention import ops

    specs, NB, bs = [], 40, 16
    for tag, H, Hkv, hd in (("hymba", 25, 5, 64), ("hd128", 16, 2, 128)):
        for kernel, B, K in (("paged_decode", 8, 0),
                             ("paged_mq", 3, 64 if hd == 128 else 128)):
            pl = ops.plan(B, max(K, 1), H, Hkv, bs, NB)
            edge = pl.eps * bs                    # tokens of one split
            base = dict(B=B, K=K, H=H, Hkv=Hkv, hd=hd, bs=bs, NB=NB)
            # edges from the first at or past K (every query sees a token)
            near = [n * edge + d for n in range(1, NB) for d in (-1, 0, 1)
                    if n * edge - 1 >= max(K, 1)]
            specs.append((kernel, f"{tag} split edges", dtype,
                          dict(base, lengths=near[:B]), 0, 0.0))
            full = [NB * bs - 1 - b for b in range(B)]
            specs.append((kernel, f"{tag} -1 split", dtype,
                          dict(base, lengths=full, dead=[
                              (b, pl.eps, 2 * pl.eps) for b in range(B)]),
                          0, 0.0))
            specs.append((kernel, f"{tag} split pre-window", dtype,
                          dict(base, lengths=full), edge // 2, 0.0))
            specs.append((kernel, f"{tag} wide table", dtype,
                          dict(base, NB=163, lengths=np.linspace(
                              max(K, 1), 300, B).astype(np.int64),
                              parked=(0,) if K == 0 else ()), 0, 0.0))
    return specs


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
        # hymba-1.5b's heads (H=25, Gs=5 stored, hd=64) at the serve
        # phase's widths: its 2048 window (most layers) and none (global
        # layers 0, 15, 31); then lengths past the window, so it masks
        for window in (HYMBA_WINDOW, 0):
            tag = "hymba serve" if window else "hymba global"
            specs.append(("paged_decode", f"{tag} decode", dtype, dict(
                B=8, K=0, H=25, Hkv=5, hd=64, bs=16, NB=19,
                lengths=[17, 40, 100, 257, 270, 290, 300, 303],
                parked=(2,)), window, 0.0))
            specs.append(("paged_mq", f"{tag} chunk", dtype, dict(
                B=2, K=128, H=25, Hkv=5, hd=64, bs=16, NB=19,
                lengths=[128, 256]), window, 0.0))
        specs.append(("paged_decode", "hymba past window", dtype, dict(
            B=3, K=0, H=25, Hkv=5, hd=64, bs=16,
            lengths=[100, 2100, 2600], parked=(0,)), HYMBA_WINDOW, 0.0))
        specs.append(("paged_mq", "hymba past window", dtype, dict(
            B=2, K=128, H=25, Hkv=5, hd=64, bs=16,
            lengths=[2176, 2600]), HYMBA_WINDOW, 0.0))
        specs += split_edge_specs(dtype)

    table = {k: {"name": k, "route": "cuda", "source": CU_SOURCE,
                 "replaces": TPU_KERNELS[k], "launches": 0,
                 "max_abs_err": 0.0} for k in ("paged_decode", "paged_mq")}
    for kernel, label, dtype, kw_case, window, softcap in specs:
        case = make_case(dev, dtype, seed=len(label) + kw_case["B"],
                         **kw_case)
        args = [case[k] for k in ("q", "k_pages", "v_pages", "block_tables",
                                  "lengths")]
        before = ops.counters()
        out = ops.launch(*args, window=window, softcap=softcap)
        after = ops.counters()
        launched = {"paged_decode": "decode_launches",
                    "paged_mq": "mq_launches"}[kernel]
        require(after[launched] == before[launched] + 1,
                f"{label}: {kernel} was not launched")
        again = ops.launch(*args, window=window, softcap=softcap)
        ref = paged_attention_ref(*args, window=window, softcap=softcap)
        torch.cuda.synchronize()
        live = case["live"]
        require(bool(torch.isfinite(out.float()).all()),
                f"{kernel} {label} {dtype}: non-finite output")
        require(torch.equal(out, again),
                f"{kernel} {label} {dtype}: two launches differ")
        err = (out[live].float() - ref[live].float()).abs()
        tol = TOL[dtype]
        bad = err > tol + tol * ref[live].float().abs()
        max_err = float(err.max())
        q = case["q"]
        pl = ops.plan(q.shape[0], q.shape[1] if q.dim() == 4 else 1,
                      q.shape[-2], kw_case["Hkv"], kw_case["bs"],
                      case["block_tables"].shape[1])
        print(f"check {kernel:12s} {label:22s} {str(dtype):14s} "
              f"max_abs_err={max_err:.3e} tol={tol:g} "
              f"{'ok' if not bad.any() else 'MISMATCH'}, deterministic, "
              f"{pl.splits} splits x {pl.row_tiles} row tiles x "
              f"{pl.warps} warps", flush=True)
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
        # time gemma's path shapes (the table's) and hymba's serve shapes
        if dtype == torch.bfloat16 and label.startswith(("gemma",
                                                         "hymba serve")):
            kw = dict(window=window, softcap=softcap)
            nbytes, flops = needs(case, window)
            t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
            t_ops = 1e3 * flops / PEAK_FLOPS[dtype]
            lib = library_call(case, window, softcap)
            t = dict(
                shape=label, dtype="bfloat16", plan=pl._asdict(),
                ms=timer.ms(lambda: ops.paged_attention(*args, **kw)),
                plain_ms=timer.ms(lambda: paged_attention_ref(*args, **kw)),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=nbytes, bound_flops=flops,
                library_ms=timer.ms(lib) if lib is not None else None)
            t["bound_share"] = t["bound_ms"] / t["ms"]
            # the split target of ops.plan: two, four (the default) and
            # eight CTAs an SM
            t["ms_by_target_ctas"] = {
                n: timer.ms(lambda: ops.launch(*args, target_ctas=n, **kw))
                for n in (2 * 132, 4 * 132, 8 * 132)}
            if label.startswith("gemma"):
                row.update(t)
            else:
                row.setdefault("times", []).append(t)
            print(f"time  {kernel:12s} {label:22s} bf16 ms={t['ms']:.4f} "
                  f"plain_ms={t['plain_ms']:.4f} "
                  f"library_ms={t['library_ms']} "
                  f"bound_ms={t['bound_ms']:.5f} ({t['bound_by']}: "
                  f"{nbytes} bytes, {flops} flops), bound share "
                  f"{t['bound_share']:.4f}, "
                  f"{pl.grid * kw_case['Hkv'] * q.shape[0]} CTAs; by split "
                  f"target (CTAs): {json.dumps(t['ms_by_target_ctas'])}",
                  flush=True)
    return table


# ---------------------------------------------------------------------------
# phase 3, flash attention: kernel vs plain version
# ---------------------------------------------------------------------------

#: (label, B, H, Hkv, S_q, S_k, hd, window, q_offset); "path" cases are
#: the monolithic prefill's own shapes (gemma-2b: H=8, Hkv=1, hd=256)
FLASH_CASES = [
    ("path B=1 S=16", 1, 8, 1, 16, 16, 256, 0, 0),
    ("path B=1 S=256", 1, 8, 1, 256, 256, 256, 0, 0),
    ("path B=8 S=16", 8, 8, 1, 16, 16, 256, 0, 0),
    ("path B=8 S=256", 8, 8, 1, 256, 256, 256, 0, 0),
    ("path B=4 S=256", 4, 8, 1, 256, 256, 256, 0, 0),
    ("ragged B=2 S=200", 2, 8, 1, 200, 200, 256, 0, 0),
    ("q_offset 96", 1, 8, 1, 32, 128, 256, 0, 96),
    ("window 100", 2, 8, 1, 256, 256, 256, 100, 0),
    ("H=Hkv=8", 2, 8, 8, 256, 256, 256, 0, 0),
    ("B=1 S=2048", 1, 8, 1, 2048, 2048, 256, 0, 0),
    # hymba-1.5b's monolithic prefill (H=25, Hkv=5, hd=64): its 2048
    # window (most layers), a global layer, then past the window
    ("hymba B=4 S=256", 4, 25, 5, 256, 256, 64, 2048, 0),
    ("hymba B=8 S=256", 8, 25, 5, 256, 256, 64, 2048, 0),
    ("hymba global B=8 S=256", 8, 25, 5, 256, 256, 64, 0, 0),
    ("hymba past window S=2304", 1, 25, 5, 2304, 2304, 64, 2048, 0),
    # R = 5 with S * R not a multiple of the kernel's 64-row tile
    ("hymba ragged B=2 S=200", 2, 25, 5, 200, 200, 64, 2048, 0),
]
#: the shape the kernel table reports: a static batch of 8 slots
FLASH_TABLE_CASE = "path B=8 S=256"


def flash_needs(B, H, Hkv, Sq, Sk, hd, window, q_offset, item,
                causal=True):
    """Bytes (q, k, v read once, the output written once) and flops (q.k
    and p.v over the (query, key) pairs the masks leave) of one call."""
    qpos = q_offset + np.arange(Sq)
    hi = np.minimum(qpos + 1, Sk) if causal else np.full(Sq, Sk)
    lo = np.maximum(qpos - window + 1, 0) if window > 0 else 0
    pairs = int(np.maximum(hi - lo, 0).sum())
    nbytes = item * hd * (2 * B * H * Sq + 2 * B * Hkv * Sk)
    return nbytes, 4 * pairs * B * H * hd


def phase_flash(dev, timer):
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    row = {"name": "flash_attention", "route": "cuda",
           "source": FLASH_SOURCE,
           "replaces": TPU_KERNELS["flash_attention"], "launches": 0,
           "max_abs_err_by_dtype": {},
           "ptxas": ptxas_report(Path(FLASH_SOURCE).name)}
    times = []
    for dtype in (torch.float32, torch.bfloat16):
        worst = 0.0
        for label, B, H, Hkv, Sq, Sk, hd, window, q_offset in FLASH_CASES:
            g = torch.Generator().manual_seed(Sq + B + H * Hkv)
            q = torch.randn(B, Sq, H, hd, generator=g).to(dev, dtype)
            k = torch.randn(B, Sk, Hkv, hd, generator=g).to(dev, dtype)
            v = torch.randn(B, Sk, Hkv, hd, generator=g).to(dev, dtype)
            kw = dict(causal=True, window=window, q_offset=q_offset)
            before = flash_ops.flash_launches
            out = flash_ops.flash_attention(q, k, v, **kw)
            again = flash_ops.flash_attention(q, k, v, **kw)
            require(flash_ops.flash_launches == before + 2,
                    f"flash {label}: the kernel was not launched")
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), \
                v.transpose(1, 2)
            ref = flash_attention_ref(qt, kt, vt, **kw).transpose(1, 2)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(out.float()).all()),
                    f"flash {label} {dtype}: non-finite output")
            err = (out.float() - ref.float()).abs()
            tol = FLASH_TOL[dtype]
            bad = err > tol + tol * ref.float().abs()
            max_err = float(err.max())
            worst = max(worst, max_err)
            same = torch.equal(out, again)
            print(f"check flash_attention {label:18s} {str(dtype):14s} "
                  f"max_abs_err={max_err:.3e} tol={tol:g} "
                  f"{'ok' if not bad.any() else 'MISMATCH'}, two launches "
                  f"bitwise {same}", flush=True)
            require(not bool(bad.any()),
                    f"flash {label} {dtype}: disagrees with ref.py")
            require(same, f"flash {label} {dtype}: two launches differ")
            if dtype != torch.bfloat16 or not (
                    label.startswith("path")
                    or label in ("B=1 S=2048", "hymba B=8 S=256")):
                continue
            nbytes, flops = flash_needs(B, H, Hkv, Sq, Sk, hd, window,
                                        q_offset, q.element_size())
            t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
            t_ops = 1e3 * flops / PEAK_FLOPS[dtype]
            rep = H // Hkv
            qs = qt.contiguous()
            ks = kt.repeat_interleave(rep, dim=1).contiguous()
            vs = vt.repeat_interleave(rep, dim=1).contiguous()
            t = dict(
                shape=label, dtype="bfloat16",
                ms=timer.ms(lambda: flash_ops.flash_attention(q, k, v,
                                                              **kw)),
                plain_ms=timer.ms(lambda: flash_attention_ref(qt, kt, vt,
                                                              **kw)),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=nbytes, bound_flops=flops,
                library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, is_causal=True)))
            times.append(t)
            print(f"time  flash_attention {label:18s} bf16 ms={t['ms']:.4f} "
                  f"plain_ms={t['plain_ms']:.4f} "
                  f"library_ms={t['library_ms']:.4f} "
                  f"bound_ms={t['bound_ms']:.5f} ({t['bound_by']}: "
                  f"{nbytes} bytes, {flops} flops)", flush=True)
        row["max_abs_err_by_dtype"][str(dtype).split(".")[-1]] = worst
    main_case = next(t for t in times if t["shape"] == FLASH_TABLE_CASE)
    row.update(main_case)
    row["max_abs_err"] = max(row["max_abs_err_by_dtype"].values())
    row["times"] = times
    return row


#: the expert kernels' cases: (label, T, K, E, d, f); the chunk and decode
#: shapes are olmoe-1b-7b's on the benchmark's path
MOE_CASES = [("olmoe chunk", 4096, 8, 64, 2048, 1024),
             ("olmoe decode", 64, 8, 64, 2048, 1024),
             ("dbrx full width", 256, 4, 16, 6144, 10752),
             ("smoke olmoe", 40, 2, 8, 64, 32),
             ("smoke dbrx", 40, 2, 4, 64, 96)]
#: kernel vs plain version, relative to the output's largest magnitude:
#: bfloat16 rounds h and the output once on each side from float32 sums
#: in other orders (a few bf16 ulps); float32 reorders the sums only
MOE_TOL = {torch.bfloat16: 1.6e-2, torch.float32: 2e-5}


def moe_inputs(dev, dtype, T, K, E, d, f, seed=0):
    """x, the router's (ids, renormalised gates) of random logits, and
    the stacked expert weights at fan-in scale."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((T, d), generator=g).to(dtype)
    probs = torch.softmax(torch.randn((T, E), generator=g), -1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = gates[:, :K] / gates[:, :K].sum(-1, keepdim=True)
    w = [(torch.randn(s, generator=g) * s[1] ** -0.5).to(dtype)
         for s in ((E, d, f), (E, d, f), (E, f, d))]
    return [t.to(dev) for t in (x, idx[:, :K], gates, *w)]


def phase_moe(dev, timer):
    """3(b): the top-k expert kernels against their plain version, their
    tables, batch invariance, no host sync, their launch count, and
    their times at olmoe's chunk and decode shapes."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe import ops as moe_ops
    from repro_torch.kernels.moe.ref import dispatch_ref, moe_experts_ref
    from repro_torch.models import moe

    row = {"name": "moe_experts", "route": "cuda", "source": MOE_SOURCE,
           "replaces": "none (the reference's dense MoE is XLA's)",
           "max_abs_err_by_dtype": {},
           "ptxas": ptxas_report(Path(MOE_SOURCE).name)}
    for dtype in (torch.bfloat16, torch.float32):
        worst = 0.0
        for label, T, K, E, d, f in MOE_CASES:
            if dtype == torch.float32 and label == "dbrx full width":
                T = 32                  # float32 products: CUDA cores
            args = moe_inputs(dev, dtype, T, K, E, d, f, seed=T + d)
            before = moe_ops.moe_launches
            out = moe_ops.moe_experts(*args)
            again = moe_ops.moe_experts(*args)
            require(moe_ops.moe_launches == before + 2,
                    f"moe {label}: the kernels were not launched")
            ref = moe_experts_ref(*args)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            rel = err / max(float(ref.float().abs().max()), 1e-30)
            worst = max(worst, err)
            same = torch.equal(out, again)
            ok = rel <= MOE_TOL[dtype] and bool(
                torch.isfinite(out.float()).all())
            print(f"check moe_experts {label:16s} {str(dtype):14s} "
                  f"max_abs_err={err:.3e} rel={rel:.3e} "
                  f"tol={MOE_TOL[dtype]:g} {'ok' if ok else 'MISMATCH'}, "
                  f"two launches bitwise {same}", flush=True)
            require(ok, f"moe {label} {dtype}: disagrees with ref.py")
            require(same, f"moe {label} {dtype}: two launches differ")
        row["max_abs_err_by_dtype"][str(dtype).split(".")[-1]] = worst
    row["max_abs_err"] = max(row["max_abs_err_by_dtype"].values())
    for T, K, E, bm in ((4096, 8, 64, 128), (64, 8, 64, 128),
                        (256, 4, 16, 64), (1, 2, 8, 128)):
        idx = torch.randint(0, E - 1, (T, K),
                            generator=torch.Generator().manual_seed(T))
        idx[: T // 2, 0] = 0
        ours = moe_ops.dispatch(idx.to(dev), E, bm)
        plain = dispatch_ref(idx, E, bm)
        require(all(torch.equal(a.cpu(), b) for a, b in zip(ours, plain)),
                f"moe dispatch T={T} K={K} E={E}: tables differ")
    print("check moe dispatch tables: equal to the plain ones", flush=True)
    x, idx, gates, *w = moe_inputs(dev, torch.bfloat16, *MOE_CASES[0][1:])
    whole = moe_ops.moe_experts(x, idx, gates, *w)
    alone = moe_ops.moe_experts(x[:100], idx[:100], gates[:100], *w)
    among = moe_ops.moe_experts(torch.cat([x[:100], x.flip(0)[:900]]),
                                torch.cat([idx[:100], idx.flip(0)[:900]]),
                                torch.cat([gates[:100],
                                           gates.flip(0)[:900]]), *w)
    torch.cuda.synchronize()
    require(torch.equal(whole[:100], alone)
            and torch.equal(whole[:100], among[:100]),
            "moe: a token's output depends on its neighbours")
    print("check moe batch invariance: rows 0..99 alone and among others "
          "bitwise", flush=True)
    cfg = get_config("olmoe-1b-7b")
    p = {"router": torch.randn((cfg.d_model, cfg.num_experts), device=dev)
         * cfg.d_model ** -0.5, "w_gate": w[0], "w_up": w[1],
         "w_down": w[2]}
    xb = torch.randn((2, 32, cfg.d_model), device=dev, dtype=torch.bfloat16)
    moe.moe_apply_dropless(p, xb, cfg)
    torch.cuda.synchronize()
    before = moe_ops.moe_launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        moe.moe_apply_dropless(p, xb, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    require(moe_ops.moe_launches == before + 1,
            "moe_apply_dropless: not one launch count a call")
    print("check moe_apply_dropless: no host sync, one launch count",
          flush=True)
    times = []
    for label, T, K, E, d, f in MOE_CASES[:2]:
        args = moe_inputs(dev, torch.bfloat16, T, K, E, d, f)
        flops = 2 * T * K * 3 * d * f
        nbytes = 2 * (3 * E * d * f + 2 * T * d)
        t_ops = 1e3 * flops / PEAK_FLOPS[torch.bfloat16]
        t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        t = dict(shape=label, dtype="bfloat16",
                 ms=timer.ms(lambda: moe_ops.moe_experts(*args)),
                 plain_ms=timer.ms(lambda: moe_experts_ref(*args), iters=5),
                 bound_ms=max(t_ops, t_bytes),
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 bound_bytes=nbytes, bound_flops=flops)
        t["share"] = t["bound_ms"] / t["ms"]
        times.append(t)
        print(f"time  moe_experts {label:16s} bf16 ms={t['ms']:.4f} "
              f"plain_ms={t['plain_ms']:.4f} bound_ms={t['bound_ms']:.5f} "
              f"({t['bound_by']}: {nbytes} bytes, {flops} flops), share "
              f"{t['share']:.3f}", flush=True)
    row.update(times[0])
    row["times"] = times
    return row


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
    before = path_launches()

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
            torch.arange(B), torch.full((B,), off, device=dev),
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
    results["decode_step"] = step_record(
        lambda: model.decode_step_paged(params, pool, tokens, positions,
                                        tables),
        batch=B, cache_len=int(positions.max()) + 1)
    del pool, ref_pool
    torch.cuda.empty_cache()
    results.update(monolithic(model, params, cfg))
    # every launch of this phase's kernel path (its comparisons pass the
    # plain versions in directly: they count no plain call)
    after = path_launches()
    results["launches"] = {k: after[k] - before[k] for k in after}
    del model, params
    torch.cuda.empty_cache()
    return results


def plain_flash(q, k, v, **kw):
    """The flash kernel's plain version in the models' (B, S, H, hd)
    layout: what monolithic prefill runs instead of the kernel."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    return flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), **kw).transpose(1, 2)


def monolithic(model, params, cfg):
    """Monolithic prefill through the flash kernel vs through its plain
    version (B=4, S=256), then one static prefill (B=8, S=256) and one
    slot decode step (B=8) timed and profiled."""
    dev = model.device
    results = {}
    rng = np.random.default_rng(1)
    S, W = 256, 256 + 48
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(4, S))).to(
        dev)
    logits, _ = model.prefill(params, tok, W)
    ref_logits, _ = model.prefill(params, tok, W, attention=plain_flash)
    results["prefill"] = compare("monolithic prefill (B=4, S=256)", logits,
                                 ref_logits, cfg)

    tok8 = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(8, S))).to(
        dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for _ in range(2):
        ev[0].record()
        logits, cache = model.prefill(params, tok8, W)
        ev[1].record()
        nxt = logits.argmax(-1, keepdim=True)
        pos = torch.full((8,), S, device=dev)
        model.decode_step(params, cache, nxt, pos)
        ev[2].record()
    torch.cuda.synchronize()
    results["static_prefill_ms"] = ev[0].elapsed_time(ev[1])
    results["slot_decode_step_ms"] = ev[1].elapsed_time(ev[2])
    print(f"model step time (B=8, kernel path): static prefill S=256 "
          f"{results['static_prefill_ms']:.3f} ms, slot decode "
          f"{results['slot_decode_step_ms']:.3f} ms", flush=True)
    results["static_prefill_profile"] = profile_step(
        "static prefill", lambda: model.prefill(params, tok8, W),
        results["static_prefill_ms"])
    results["slot_decode_profile"] = profile_step(
        "slot decode", lambda: model.decode_step(params, cache, nxt, pos),
        results["slot_decode_step_ms"])
    results["static_prefill_step"] = step_record(
        lambda: model.prefill(params, tok8, W), batch=8, seq_len=S)
    return results


#: the port's attention kernels, by their CUDA names
ATTENTION_KERNELS = ("paged_decode", "paged_mq", "flash_kernel")


def launch_counts():
    """Each ported kernel's launch counter, by the CUDA name that the
    profiler shows for it."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return {"paged_decode": paged_ops.decode_launches,
            "paged_mq": paged_ops.mq_launches,
            "flash_kernel": flash_ops.flash_launches,
            "ssd_kernel": ssd_ops.ssd_launches}


def path_launches():
    """The attention kernels' launch counters, by their wrappers' names,
    and the calls of their plain versions."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    return {"paged_decode": paged_ops.decode_launches,
            "paged_mq": paged_ops.mq_launches,
            "flash_attention": flash_ops.flash_launches,
            "plain_calls": paged_ops.ref_calls + flash_ops.ref_calls}


def flop_count(fn):
    """FlopCounterMode's total for one call of ``fn`` (torch ops only)."""
    with FlopCounterMode(display=False) as fc:
        fn()
        torch.cuda.synchronize()
    return fc.get_total_flops()


def step_record(fn, **shape):
    """One main-path step for 15(c): its median host wall clock
    (synchronised) and its FlopCounterMode count, beside its shape."""
    return {"host_ms": host_ms(fn), "flop_count": flop_count(fn), **shape}


def profile_step(label, step, step_ms, names=ATTENTION_KERNELS):
    """Where one step's time goes: device kernel time by name
    (torch.profiler) against the step's CUDA-event time; the rest of the
    step the device sat idle, waiting for the host to launch work.
    ``attention_kernel_ms`` sums the kernels whose name holds one of
    ``names``. Fails when a kernel of ``names`` launched in the step (by
    its counter) and the profiler shows no device time under its name: a
    renamed kernel must not read as 0 ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    before = launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in launch_counts().items()}

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
                  if any(n in e.key for n in names)) / 1e3
    by_name = {n: sum(dev_us(e) for e in kernels if n in e.key) / 1e3
               for n in names}
    for n in names:
        require(not launched.get(n) or by_name[n] > 0,
                f"profile {label}: {n} launched {launched.get(n)} times but "
                "the profiler shows no device time under that name")
    launches = sum(e.count for e in kernels)
    out = {"step_ms": step_ms, "device_busy_ms": busy_ms,
           "attention_kernel_ms": attn_ms, "kernel_ms_by_name": by_name,
           "ported_launches": {n: launched[n] for n in names
                               if n in launched},
           "device_launches": launches,
           "idle_share": max(0.0, 1.0 - busy_ms / step_ms),
           "top": [(e.key[:60], dev_us(e) / 1e3, e.count) for e in
                   sorted(kernels, key=dev_us, reverse=True)[:6]]}
    print(f"profile {label}: step {step_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({launches} kernels), {'/'.join(names)} "
          f"{attn_ms:.3f} ms, idle share {out['idle_share']:.3f}", flush=True)
    for name, ms, n in out["top"]:
        print(f"profile {label}:   {ms:8.3f} ms  x{n:<4d} {name}", flush=True)
    return out


def rel_diff(logits, ref_logits, cfg):
    """max |logit difference| / max(1, max |ref logit|) over the vocab."""
    V = cfg.vocab_size
    a, r = logits[:, :V].float(), ref_logits[:, :V].float()
    return float((a - r).abs().max()) / max(1.0, float(r.abs().max()))


def argmax_agree(logits, ref_logits, cfg) -> int:
    """Rows whose greedy token (argmax over the vocab) is the same."""
    V = cfg.vocab_size
    return int((logits[:, :V].float().argmax(-1)
                == ref_logits[:, :V].float().argmax(-1)).sum())


def compare(label, logits, ref_logits, cfg, tol=MODEL_REL_TOL, floor=None,
            floor_agree=None):
    V = cfg.vocab_size
    a = logits[:, :V].float()
    require(bool(torch.isfinite(a).all()), f"{label}: non-finite logits")
    rel = rel_diff(logits, ref_logits, cfg)
    agree = argmax_agree(logits, ref_logits, cfg)
    rows = a.shape[0]
    print(f"check model {label}: max|dlogit|/max(1,|logit|)={rel:.3e} "
          f"(tol {tol:.3g}" + ("" if floor is None else
                               f"; bf16 noise floor {floor:.3e}, its "
                               f"argmax agreement {floor_agree}/{rows}")
          + f"), argmax agreement {agree}/{rows}", flush=True)
    require(rel <= tol, f"model {label}: kernel path disagrees with the "
            "plain path")
    out = {"rel_err": rel, "argmax_agree": agree, "rows": rows, "tol": tol}
    if floor is not None:
        out.update(noise_floor=floor, floor_argmax_agree=floor_agree)
    return out


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
    require(counts == {k: res["kernels"][k] for k in counts},
            "counter mismatch")
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


# ---------------------------------------------------------------------------
# phase 6: --engine both at full width
# ---------------------------------------------------------------------------

ENGINE_ARMS = ("static", "continuous", "continuous_monolithic",
               "continuous_paged")


def phase_engines():
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch

    cfg = get_config("gemma-2b")
    launch.reset_kernel_counters()
    res = launch.run_traffic("gemma-2b", smoke=False, device="cuda",
                             requests=16, slots=8, prompt_len=(16, 256),
                             max_new=(4, 48), rate=50.0, engine="both",
                             prefill_chunk=64, max_prefill_per_step=2,
                             block_size=16, prefix_compare=False,
                             spec_compare=False, seed=0)
    counts = launch.kernel_counters()
    require(counts == res["kernels"], "counter mismatch")
    for arm in ENGINE_ARMS:
        require(arm in res, f"--engine both ran no {arm} arm")
        stats = res[arm]
        require(stats.get("n") == 16.0,
                f"{arm}: {stats.get('n')} of 16 requests finished")
        outs = res["outputs_by_arm"][arm]
        require(len(outs) == 16 and all(len(t) > 0 for t in outs),
                f"{arm}: a request produced no token")
        require(all(0 <= t < cfg.vocab_size for toks in outs for t in toks),
                f"{arm}: token out of [0, {cfg.vocab_size})")
        ttft = (f"TTFT p50 {1e3 * stats['ttft_p50_s']:.2f} ms p95 "
                f"{1e3 * stats['ttft_p95_s']:.2f} ms"
                if "ttft_p50_s" in stats else
                "TTFT not measured (the static drive sees a batch's "
                "tokens when it finishes)")
        print(f"engines {arm:22s}: {int(stats['n'])} requests, "
              f"{stats['useful_tokens']:.0f} tokens in "
              f"{stats['makespan_s']:.3f} s: {stats['tok_s']:.2f} tok/s, "
              f"{ttft}, latency p50 {1e3 * stats['latency_p50_s']:.2f} ms "
              f"p95 {1e3 * stats['latency_p95_s']:.2f} ms"
              + (f", peak concurrent {stats['peak_concurrent']:.0f}"
                 if "peak_concurrent" in stats else ""), flush=True)
    L = cfg.num_layers
    require(counts["prefill_calls"] > 0, "no monolithic prefill ran")
    require(counts["flash_launches"] == L * counts["prefill_calls"],
            f"flash kernel launched {counts['flash_launches']} times for "
            f"{counts['prefill_calls']} monolithic prefills x {L} layers")
    require(counts["decode_launches"] > 0, "decode kernel never launched")
    require(counts["mq_launches"] > 0, "multi-query kernel never launched")
    require(counts["ref_calls"] == 0 and counts["flash_ref_calls"] == 0,
            "a plain attention version ran on the card")
    flags = {k: res[k] for k in (
        "speedup_tok_s", "continuous_faster_verified",
        "chunked_ttft_p95_improved", "ttft_p95_chunked_s",
        "ttft_p95_monolithic_s", "paged_more_concurrent_verified",
        "paged_max_concurrency", "slot_max_concurrency",
        "paged_hbm_within_budget", "paged_bytes_per_resident_token",
        "slot_bytes_per_resident_token", "parity_token_identical",
        "parity_token_identical_paged", "paged_token_identical_trace",
        "monolithic_token_identical_trace", "static_token_identical_trace",
        "parity_equal_token_share", "parity_equal_token_share_paged",
        "paged_equal_token_share", "monolithic_equal_token_share",
        "static_equal_token_share") if k in res}
    print("engines flags: " + json.dumps(flags), flush=True)
    print("engines kernels: " + json.dumps(counts), flush=True)
    print(f"engines max_memory_allocated {res['max_memory_allocated']} "
          "bytes", flush=True)
    return res, counts


# ---------------------------------------------------------------------------
# phase 7: the threadcomm layer — msgq kernels, collectives, PETSc
# ---------------------------------------------------------------------------

#: bench_p2p's message sizes, bytes (``benchmarks/bench_p2p.py:18``)
P2P_SIZES = [64, 256, 1024, 4096, 16384, 65536, 1 << 20, 1 << 22]
#: the unified rank space of phase 7: 2 processes x 4 threads
MESH = ((2, 4), ("proc", "thread"))
#: CG iterations of the PETSc phase (``examples/spmv_petsc.py``'s default)
CG_ITERS = 10


def as_bytes(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def bitwise(a, b) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(as_bytes(a), as_bytes(b)))


def message(g, shape, dtype, dev):
    if dtype == torch.int32:
        return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=g,
                             dtype=torch.int32).to(dev)
    if dtype == torch.uint8:
        return torch.randint(0, 256, shape, generator=g,
                             dtype=torch.uint8).to(dev)
    return torch.randn(shape, generator=g).to(dev, dtype)


def msgq_delta(before, after):
    return (after["eager_launches"] - before["eager_launches"],
            after["one_copy_launches"] - before["one_copy_launches"])


def on_path(path, fn):
    """Run one call of the threadcomm path: add the msgq launches and plain
    calls it made to ``path``, and return its output with its (eager,
    1-copy) launches. Timing loops and plain-path comparisons run outside
    it and so stay out of the path's count."""
    from repro_torch.kernels.msgq import ops as mq
    before = mq.counters()
    out = fn()
    after = mq.counters()
    for k in path:
        path[k] += after[k] - before[k]
    return out, msgq_delta(before, after)


def host_ms(fn, iters: int = 10) -> float:
    """Median host-inclusive time of one call that ends synchronised."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def held_to_ref(errs, name, out, ref, what):
    """Hold one copy of kernel ``name`` to ref.py bitwise, and keep the
    largest |out - ref| over finite values in ``errs[name]`` for the
    kernels line."""
    err = 0.0
    if out.shape == ref.shape and out.numel():
        diff = (out.double() - ref.double()).abs()
        diff = diff[torch.isfinite(diff)]
        err = float(diff.max()) if diff.numel() else 0.0
    errs[name] = max(errs[name], err)
    require(bitwise(out, ref), f"{what}: differs from ref.py (max abs err "
            f"{err:.3e})")


#: the kernel a protocol launches, by ``ops.is_eager``
KERNEL = {True: "msgq_eager", False: "msgq_one_copy"}
#: (label, protocol, eager cell bytes): the eager kernel with the comm
#: layer's 4 KiB cell, the 1-copy kernel's direct copy, and the staged
#: 1-copy variant (global -> shared -> global by bulk copies), which is
#: the eager kernel with a 16 KiB cell
VARIANTS = (("eager", "eager", 4096), ("one_copy", "one_copy", 4096),
            ("staged (eager, 16 KiB cells)", "eager", 16384))


def special(g, shape, dtype, dev):
    """A message with the edge cases of its dtype: -0.0, NaN and tiny
    negatives (floats), the extremes whose sums overflow (int32)."""
    x = message(g, shape, dtype, dev)
    flat = x.view(-1)
    k = flat.numel()
    idx = torch.randperm(k, generator=g).to(dev)
    if dtype.is_floating_point:
        flat[idx[: k // 6]] = -0.0
        flat[idx[k // 6: k // 6 + 2]] = float("nan")
        flat[idx[-(k // 6):]] *= -1e-30
    elif dtype == torch.int32:
        flat[idx[: k // 4]] = torch.tensor([2 ** 31 - 1, -2 ** 31], device=dev,
                                           dtype=dtype).repeat(k)[: k // 4]
    return x


def programs(dev, elems):
    """Round programs of the 2 x 4 threadcomm on slabs of ``elems``: each
    folded schedule as the collectives build it (over all 8 ranks, and the
    thread reduce/bcast over two families of 4), one of every combine,
    and, where 8 chunks tile a slab, the ring and chunk rounds of both
    segment combines."""
    from repro_torch.core import collectives as coll
    from repro_torch.core import schedules as sch
    from repro_torch.core.compat import make_mesh
    from repro_torch.kernels.msgq.program import Program, Round

    region = make_mesh(*MESH, device=dev).region(MESH[1])
    axes = MESH[1]
    ring = [(i, (i + 1) % 8) for i in range(8)]
    part = [(0, 3), (5, 1), (2, 2), (7, 0)]
    c = elems // 8
    # rank r sends chunk r mod 3 and combines into its chunk (r + 1) mod 3
    chunked = [((s % 3) * c, ((d + 1) % 3) * c, c) for s, d in ring]
    progs = {
        "barrier": Program(coll._rounds(region, axes,
                                        sch.dissemination_rounds(8), "max")),
        "recursive_doubling": Program(coll._rounds(
            region, axes, sch.recursive_doubling_rounds(8), "add")),
        "reduce_bcast": Program(coll._reduce_bcast_rounds(region, axes, 8)),
        "thread reduce (root 3)": Program(coll._rounds(
            region, "thread", sch.binomial_reduce_rounds(4, 3), "add")),
        "thread bcast (root 3)": Program(coll._rounds(
            region, "thread", sch.binomial_bcast_rounds(4, 3), "replace")),
        "every combine": Program([
            Round(ring, "copy"), Round(part, "add"), Round(ring, "max"),
            Round(part, "replace"), Round([(1, 1), (6, 6)], "mask")]),
    }
    if elems % 8 == 0:
        progs["ring"] = Program(coll._ring_rounds(region, axes, 8, c))
        progs["chunk rounds"] = Program([
            Round(ring, "copy"), Round(ring, "add", chunked),
            Round(ring, "replace", chunked)])
    return progs


def check_programs(dev, g, errs):
    """Every program (each combine; f32 / bf16 / int32 with -0.0, NaN,
    tiny negatives and overflowing sums, and f16 / f64 / int64) in ONE
    launch of each kernel and the staged variant, on both paths,
    bitwise against ``msgq_program_ref`` on the same card tensors."""
    from repro_torch.kernels.msgq import ops as mq
    from repro_torch.kernels.msgq.ref import msgq_program_ref

    paths, count, names = set(), 0, set()
    # 16-byte chunks, 5-element ones, a ragged slab, the bandwidth end
    for elems in (1024, 40, 37, 65536):
        progs = programs(dev, elems)
        names |= set(progs)
        for dtype in (torch.float32, torch.bfloat16, torch.int32,
                      torch.float16, torch.float64, torch.int64):
            if elems == 65536 and dtype.itemsize > 4:
                continue
            x = special(g, (8, elems), dtype, dev)
            for name, prog in progs.items():
                if name == "barrier" and dtype != torch.float32:
                    continue
                ref = msgq_program_ref(x, prog)
                for label, proto, cell in VARIANTS:
                    before = mq.counters()
                    out = mq.msgq_program(x, prog, proto=proto,
                                          cell_elems=cell // x.element_size())
                    torch.cuda.synchronize()
                    eager = mq.is_eager(proto)
                    require(msgq_delta(before, mq.counters())
                            == ((1, 0) if eager else (0, 1)),
                            f"program {name}: not one launch")
                    paths.add(mq.last_path)
                    held_to_ref(errs, KERNEL[eager], out, ref,
                                f"program {name} ({elems} x {dtype}, "
                                f"{label}, "
                                f"{mq.last_path})")
                    count += 1
    require(paths == {"bulk", "vector", "direct"},
            f"programs took the paths {sorted(paths)}")
    print(f"check msgq_program: {count} programs ({', '.join(sorted(names))}; 37 "
          "to 65536 elements a rank; f32/bf16/int32 with -0.0, NaN, tiny "
          "negatives and int32 overflow, f16/f64/int64; eager, 1-copy "
          "direct and staged; paths bulk, vector and direct): bitwise "
          "equal to msgq_program_ref", flush=True)


def phase_msgq(dev, timer):
    """7a: both msgq kernels against the plain version, bitwise (single
    messages, rounds on both paths and the staged variant, round
    programs of every combine), then their times at the path shapes and
    the bandwidth end, the empty-kernel floor, and the host-inclusive
    latency of one 64-byte message."""
    from repro_torch.core import protocol
    from repro_torch.kernels.msgq import ops as mq
    from repro_torch.kernels.msgq.ref import msgq_copy_ref, msgq_round_ref

    g = torch.Generator().manual_seed(7)
    errs = {"msgq_eager": 0.0, "msgq_one_copy": 0.0}
    checked = 0
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        item = torch.empty((), dtype=dtype).element_size()
        for n in [s // item for s in P2P_SIZES] + [17, 5000]:
            for force in (None, "eager", "one_copy"):
                msg = message(g, (n,), dtype, dev)
                before = mq.counters()
                out, proto = mq.msgq_copy(msg, force_protocol=force)
                want = force or protocol.select_protocol(
                    n * item, cell=1024 * item)
                eager = mq.is_eager(want)
                require(proto == want, f"msgq_copy {n} x {dtype}: protocol "
                        f"{proto}, the reference picks {want}")
                require(msgq_delta(before, mq.counters())
                        == ((1, 0) if eager else (0, 1)),
                        f"msgq_copy {n} x {dtype} {proto}: launches")
                torch.cuda.synchronize()
                held_to_ref(errs, KERNEL[eager], out, msgq_copy_ref(msg),
                            f"msgq_copy {n} x {dtype} {proto}")
                checked += 1
    msg = message(g, (7, 33, 5), torch.float32, dev)
    out, proto = mq.msgq_copy(msg)
    held_to_ref(errs, KERNEL[mq.is_eager(proto)], out, msgq_copy_ref(msg),
                "msgq_copy (7, 33, 5)")
    print(f"check msgq_copy: {checked + 1} messages of {P2P_SIZES[0]} B to "
          f"{P2P_SIZES[-1]} B, ragged 17 and 5000, f32/bf16/int32, auto "
          "and both forced protocols: bitwise equal to ref.py", flush=True)

    R = 8
    ring = [(i, (i + 1) % R) for i in range(R)]
    partial = [(0, 3), (5, 1), (2, 2), (7, 0)]      # 4-7 receive nothing
    rounds, paths = 0, set()
    for dtype in (torch.float32, torch.bfloat16, torch.int32, torch.uint8):
        for shape in ((R,), (R, 0), (R, 3), (R, 17), (R, 1024), (R, 5000),
                      (R, 16384), (R, 65536)):
            x = message(g, shape, dtype, dev)
            for pairs in (ring, partial):
                for label, proto, cell in VARIANTS:
                    out = mq.msgq_round(x, pairs, proto=proto, cell_elems=(
                        1024 if cell == 4096 else cell // x.element_size()))
                    torch.cuda.synchronize()
                    paths.add(mq.last_path)
                    require(out.data_ptr() != x.data_ptr() or x.numel() == 0,
                            "msgq_round wrote into its input")
                    held_to_ref(errs, KERNEL[mq.is_eager(proto)], out,
                                msgq_round_ref(x, pairs),
                                f"msgq_round {shape} {dtype} {proto} "
                                f"({label}, {mq.last_path})")
                    rounds += 1
    # strided slabs: the halo exchange's boundary planes, read in place
    # (MatMult's at 128^3 and 256^3)
    for shape in ((R, 4, 33, 7), (R, 16, 128, 128), (R, 16, 256, 256)):
        x = message(g, shape, torch.float32, dev)
        for edge in (x[:, :1], x[:, -1:]):
            for label, proto, cell in VARIANTS:
                out = mq.msgq_round(edge, ring, proto=proto,
                                    cell_elems=cell // 4)
                torch.cuda.synchronize()
                paths.add(mq.last_path)
                held_to_ref(errs, KERNEL[mq.is_eager(proto)], out,
                            msgq_round_ref(edge, ring),
                            f"msgq_round strided edge of {shape} {proto} "
                            f"({label}, {mq.last_path})")
                rounds += 1
    require(paths == {"bulk", "vector", "direct"},
            f"rounds took the paths {sorted(paths)}")
    print(f"check msgq_round: {rounds} rounds of 8 ranks (a ring and a "
          "partial round; 0 to 256 KiB a rank; f32/bf16/int32/uint8; "
          "strided halo planes of 128^3 and 256^3; eager, 1-copy direct "
          "and staged; paths bulk, vector and direct), both kernels: "
          f"bitwise equal to ref.py (max abs err {json.dumps(errs)})",
          flush=True)
    check_programs(dev, g, errs)

    rows = {}
    eager_x = message(g, (R, 1024), torch.float32, dev)
    halo = message(g, (R, 16, 128, 128), torch.float32, dev)[:, -1:]
    # the ring as one gather: out[d] = x[inverse[d]]
    inverse = torch.tensor([s for s, _ in sorted(ring, key=lambda p: p[1])],
                           device=dev)
    floor_ms = timer.ms(lambda: torch.cuda._sleep(0))
    print(f"time  empty kernel (the floor of one launch under this timer): "
          f"{floor_ms:.4f} ms", flush=True)
    for name, label, x, proto in (
            ("msgq_eager", "4 KiB ring round, 8 ranks", eager_x,
             "eager_fast"),
            ("msgq_one_copy", "64 KiB halo round (128^3), 8 ranks", halo,
             "one_copy")):
        nbytes = 2 * x.shape[0] * x[0].numel() * x.element_size()
        mq.msgq_round(x, ring, proto=proto)
        row = {"name": name, "route": "cuda", "source": MSGQ_SOURCE,
               "replaces": TPU_KERNELS[name], "launches": 0,
               "max_abs_err": errs[name], "shape": label,
               "dtype": "float32", "path": mq.last_path,
               "ms": timer.ms(lambda: mq.msgq_round(x, ring, proto=proto)),
               "plain_ms": timer.ms(lambda: msgq_round_ref(x, ring)),
               "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
               "bound_by": "bytes", "bound_bytes": nbytes,
               "library_ms": timer.ms(lambda: x.index_select(0, inverse)),
               "empty_kernel_ms": floor_ms}
        rows[name] = row
        print(f"time  {name:13s} {label:34s} ms={row['ms']:.4f} "
              f"plain_ms={row['plain_ms']:.4f} "
              f"library_ms={row['library_ms']:.4f} "
              f"bound_ms={row['bound_ms']:.6f} (bytes: {nbytes}; path "
              f"{row['path']})", flush=True)
    # the copies side by side, the bandwidth end included
    big = message(g, (1, 1 << 20), torch.float32, dev)         # 4 MiB
    wide = message(g, (R, 65536), torch.float32, dev)      # 256 KiB a rank
    bandwidth = {}
    for label, x, pairs in (("4 KiB ring round", eager_x, ring),
                            ("64 KiB halo round", halo, ring),
                            ("256 KiB-a-rank ring round", wide, ring),
                            ("4 MiB message", big, [(0, 0)])):
        nbytes = 2 * x.shape[0] * x[0].numel() * x.element_size()
        line, bandwidth[label] = [], {}
        for key, proto, cell in VARIANTS:
            ms = timer.ms(lambda: mq.msgq_round(x, pairs, proto=proto,
                                                cell_elems=cell // 4))
            gbs = nbytes / ms / 1e6
            bandwidth[label][key] = {"ms": ms, "GB_s": gbs,
                                     "hbm_share": gbs * 1e9 / HBM_BYTES_PER_S}
            line.append(f"{key} {ms:.4f} ms ({gbs:.1f} GB/s, "
                        f"{gbs * 1e9 / HBM_BYTES_PER_S:.3f} of 3.35 TB/s)")
        print(f"time  protocols at {label}: " + ", ".join(line), flush=True)
    rows["msgq_one_copy"]["bandwidth"] = bandwidth

    one = message(g, (1, 16), torch.float32, dev)       # a 64-byte message
    latency = {}
    for proto in ("eager_fast", "one_copy"):
        latency[proto] = host_ms(
            lambda: mq.msgq_round(one, [(0, 0)], proto=proto), iters=200)
    n = 1000
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        mq.msgq_round(one, [(0, 0)], proto="eager_fast")
    torch.cuda.synchronize()
    per_call_us = 1e6 * (time.perf_counter() - t0) / n
    rows["msgq_eager"]["latency_64B_ms"] = latency["eager_fast"]
    rows["msgq_one_copy"]["latency_64B_ms"] = latency["one_copy"]
    rows["msgq_eager"]["back_to_back_64B_us"] = per_call_us
    print(f"time  64 B message, host-inclusive (call + synchronize, median "
          f"of 200): eager {1e3 * latency['eager_fast']:.2f} us, 1-copy "
          f"{1e3 * latency['one_copy']:.2f} us; back to back (1000 calls, "
          f"one synchronize): {per_call_us:.2f} us a call", flush=True)
    model = protocol.DeviceModel()
    for name, x, proto in (("msgq_eager", eager_x, "eager_fast"),
                           ("msgq_one_copy", halo, "one_copy")):
        nbytes = x.shape[0] * x[0].numel() * x.element_size()
        t = (protocol.staged_copy_time if name == "msgq_eager"
             else protocol.direct_copy_time)(nbytes, model)
        got = host_ms(lambda: mq.msgq_round(x, ring, proto=proto), iters=50)
        rows[name]["host_inclusive_ms"] = got
        print(f"model {name:13s} {rows[name]['shape']}: DeviceModel "
              f"{1e3 * t:.4f} ms, measured host-inclusive {got:.4f} ms "
              f"(call + synchronize, median of 50)", flush=True)
    return rows


@functools.lru_cache(maxsize=None)
def local_mask(R: int, n: int, ranks: tuple, dev) -> torch.Tensor:
    """bool (R,): whose local rank (stacked rank mod n) is in ``ranks``,
    made once on the card (as the parent's ``Region.rank_mask``)."""
    return torch.isin(torch.arange(R) % n, torch.tensor(ranks)).to(dev)


@functools.lru_cache(maxsize=None)
def local_ranks(R: int, n: int, dev) -> torch.Tensor:
    return (torch.arange(R) % n).to(dev)


def by_rounds(schedule, v, fams, n, root=0):
    """A collective as it ran before the fold, built here: one msgq_round
    launch a round (``ppermute``'s protocol and cell) and the torch op of
    its step, on v (fams * n, ...) stacked process-major (``fams``
    families of n)."""
    from repro_torch.core import protocol
    from repro_torch.core import schedules as sch
    from repro_torch.kernels.msgq import ops as mq

    R = v.shape[0]

    def exchange(u, rnd):
        item = u.element_size()
        return mq.msgq_round(
            u, [(f * n + s, f * n + d) for f in range(fams) for s, d in rnd],
            proto=protocol.select_protocol(u[0].numel() * item),
            cell_elems=max(1, protocol.DEFAULT_CELL_SIZE // item))

    def view(mask, u):
        return mask.reshape((R,) + (1,) * (u.dim() - 1))

    def reduce(u, r):
        for rnd in sch.binomial_reduce_rounds(n, r):
            u = u + exchange(u, rnd)
        return u

    def bcast(u, r):
        for rnd in sch.binomial_bcast_rounds(n, r):
            received = exchange(u, rnd)
            is_dst = local_mask(R, n, tuple(d for _, d in rnd), v.device)
            u = torch.where(view(is_dst, u), received, u)
        return u

    if schedule == "barrier":
        for rnd in sch.dissemination_rounds(n):
            v = torch.maximum(v, exchange(v, rnd))
        return v
    if schedule == "reduce":
        return reduce(v, root)
    if schedule == "bcast":
        return bcast(v, root)
    if schedule == "recursive_doubling":
        for rnd in sch.recursive_doubling_rounds(n):
            v = v + exchange(v, rnd)
        return v
    if schedule == "reduce_bcast":
        v = reduce(v, 0)
        v = torch.where(view(local_mask(R, n, (0,), v.device), v), v,
                        torch.zeros_like(v))
        return bcast(v, 0)
    flat = v.reshape(R, -1)                             # the ring
    numel = flat.shape[1]
    if numel % n:
        flat = F.pad(flat, (0, (-numel) % n))
    chunks = flat.reshape(R, n, -1)
    c = chunks.shape[2]
    rank = local_ranks(R, n, v.device)
    ring = sch.ring_rounds(n)[0]

    def at(idx):
        return (idx % n).view(R, 1, 1).expand(R, 1, c)

    for t in range(n - 1):
        blk = chunks.gather(1, at(rank - t))[:, 0]
        chunks = chunks.scatter_add(1, at(rank - t - 1),
                                    exchange(blk, ring)[:, None])
    for t in range(n - 1):
        blk = chunks.gather(1, at(rank - t + 1))[:, 0]
        chunks = chunks.scatter(1, at(rank - t), exchange(blk, ring)[:, None])
    return chunks.reshape(R, -1)[:, :numel].reshape(v.shape)


#: a spin (GPU cycles, ~10 ms) longer than the host takes to issue a
#: collective's 14 rounds one by one, so the events time device work
COLLECTIVE_SPIN = 20_000_000


def phase_collectives(dev, path):
    """7b: the Comm API's collectives on a 2 x 4 threadcomm, each against
    psum (rtol 1e-5) and each with the msgq launches it implies; every
    folded collective also bitwise against the same collective run round
    by round on the card (``by_rounds``), with the device and
    host-inclusive times of both and of the native psum / pmax."""
    from repro_torch.core import threadcomm_init
    from repro_torch.core.compat import make_mesh

    tc = threadcomm_init(make_mesh(*MESH), process_axes=("proc",),
                         thread_axes=("thread",), num_threads=4)
    cpu = threadcomm_init(make_mesh(*MESH, device="cpu"),
                          process_axes=("proc",), thread_axes=("thread",))
    g = torch.Generator().manual_seed(11)
    times = {}
    timer = Timer(dev)
    with tc.start(), cpu.start():
        tcm, pcm = tc.thread_comm(), tc.process_comm()
        ring = [(i, (i + 1) % tc.size) for i in range(tc.size)]
        tring = [(i, (i + 1) % 4) for i in range(4)]

        def token(c, v):
            return v[:, 0, 0] + c.device_rank()

        def tree_by_rounds(v):
            y = by_rounds("reduce", v, 2, 4)
            return by_rounds("bcast", pcm.allreduce(y), 2, 4)

        for nelem in (1024, 65536):
            x = torch.rand(tc.size, nelem, generator=g).to(dev)
            want = x.sum(0, keepdim=True).expand(tc.size, nelem)
            top = (x[:, 0] + torch.arange(tc.size, device=dev)).max().expand(
                tc.size, 1)
            small = nelem * 4 <= 4096
            k = (lambda n: (n, 0)) if small else (lambda n: (0, n))
            chunk = (lambda n: (n, 0)) if nelem // 8 * 4 <= 4096 else \
                (lambda n: (0, n))
            # (label, op on a comm, msgq launches (eager, 1-copy), the
            # expected result (None: the same op on the CPU's plain path),
            # the same op round by round (None: not folded))
            cases = [
                ("allreduce psum", lambda c, v: c.allreduce(v), (0, 0), want,
                 None),
                ("allreduce recursive_doubling", lambda c, v: c.allreduce(
                    v, schedule="recursive_doubling"), k(1), want,
                 lambda v: by_rounds("recursive_doubling", v, 1, 8)),
                ("allreduce ring", lambda c, v: c.allreduce(
                    v, schedule="ring"), chunk(1), want,
                 lambda v: by_rounds("ring", v, 1, 8)),
                ("allreduce reduce_bcast", lambda c, v: c.allreduce(
                    v, schedule="reduce_bcast"), k(1), want,
                 lambda v: by_rounds("reduce_bcast", v, 1, 8)),
                ("allreduce hierarchical", lambda c, v: c.allreduce(
                    v, schedule="hierarchical"), (0, 0), want, None),
                ("allreduce hierarchical_tree", lambda c, v: c.allreduce(
                    v, schedule="hierarchical_tree"), k(2), want,
                 tree_by_rounds),
                ("allreduce wire bf16", lambda c, v: c.allreduce(
                    v, wire_dtype="bfloat16"),
                 (3, 0) if nelem * 2 <= 4096 else (0, 3), None, None),
                ("barrier msg", lambda c, v: c.barrier(
                    token(c, v))[:, None, None], (1, 0), top,
                 lambda v: by_rounds("barrier", token(tc, v), 1, 8)[
                     :, None, None]),
                ("barrier atomic", lambda c, v: c.barrier(
                    token(c, v), mode="atomic")[:, None, None], (0, 0), top,
                 None),
                ("send_recv ring (root)", lambda c, v: c.send_recv(v, ring),
                 k(1), torch.roll(x, 1, 0), None),
                ("send_recv thread ring", lambda c, v:
                 c.thread_comm().send_recv(v, tring), k(1),
                 torch.cat([torch.roll(x[:4], 1, 0),
                            torch.roll(x[4:], 1, 0)]), None),
                ("send_recv forced eager", lambda c, v: c.send_recv(
                    v, ring, force_protocol="eager"), (1, 0),
                 torch.roll(x, 1, 0), None),
                ("send_recv forced one_copy", lambda c, v: c.send_recv(
                    v, ring, force_protocol="one_copy"), (0, 1),
                 torch.roll(x, 1, 0), None),
            ]
            for label, op, launches, ref, rounds in cases:
                fn = functools.partial(op, tc)
                out, got = on_path(path, lambda: tc.run(fn, x))
                torch.cuda.synchronize()
                require(got == launches, f"{label} ({nelem}): msgq launches "
                        f"(eager, 1-copy) {got}, the schedule implies "
                        f"{launches}")
                if ref is None:
                    ref = cpu.run(functools.partial(op, cpu),
                                  x.cpu()).to(dev)
                require(bool(torch.allclose(out, ref, rtol=1e-5, atol=0)),
                        f"{label} ({nelem}): disagrees with its reference "
                        f"(max abs err {float((out - ref).abs().max()):.3e})")
                row = {"launches": list(got),
                       "host_ms": host_ms(lambda: tc.run(fn, x))}
                note = ""
                if rounds is not None or "psum" in label or "atomic" in label:
                    row["device_ms"] = timer.ms(lambda: tc.run(fn, x),
                                                spin=COLLECTIVE_SPIN)
                    note = f", device {row['device_ms']:.4f} ms"
                if rounds is not None:
                    by = tc.run(rounds, x)
                    torch.cuda.synchronize()
                    require(bitwise(out, by), f"{label} ({nelem}): the folded "
                            "program differs from its rounds one by one")
                    row["rounds_host_ms"] = host_ms(lambda: tc.run(rounds, x))
                    row["rounds_device_ms"] = timer.ms(
                        lambda: tc.run(rounds, x), spin=COLLECTIVE_SPIN)
                    note += (f"; bitwise equal to its rounds one by one: "
                             f"host {row['rounds_host_ms']:.4f} ms, device "
                             f"{row['rounds_device_ms']:.4f} ms")
                times[f"{label} {nelem}"] = row
                print(f"check collective {label:30s} {nelem * 4:7d} B/rank "
                      f"msgq (eager, 1-copy) {got}: ok, host "
                      f"{row['host_ms']:.4f} ms{note}", flush=True)

            def pipeline(v):                    # v: (R, 1, nelem)
                with tc.stream("grad") as s:
                    r1 = tcm.ireduce_scatter(v.reshape(v.shape[0], -1))
                    r2 = pcm.iallreduce(r1.wait(),
                                        schedule="recursive_doubling")
                    full = tcm.iallgather(r2.wait()).wait()
                    require(len(s._requests) == 3 and s._cuda is not None
                            and torch.cuda.current_stream() == s._cuda,
                            "the requests did not run on the grad stream's "
                            "CUDA stream")
                return full.reshape(v.shape)

            out, got = on_path(path, lambda: tc.run(pipeline, x))
            shard = nelem // 4 * 4
            require(got == ((1, 0) if shard <= 4096 else (0, 1)),
                    f"stream pipeline ({nelem}): msgq launches {got}")
            ok = bool(torch.allclose(out, want, rtol=1e-5, atol=0))
            require(ok, f"stream pipeline ({nelem}): disagrees with psum")
            times[f"stream pipeline {nelem}"] = {
                "launches": list(got),
                "host_ms": host_ms(lambda: tc.run(pipeline, x))}
            print(f"check collective {'ireduce_scatter>iallreduce>'
                                      'iallgather on a grad CUDA stream':30s}"
                  f" {nelem * 4:7d} B/rank msgq {got}: ok, host "
                  f"{times[f'stream pipeline {nelem}']['host_ms']:.4f} ms",
                  flush=True)
    tc.free()
    cpu.free()
    return times


def phase_petsc(dev, path):
    """7c: the PETSc case study — threadcomm_init over 2 x 4, the
    slab-decomposed 27-point MatMult at 128^3 and 256^3 against the
    single-rank oracle, and CG(10) at 128^3 against cg_solve_ref."""
    from repro_torch.apps import spmv
    from repro_torch.core import threadcomm_init
    from repro_torch.core.compat import P, make_mesh

    tc = threadcomm_init(make_mesh(*MESH), process_axes=("proc",),
                         thread_axes=("thread",))
    axes, ranks = tc.unified_axes, tc.size
    g = torch.Generator().manual_seed(0)
    res = {}
    with tc.start():
        matmult = spmv.make_distributed_matmult(axes, ranks)
        for n in (128, 256):
            b = torch.randn(n, n, n, generator=g).to(dev)
            y, got = on_path(path, lambda: tc.run(matmult, b))
            ref = spmv.stencil_matmult_ref(b)
            torch.cuda.synchronize()
            err = float((y - ref).abs().max())
            scale = float(ref.abs().max())
            require(bool(torch.isfinite(y).all()) and y.shape == b.shape,
                    f"MatMult {n}^3: bad output")
            require(got == (0, 2), f"MatMult {n}^3: msgq launches (eager, "
                    f"1-copy) {got}, expected (0, 2)")
            require(err <= 1e-4 * scale, f"MatMult {n}^3: max abs err "
                    f"{err:.3e} > 1e-4 x {scale:.3e}")
            ms = host_ms(lambda: tc.run(matmult, b))
            ref_ms = host_ms(lambda: spmv.stencil_matmult_ref(b))
            res[f"matmult_{n}"] = {"ms": ms, "oracle_ms": ref_ms,
                                   "max_abs_err": err, "max_abs_y": scale}
            print(f"check petsc MatMult {n}^3 on {ranks} unified ranks: max "
                  f"abs err {err:.3e} (tol {1e-4 * scale:.3e}), msgq "
                  f"{got}: ok; {ms:.4f} ms (single-rank oracle "
                  f"{ref_ms:.4f} ms)", flush=True)

        b = torch.randn(128, 128, 128, generator=g).to(dev)
        cg = spmv.make_distributed_cg(axes, ranks, CG_ITERS)
        (x, hist), got = on_path(
            path, lambda: tc.run(cg, b, out_specs=(P(axes), P())))
        x_ref = spmv.cg_solve_ref(b, iters=CG_ITERS)
        torch.cuda.synchronize()
        err = float((x - x_ref).abs().max())
        require(got == (0, 2 * (CG_ITERS + 1)),
                f"CG: msgq launches {got}, expected 2 per MatMult")
        require(bool(torch.isfinite(x).all()) and err <= 1e-3,
                f"CG({CG_ITERS}) 128^3: max |x - x_ref| = {err:.3e}")
        ms = host_ms(lambda: tc.run(cg, b, out_specs=(P(axes), P())),
                     iters=5)
        ref_ms = host_ms(lambda: spmv.cg_solve_ref(b, iters=CG_ITERS),
                         iters=5)
        history = [float(v) for v in hist.cpu()]
        res["cg_128"] = {"ms": ms, "oracle_ms": ref_ms, "max_abs_err": err,
                         "residual_history": history}
        print(f"check petsc CG({CG_ITERS}) 128^3 on {ranks} unified ranks: "
              f"max |x - x_ref| = {err:.3e} (tol 1e-3), msgq {got}: ok; "
              f"{ms:.4f} ms (single-rank oracle {ref_ms:.4f} ms)",
              flush=True)
        print("petsc CG residual history: "
              + ", ".join(f"{v:.6e}" for v in history), flush=True)
    tc.free()
    return res


def phase_threadcomm(dev):
    """Phase 7: kernels against their plain versions (7a), then the
    threadcomm path (7b collectives, 7c PETSc) with the msgq counters
    zeroed just before; the path's launches are the sum of each call's own
    (``on_path``), so its timing loops and plain-path comparisons stay
    out."""
    from repro_torch.kernels.msgq import ops as mq

    timer = Timer(dev)
    rows = phase_msgq(dev, timer)
    del timer
    torch.cuda.empty_cache()
    mq.reset_counters()
    path = dict.fromkeys(mq.counters(), 0)
    collectives = phase_collectives(dev, path)
    petsc = phase_petsc(dev, path)
    require(path["eager_launches"] > 0, "msgq_eager never launched")
    require(path["one_copy_launches"] > 0, "msgq_one_copy never launched")
    require(path["ref_calls"] == 0,
            f"plain msgq ran {path['ref_calls']} times on the card")
    rows["msgq_eager"]["launches"] = path["eager_launches"]
    rows["msgq_one_copy"]["launches"] = path["one_copy_launches"]
    print("threadcomm kernels on the path: " + json.dumps(path), flush=True)
    print("threadcomm: " + json.dumps({"collectives": collectives,
                                       "petsc": petsc}), flush=True)
    return rows


# ---------------------------------------------------------------------------
# phase 8: the SSM and hybrid families — the SSD scan kernel, the models,
# serving
# ---------------------------------------------------------------------------

#: (label, B, H, S, p, n, seeded initial state); every case on the chunk
#: grid l = 128 (the configs' ssm_chunk). mamba2: H=32, p=64, n=128;
#: hymba: H=50, p=64, n=16
SSD_CASES = [
    ("mamba2 B=1 S=128", 1, 32, 128, 64, 128, False),
    ("mamba2 B=2 S=128", 2, 32, 128, 64, 128, False),
    ("mamba2 B=8 S=128", 8, 32, 128, 64, 128, False),
    ("mamba2 B=1 S=256", 1, 32, 256, 64, 128, False),
    ("mamba2 B=2 S=256", 2, 32, 256, 64, 128, False),
    ("mamba2 B=8 S=256", 8, 32, 256, 64, 128, False),
    ("hymba B=2 S=256", 2, 50, 256, 64, 16, False),
    ("ragged B=2 S=200", 2, 32, 200, 64, 128, False),
    ("initial state B=2 S=256", 2, 32, 256, 64, 128, True),
    ("path B=2 S=128 state", 2, 32, 128, 64, 128, True),
]
#: the shape the kernel table reports: a mamba2 chunk dispatch of 2 rows
#: resuming a carried state, as the serve phase runs it
SSD_TABLE_CASE = "path B=2 S=128 state"
SSD_CHUNK = 128


def ssd_inputs(dev, dtype, B, H, S, p, n, state, seed):
    """x, dt, A, Bm, Cm (and s0) on the card, x and dt as the model hands
    them: (B, S, H, p) and (B, S, H) tensors passed as (B, H, S, ...)
    views. dt = 0.1 softplus(N(0, 1)), A = -exp(0.3 N(0, 1)), as the
    reference's kernel tests draw them."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, S, H, p, generator=g)
    dt = F.softplus(torch.randn(B, S, H, generator=g)) * 0.1
    A = -torch.exp(torch.randn(H, generator=g) * 0.3)
    Bm = torch.randn(B, S, n, generator=g) * 0.5
    Cm = torch.randn(B, S, n, generator=g) * 0.5
    s0 = torch.randn(B, H, p, n, generator=g) * 0.2 if state else None
    out = [x.to(dev, dtype).transpose(1, 2), dt.to(dev).transpose(1, 2),
           A.to(dev), Bm.to(dev), Cm.to(dev)]
    return out + [None if s0 is None else s0.to(dev)]


def ssd_needs(B, H, S, p, n, l, x_item, state):
    """Bytes (x, dt, A, B, C and the initial state read once, y and the
    final state written once) and flops (the four products over this
    run's chunks: causal score pairs x (n + p), the carried term and the
    fold r x n x p each) of one scan."""
    nbytes = (2 * B * H * S * p * x_item + 4 * B * H * S + 4 * H
              + 2 * 4 * B * S * n + (2 if state else 1) * 4 * B * H * p * n)
    flops = 0
    for c0 in range(0, S, l):
        r = min(l, S - c0)
        pairs = r * (r + 1) // 2
        flops += 2 * pairs * (n + p) + 4 * r * n * p
    return nbytes, B * H * flops


def phase_ssd(dev, timer):
    """8(a): the SSD scan kernel against both plain versions, bitwise
    resume, and its time at the path shape."""
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_scan, ssd_scan_ref

    row = {"name": "ssd_scan", "route": "cuda", "source": SSD_SOURCE,
           "replaces": TPU_KERNELS["ssd_scan"], "launches": 0,
           "max_abs_err_by_dtype": {},
           "ptxas": ptxas_report(Path(SSD_SOURCE).name)}
    for dtype in (torch.float32, torch.bfloat16):
        worst = 0.0
        for label, B, H, S, p, n, state in SSD_CASES:
            args = ssd_inputs(dev, dtype, B, H, S, p, n, state,
                              seed=S + B + H + n)
            before = sops.ssd_launches
            y, fs = sops.ssd_scan(*args, chunk=SSD_CHUNK, return_state=True)
            require(sops.ssd_launches == before + 1,
                    f"ssd {label}: the kernel was not launched")
            tol = SSD_TOL[dtype]
            for plain_name, plain in (
                    ("ssd_chunked_scan", lambda: ssd_chunked_scan(
                        *args, chunk=SSD_CHUNK, return_state=True)),
                    ("ssd_scan_ref", lambda: ssd_scan_ref(
                        *args, return_state=True))):
                ry, rf = plain()
                torch.cuda.synchronize()
                require(bool(torch.isfinite(y.float()).all())
                        and bool(torch.isfinite(fs).all()),
                        f"ssd {label} {dtype}: non-finite output")
                errs = []
                for got, ref, t in ((y.float(), ry.float(), tol),
                                    (fs, rf, SSD_TOL[torch.float32])):
                    err = (got - ref).abs()
                    errs.append(float(err.max()))
                    require(not bool((err > t + t * ref.abs()).any()),
                            f"ssd {label} {dtype}: disagrees with "
                            f"{plain_name} (max abs err {errs[-1]:.3e})")
                worst = max(worst, *errs)
                print(f"check ssd_scan {label:24s} {str(dtype):14s} vs "
                      f"{plain_name:16s} max_abs_err y={errs[0]:.3e} "
                      f"state={errs[1]:.3e} tol={tol:g} ok", flush=True)
        row["max_abs_err_by_dtype"][str(dtype).split(".")[-1]] = worst
    row["max_abs_err"] = max(row["max_abs_err_by_dtype"].values())

    # resume: one call over 256 tokens against 128 + 128, bit for bit
    for label, H, n in (("mamba2", 32, 128), ("hymba", 50, 16)):
        x, dt, A, Bm, Cm, _ = ssd_inputs(dev, torch.float32, 2, H, 256, 64,
                                         n, False, seed=H)
        y, fs = sops.ssd_scan(x, dt, A, Bm, Cm, chunk=SSD_CHUNK,
                              return_state=True)
        h = 128
        y1, f1 = sops.ssd_scan(x[:, :, :h], dt[:, :, :h], A, Bm[:, :h],
                               Cm[:, :h], chunk=SSD_CHUNK, return_state=True)
        y2, f2 = sops.ssd_scan(x[:, :, h:], dt[:, :, h:], A, Bm[:, h:],
                               Cm[:, h:], f1, chunk=SSD_CHUNK,
                               return_state=True)
        torch.cuda.synchronize()
        same = (torch.equal(torch.cat([y1, y2], 2), y)
                and torch.equal(f2, fs))
        print(f"check ssd_scan resume {label}: 256 tokens in one call vs "
              f"128 + 128 threaded through the state: bitwise {same}",
              flush=True)
        require(same, f"ssd_scan resume ({label}) is not bit-exact")

    # the column split changes no bit: 2 rows alone (narrow slices, to
    # fill the card) against the same rows inside a batch of 8 (wider)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, H, n in (("mamba2", 32, 128), ("hymba", 50, 16)):
        x, dt, A, Bm, Cm, s0 = ssd_inputs(dev, torch.float32, 8, H, 256, 64,
                                          n, True, seed=H + 1)
        y8, f8 = sops.ssd_scan(x, dt, A, Bm, Cm, s0, chunk=SSD_CHUNK,
                               return_state=True)
        y2, f2 = sops.ssd_scan(x[:2], dt[:2], A, Bm[:2], Cm[:2], s0[:2],
                               chunk=SSD_CHUNK, return_state=True)
        torch.cuda.synchronize()
        small = sops.plan(2, H, 64, n, SSD_CHUNK)
        big = sops.plan(8, H, 64, n, SSD_CHUNK)
        same = torch.equal(y2, y8[:2]) and torch.equal(f2, f8[:2])
        print(f"check ssd_scan column split {label}: B=2 ({small.ctas} CTAs "
              f"of {small.cols} columns) vs the same rows in B=8 "
              f"({big.ctas} CTAs of {big.cols}): bitwise {same}", flush=True)
        require(same, f"ssd_scan column split ({label}) changes the result")

    label, B, H, S, p, n, state = next(c for c in SSD_CASES
                                       if c[0] == SSD_TABLE_CASE)
    args = ssd_inputs(dev, torch.float32, B, H, S, p, n, state, seed=1)
    nbytes, flops = ssd_needs(B, H, S, p, n, SSD_CHUNK, 4, state)
    shape = sops.plan(B, H, p, n, SSD_CHUNK)
    require(shape.ctas >= sms, f"ssd_scan {label}: {shape.ctas} CTAs on "
            f"{sms} SMs")
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / PEAK_FLOPS[torch.float32]
    row.update(
        shape=label, dtype="float32",
        ms=timer.ms(lambda: sops.ssd_scan(*args, chunk=SSD_CHUNK,
                                          return_state=True)),
        plain_ms=timer.ms(lambda: ssd_chunked_scan(*args, chunk=SSD_CHUNK,
                                                   return_state=True)),
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bound_bytes=nbytes, bound_flops=flops, library_ms=None,
        library_note="no single PyTorch call computes the SSD scan",
        ctas=shape.ctas, cols_per_cta=shape.cols,
        smem_bytes=shape.smem_bytes)
    print(f"time  ssd_scan {label:24s} f32 ms={row['ms']:.4f} "
          f"plain_ms={row['plain_ms']:.4f} library_ms=None "
          f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}: {nbytes} "
          f"bytes, {flops} flops), {shape.ctas} CTAs of {shape.cols} "
          f"columns, {shape.smem_bytes} B of shared memory a CTA on {sms} "
          "SMs", flush=True)
    for label, B, H, S, p, n in (("static prefill B=8 S=256", 8, 32, 256,
                                  64, 128),
                                 ("hymba chunk B=2 S=128", 2, 50, 128, 64,
                                  16)):
        a = ssd_inputs(dev, torch.float32, B, H, S, p, n, True, seed=2)
        nb, fl = ssd_needs(B, H, S, p, n, SSD_CHUNK, 4, True)
        ms = timer.ms(lambda: sops.ssd_scan(*a, chunk=SSD_CHUNK,
                                            return_state=True))
        sh = sops.plan(B, H, p, n, SSD_CHUNK)
        row.setdefault("times", []).append(
            {"shape": label, "ms": ms, "ctas": sh.ctas,
             "cols_per_cta": sh.cols, "smem_bytes": sh.smem_bytes,
             "bound_ms": max(1e3 * nb / HBM_BYTES_PER_S,
                             1e3 * fl / PEAK_FLOPS[torch.float32])})
        print(f"time  ssd_scan {label:24s} f32 ms={ms:.4f} ({sh.ctas} CTAs "
              f"of {sh.cols} columns, {sh.smem_bytes} B, bound "
              f"{row['times'][-1]['bound_ms']:.5f} ms)", flush=True)
    return row


def require_same_state(cache, before, rows, label):
    """The carried state of ``rows`` is byte-identical to ``before``."""
    for k in ("conv", "ssm"):
        require(torch.equal(cache[k][:, rows], before[k][:, rows]),
                f"{label}: the {k} state of rows {rows} changed")


def phase_family_model(dev, arch):
    """8(b): one model at full width and depth from seed 0, in bfloat16
    (the serving dtype) and again in float32, each step through the
    kernels and again through the plain scan and attention."""
    from repro_torch.config import ServeConfig
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    cfg = get_config(arch)
    res = {}
    for dtype in ("bfloat16", "float32"):
        t0 = time.perf_counter()
        model = build_model(cfg, ServeConfig(param_dtype=dtype,
                                             compute_dtype=dtype),
                            device=dev)
        params = model.init(0)
        torch.cuda.synchronize()
        print(f"model {cfg.name}: {cfg.num_layers} layers, d_model "
              f"{cfg.d_model}, {cfg.num_heads}x{cfg.head_dim} heads (kv "
              f"{cfg.num_kv_heads}), ssm {cfg.ssm_heads}x{cfg.ssm_head_dim} "
              f"heads, state {cfg.ssm_state}, d_ff {cfg.d_ff}, vocab "
              f"{cfg.vocab_size}, {cfg.param_count() / 1e9:.3f} B params, "
              f"{model.dtype}, built in {time.perf_counter() - t0:.1f} s",
              flush=True)
        res[dtype] = family_steps(model, params, cfg, dev)
        del model, params
        torch.cuda.empty_cache()
    return res


def family_steps(model, params, cfg, dev):
    """The 8(b) steps of one model: a monolithic prefill (B=4, S=256),
    slot chunks at pos0 0 and 128 and a slot decode step, paged chunks at
    pos0 0 and 128 and a paged decode step. Each step runs on the kernel
    path, whose cache carries on, and on each plain path from a copy of
    the cache taken before it. In float32 the kernel path is held to the
    plain path within MODEL_F32_REL_TOL; in bfloat16 each scan step is
    held within the larger of MODEL_REL_TOL and NOISE_FLOOR_FACTOR x its
    noise floor (the plain path with the sequential scan)."""
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_scan, ssd_scan_ref

    arch = f"{cfg.name} {str(model.dtype).split('.')[-1]}"
    attn = cfg.uses_attention
    bf16 = model.dtype == torch.bfloat16
    plain_mono = {"scan": ssd_chunked_scan}
    plain_paged = {"scan": ssd_chunked_scan}
    if attn:
        plain_mono["attention"] = plain_flash
        plain_paged["attention"] = paged_attention_ref

    def sequential(*a, chunk, return_state):
        return ssd_scan_ref(*a, return_state=return_state)

    def clone(cache):
        return None if cache is None else {k: v.clone()
                                           for k, v in cache.items()}

    def step(label, fn, cache, plain):
        """``fn(cache, **overrides)`` -> logits on every path; check."""
        paths = {"plain": plain}
        if bf16:
            paths["floor"] = {**plain, "scan": sequential}
        copies = {name: clone(cache) for name in paths}
        out = fn(cache)
        outs = {name: fn(copies[name], **kw) for name, kw in paths.items()}
        if not bf16:
            return out, compare(label, out, outs["plain"], cfg,
                                tol=MODEL_F32_REL_TOL)
        floor = rel_diff(outs["floor"], outs["plain"], cfg)
        return out, compare(
            label, out, outs["plain"], cfg,
            tol=max(MODEL_REL_TOL, NOISE_FLOOR_FACTOR * floor), floor=floor,
            floor_agree=argmax_agree(outs["floor"], outs["plain"], cfg))

    rng = np.random.default_rng(3)
    V, C = cfg.vocab_size, cfg.ssm_chunk
    res = {}

    def on(a):
        return torch.as_tensor(np.asarray(a)).to(dev)

    S, W = 256, 256 + 48
    tok = on(rng.integers(0, V, size=(4, S)))
    _, res["prefill"] = step(
        f"{arch} monolithic prefill (B=4, S=256)",
        lambda _, **kw: model.prefill(params, tok, W, **kw)[0], None,
        plain_mono)

    # slot chunks at pos0 0 and 128 (row 1's second chunk partial: 100 of
    # 128), then a slot decode step with row 1 parked
    n_last = C * 25 // 32
    prompts = rng.integers(0, V, size=(2, 2 * C))
    cache = model.init_cache(2, W)
    for pos0, n_valid in ((0, [C, C]), (C, [C, n_last])):
        args = (on(prompts[:, pos0:pos0 + C]), on([pos0, pos0]),
                on(n_valid))
        lg, res[f"slot_chunk_{pos0}"] = step(
            f"{arch} slot chunk (B=2, C={C}, pos0={pos0})",
            lambda c, **kw: model.prefill_chunk(params, c, *args, **kw),
            cache, {"scan": ssd_chunked_scan})
    before = clone(cache)
    nxt = lg.argmax(-1, keepdim=True)
    model.decode_step(params, cache, nxt, on([2 * C, PARK_POS]))
    require_same_state(cache, before, [1], f"{arch} slot decode")

    # paged: 4 request rows, chunk rows aimed at rows 2 and 0; rows 1 and
    # 3 sit outside every chunk, then rows 1 and 3 are parked in decode
    bs, R = 16, 4
    NB = -(-(2 * C + 16) // bs)
    tables = torch.from_numpy(rng.permutation(R * NB).astype(
        np.int32).reshape(R, NB)).to(dev)
    pool = model.init_paged_cache(R * NB, bs, num_rows=R)
    rows = [2, 0]
    untouched = clone(pool)
    chunk_args = None
    for pos0, n_valid in ((0, [C, C]), (C, [C, n_last])):
        chunk_args = (on(prompts[:, pos0:pos0 + C]), tables[rows],
                      torch.tensor(rows), on([pos0, pos0]), on(n_valid))
        lg, res[f"paged_chunk_{pos0}"] = step(
            f"{arch} paged chunk (B=2, C={C}, pos0={pos0})",
            lambda c, **kw: model.prefill_chunk_paged(params, c,
                                                      *chunk_args, **kw),
            pool, plain_paged)
    require_same_state(pool, untouched, [1, 3], f"{arch} paged chunks")
    nxt = torch.zeros((R, 1), dtype=torch.int64, device=dev)
    nxt[rows] = lg.argmax(-1, keepdim=True)
    positions = on([C + n_last, PARK_POS, 2 * C, PARK_POS])
    ref_pool = clone(pool)
    before = clone(pool)
    dec = model.decode_step_paged(params, pool, nxt, positions, tables)
    kw = {"attention": paged_attention_ref} if attn else {}
    ref_dec = model.decode_step_paged(params, ref_pool, nxt, positions,
                                      tables, **kw)
    res["paged_decode"] = compare(
        f"{arch} paged decode (rows 0 and 2)", dec[[0, 2]], ref_dec[[0, 2]],
        cfg, tol=MODEL_REL_TOL if bf16 else MODEL_F32_REL_TOL)
    require_same_state(pool, before, [1, 3], f"{arch} paged decode")
    print(f"check {arch}: parked rows and rows outside the chunks kept "
          "their carried state byte for byte", flush=True)

    if bf16 and not attn:
        # mamba2's step profile: a chunk dispatch of 2 rows and a decode
        # step of 4 rows (re-running a step rewrites the same state rows
        # from the same inputs)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        state = clone(pool)
        for _ in range(2):
            ev[0].record()
            model.prefill_chunk_paged(params, pool, *chunk_args)
            ev[1].record()
            model.decode_step_paged(params, pool, nxt, positions, tables)
            ev[2].record()
            for k, v in state.items():
                pool[k].copy_(v)
        torch.cuda.synchronize()
        res["chunk_step_ms"] = ev[0].elapsed_time(ev[1])
        res["decode_step_ms"] = ev[1].elapsed_time(ev[2])
        print(f"model step time ({arch}, kernel path): paged chunk (B=2, "
              f"C={C}) {res['chunk_step_ms']:.3f} ms, paged decode (B={R}) "
              f"{res['decode_step_ms']:.3f} ms", flush=True)
        names = ("ssd_kernel",) + ATTENTION_KERNELS
        res["chunk_profile"] = profile_step(
            f"{arch} paged chunk",
            lambda: model.prefill_chunk_paged(params, pool, *chunk_args),
            res["chunk_step_ms"], names)
        res["decode_profile"] = profile_step(
            f"{arch} paged decode",
            lambda: model.decode_step_paged(params, pool, nxt, positions,
                                            tables),
            res["decode_step_ms"], names)
    return res


def require_path_launches(counts, cfg, label):
    """8(d): the scan launched once per layer per chunk dispatch and per
    monolithic prefill; attention kernels ran where the family attends;
    no plain version ran."""
    L = cfg.num_layers
    want = L * (counts["chunk_calls"] + counts["prefill_calls"])
    require(counts["chunk_calls"] > 0, f"{label}: no chunk dispatch ran")
    require(counts["ssd_launches"] == want,
            f"{label}: ssd_scan launched {counts['ssd_launches']} times for "
            f"{counts['chunk_calls']} chunk dispatches + "
            f"{counts['prefill_calls']} monolithic prefills x {L} layers")
    if cfg.uses_attention:
        require(counts["decode_launches"] > 0 and counts["mq_launches"] > 0,
                f"{label}: a paged-attention kernel never launched")
        require(counts["flash_launches"] == L * counts["prefill_calls"],
                f"{label}: flash launches {counts['flash_launches']} for "
                f"{counts['prefill_calls']} prefills x {L} layers")
    else:
        require(counts["decode_launches"] == counts["mq_launches"]
                == counts["flash_launches"] == 0,
                f"{label}: an attention kernel ran in an attention-free "
                "model")
    require(counts["ref_calls"] == counts["flash_ref_calls"]
            == counts["ssd_ref_calls"] == 0,
            f"{label}: a plain version ran on the card")


def phase_family_serve():
    """8(c), (d): run_serve per arch, then run_family_rows for both."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch

    archs = ("mamba2-370m", "hymba-1.5b")
    out = {"serve": {}, "launches": {}}
    for arch in archs:
        cfg = get_config(arch)
        res = launch.run_serve(arch, device="cuda", requests=16, slots=8,
                               prompt_len=(16, 256), max_new=(4, 48),
                               rate=50.0, prefill_chunk=128,
                               max_prefill_per_step=2, block_size=16, seed=0)
        counts = res["kernels"]
        stats = res["continuous"]
        require(res["prefill_chunk"] == 128,
                f"{arch}: chunk {res['prefill_chunk']}, expected 128")
        require(stats.get("n") == 16.0, f"{arch}: served {stats.get('n')} "
                "of 16")
        for rid, toks in enumerate(res["outputs"]):
            require(len(toks) > 0 and all(0 <= t < cfg.vocab_size
                                          for t in toks),
                    f"{arch} request {rid}: no token or out of vocab")
        require_path_launches(counts, cfg, f"{arch} run_serve")
        out["serve"][arch] = {k: res[k] for k in (
            "continuous_tok_s", "ttft_p50_ms", "ttft_p95_ms",
            "state_bytes_per_slot")}
        out["serve"][arch]["makespan_s"] = stats["makespan_s"]
        out["launches"][f"{arch} run_serve"] = counts
        print(f"serve {arch}: 16 requests, {stats['useful_tokens']:.0f} "
              f"tokens in {stats['makespan_s']:.3f} s: "
              f"{res['continuous_tok_s']:.2f} tok/s, TTFT p50 "
              f"{res['ttft_p50_ms']:.2f} ms p95 {res['ttft_p95_ms']:.2f} ms, "
              f"state_bytes_per_slot {res['state_bytes_per_slot']}, "
              f"max_memory_allocated {res.get('max_memory_allocated')} "
              "bytes", flush=True)
        out["serve"][arch]["max_memory_allocated"] = res.get(
            "max_memory_allocated")
        print(f"serve {arch} kernels: " + json.dumps(counts), flush=True)
        torch.cuda.empty_cache()

    kw = dict(smoke=False, device="cuda", requests=6, slots=4,
              prompt_len=256, max_new=16, prefill_chunk=128, block_size=16,
              seed=0)
    rows = launch.run_family_rows(archs, **kw)
    # hymba's row again in float32: does the chunked stream part from the
    # static monolithic one without bf16 rounding?
    rows += launch.run_family_rows(("hymba-1.5b",), dtype="float32", **kw)
    for arch, row in zip(archs + ("hymba-1.5b",), rows):
        cfg = get_config(arch)
        name = f"{arch} family row" + (" f32" if row.get("dtype")
                                       == "float32" else "")
        require("skipped" not in row, f"{name}: skipped")
        require(row["n"] == 6.0, f"{name}: {row['n']} of 6")
        require_path_launches(row["kernels"], cfg, name)
        out["launches"][name] = row["kernels"]
        out["serve"][name] = {k: row[k] for k in (
            "continuous_tok_s", "ttft_p50_s", "ttft_p95_s",
            "state_bytes_per_slot", "static_tok_identical",
            "static_equal_token_share", "prefill_chunk", "dtype")}
        print(f"family {row['family']} {row['dtype']}: "
              f"{row['continuous_tok_s']:.2f} "
              f"tok/s, TTFT p50 {1e3 * row['ttft_p50_s']:.2f} ms p95 "
              f"{1e3 * row['ttft_p95_s']:.2f} ms, chunk "
              f"{row['prefill_chunk']}, state_bytes_per_slot "
              f"{row['state_bytes_per_slot']}, static_tok_identical "
              f"{row['static_tok_identical']} (equal share "
              f"{row['static_equal_token_share']:.4f})", flush=True)
        print(f"family {row['family']} {row['dtype']} kernels: "
              + json.dumps(row["kernels"]), flush=True)
        torch.cuda.empty_cache()
    return out


def phase_families(dev):
    """Phase 8: (a) the scan kernel, (b) both models, (c)/(d) serving."""
    timer = Timer(dev)
    row = phase_ssd(dev, timer)
    del timer
    torch.cuda.empty_cache()
    models = {arch: phase_family_model(dev, arch)
              for arch in ("mamba2-370m", "hymba-1.5b")}
    serve = phase_family_serve()
    row["launches"] = sum(c["ssd_launches"]
                          for c in serve["launches"].values())
    row["launches_by_run"] = {k: c["ssd_launches"]
                              for k, c in serve["launches"].items()}
    print("families: " + json.dumps({"models": models,
                                     "serve": serve["serve"]}), flush=True)
    return row, serve["launches"]


# ---------------------------------------------------------------------------
# phase 9: speculative decoding, prefix caching, ring-buffer caches
# ---------------------------------------------------------------------------
# phase 10: the model families — dense (qwen3, yi, qwen2.5), the patch_stub
# VLM (internvl2), MoE (olmoe, dbrx), encoder-decoder (whisper)
# ---------------------------------------------------------------------------

#: the paged kernels at hd 128, (label, H, Hkv): qwen3-14b and qwen2.5-14b
#: (GQA 40/8), yi-9b (32/4), olmoe-1b-7b (MHA 16/16), dbrx-132b (48/8)
FAMILY_PAGED_HEADS = (("qwen3", 40, 8), ("yi", 32, 4), ("olmoe", 16, 16),
                      ("dbrx", 48, 8))
#: the flash kernel at the families' shapes, (label, B, H, Hkv, Sq, Sk,
#: hd, causal): a static batch of qwen3 (B=8, S=256) and of internvl2
#: (256 patch tokens + 128 text), whisper-tiny's encoder (non-causal, Sq =
#: Sk = 1500: 46 full 32-key stages and a tail of 28) and its
#: cross-attention at a decode step (Sq = 1, 8 rows) and at a chunk (Sq =
#: 64, 2 rows) against the 1500 encoder positions
FAMILY_FLASH_CASES = [
    ("qwen3 static B=8 S=256", 8, 40, 8, 256, 256, 128, True),
    ("internvl2 B=2 S=256+128", 2, 64, 8, 384, 384, 128, True),
    ("whisper encoder B=2", 2, 6, 6, 1500, 1500, 64, False),
    ("whisper cross Sq=1 B=8", 8, 6, 6, 1, 1500, 64, False),
    ("whisper cross Sq=64 B=2", 2, 6, 6, 64, 1500, 64, False),
]
#: phase 10's run_traffic trace (every arm): short and long prompts,
#: 6 requests over 4 slots
FAMILY_TRAFFIC = dict(requests=6, slots=4, prompt_len=(16, 128),
                      max_new=(4, 12), rate=50.0, engine="both",
                      prefill_chunk=64, max_prefill_per_step=2,
                      block_size=16, prefix_compare=False,
                      spec_compare=False, seed=0)
#: the identity flags of a run_traffic result, by the arms they compare
IDENTITY_FLAGS = ("static_token_identical_trace",
                  "monolithic_token_identical_trace",
                  "paged_token_identical_trace", "parity_token_identical",
                  "parity_token_identical_paged")
#: depth cuts: the whole model does not fit one 80 GB card (bf16 weights:
#: internvl2-76b ~1.7 GB a layer, dbrx-132b ~6.5 GB a layer)
DEPTH_CUTS = {"internvl2-76b": 20, "dbrx-132b": 8}


def family_paged_kernels(dev, timer, table):
    """10(a), paged: both kernels at hd 128 and each family's heads, at the
    serving runs' widths (8 decode rows, one parked, 17-entry tables:
    cache_len 272 / bs 16; chunks of 2 rows x 64 at pos0 0 and 192),
    against the plain version, twice bit for bit; bf16 timed."""
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    for dtype in (torch.float32, torch.bfloat16):
        for tag, H, Hkv in FAMILY_PAGED_HEADS:
            for kernel, kw_case in (
                    ("paged_decode", dict(B=8, K=0, NB=17, parked=(2,),
                                          lengths=[17, 40, 100, 129, 140,
                                                   200, 250, 271])),
                    ("paged_mq", dict(B=2, K=64, NB=17,
                                      lengths=[64, 256]))):
                label = f"{tag} hd128 " + ("decode" if kernel ==
                                           "paged_decode" else "chunk")
                case = make_case(dev, dtype, H=H, Hkv=Hkv, hd=128, bs=16,
                                 seed=H + Hkv + kw_case["K"], **kw_case)
                args = [case[k] for k in ("q", "k_pages", "v_pages",
                                          "block_tables", "lengths")]
                key = {"paged_decode": "decode_launches",
                       "paged_mq": "mq_launches"}[kernel]
                before = ops.counters()[key]
                out = ops.paged_attention(*args)
                again = ops.paged_attention(*args)
                require(ops.counters()[key] == before + 2,
                        f"{label}: {kernel} was not launched")
                ref = paged_attention_ref(*args)
                torch.cuda.synchronize()
                live = case["live"]
                require(bool(torch.isfinite(out[live].float()).all()),
                        f"{kernel} {label} {dtype}: non-finite output")
                require(torch.equal(out, again),
                        f"{kernel} {label} {dtype}: two launches differ")
                err = (out[live].float() - ref[live].float()).abs()
                tol = TOL[dtype]
                bad = err > tol + tol * ref[live].float().abs()
                max_err = float(err.max())
                print(f"check {kernel:12s} {label:20s} {str(dtype):14s} "
                      f"max_abs_err={max_err:.3e} tol={tol:g} "
                      f"{'ok' if not bad.any() else 'MISMATCH'}, "
                      "deterministic", flush=True)
                require(not bool(bad.any()),
                        f"{kernel} {label} {dtype}: disagrees with ref.py")
                row = table[kernel]
                row["max_abs_err"] = max(row["max_abs_err"], max_err)
                if dtype != torch.bfloat16:
                    continue
                nbytes, flops = needs(case)
                t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
                t_ops = 1e3 * flops / PEAK_FLOPS[dtype]
                lib = library_call(case)
                t = dict(shape=label, dtype="bfloat16",
                         ms=timer.ms(lambda: ops.paged_attention(*args)),
                         plain_ms=timer.ms(
                             lambda: paged_attention_ref(*args)),
                         bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations",
                         bound_bytes=nbytes, bound_flops=flops,
                         library_ms=timer.ms(lib))
                t["bound_share"] = t["bound_ms"] / t["ms"]
                row.setdefault("family_times", []).append(t)
                print(f"time  {kernel:12s} {label:20s} bf16 "
                      f"ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
                      f"library_ms={t['library_ms']:.4f} "
                      f"bound_ms={t['bound_ms']:.5f} ({t['bound_by']}: "
                      f"{nbytes} bytes, {flops} flops), bound share "
                      f"{t['bound_share']:.4f}", flush=True)


def family_flash_kernel(dev, timer, row):
    """10(a), flash: causal at hd 128 (qwen3, internvl2) and non-causal at
    whisper's encoder and cross-attention, against the plain version,
    twice bit for bit; bf16 timed beside SDPA on the same data."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    for dtype in (torch.float32, torch.bfloat16):
        for label, B, H, Hkv, Sq, Sk, hd, causal in FAMILY_FLASH_CASES:
            g = torch.Generator().manual_seed(Sq + Sk + B + H)
            q = torch.randn(B, Sq, H, hd, generator=g).to(dev, dtype)
            k = torch.randn(B, Sk, Hkv, hd, generator=g).to(dev, dtype)
            v = torch.randn(B, Sk, Hkv, hd, generator=g).to(dev, dtype)
            before = flash_ops.flash_launches
            out = flash_ops.flash_attention(q, k, v, causal=causal)
            again = flash_ops.flash_attention(q, k, v, causal=causal)
            require(flash_ops.flash_launches == before + 2,
                    f"flash {label}: the kernel was not launched")
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            ref = flash_attention_ref(qt, kt, vt,
                                      causal=causal).transpose(1, 2)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(out.float()).all()),
                    f"flash {label} {dtype}: non-finite output")
            err = (out.float() - ref.float()).abs()
            tol = FLASH_TOL[dtype]
            bad = err > tol + tol * ref.float().abs()
            max_err = float(err.max())
            same = torch.equal(out, again)
            print(f"check flash_attention {label:24s} {str(dtype):14s} "
                  f"causal={causal} max_abs_err={max_err:.3e} tol={tol:g} "
                  f"{'ok' if not bad.any() else 'MISMATCH'}, two launches "
                  f"bitwise {same}", flush=True)
            require(not bool(bad.any()),
                    f"flash {label} {dtype}: disagrees with ref.py")
            require(same, f"flash {label} {dtype}: two launches differ")
            row["max_abs_err"] = max(row["max_abs_err"], max_err)
            if dtype != torch.bfloat16:
                continue
            nbytes, flops = flash_needs(B, H, Hkv, Sq, Sk, hd, 0, 0,
                                        q.element_size(), causal)
            t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
            t_ops = 1e3 * flops / PEAK_FLOPS[dtype]
            rep = H // Hkv
            qs = qt.contiguous()
            ks = kt.repeat_interleave(rep, dim=1).contiguous()
            vs = vt.repeat_interleave(rep, dim=1).contiguous()
            splits = flash_ops.splits_for(B, H, Hkv, Sq, Sk, causal=causal,
                                          q_offset=0,
                                          sms=flash_ops.sm_count(dev))
            t = dict(shape=label, dtype="bfloat16", causal=causal,
                     splits=splits,
                     ms=timer.ms(lambda: flash_ops.flash_attention(
                         q, k, v, causal=causal)),
                     plain_ms=timer.ms(lambda: flash_attention_ref(
                         qt, kt, vt, causal=causal)),
                     bound_ms=max(t_bytes, t_ops),
                     bound_by="bytes" if t_bytes >= t_ops else "operations",
                     bound_bytes=nbytes, bound_flops=flops,
                     library_ms=timer.ms(
                         lambda: F.scaled_dot_product_attention(
                             qs, ks, vs, is_causal=causal)))
            t["bound_share"] = t["bound_ms"] / t["ms"]
            row.setdefault("family_times", []).append(t)
            print(f"time  flash_attention {label:24s} bf16 "
                  f"splits={splits} "
                  f"ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
                  f"library_ms={t['library_ms']:.4f} "
                  f"bound_ms={t['bound_ms']:.5f} ({t['bound_by']}: "
                  f"{nbytes} bytes, {flops} flops), bound share "
                  f"{t['bound_share']:.4f}", flush=True)


def free_cuda():
    # between phases: a phase's tensors go by reference counting when it
    # returns (the port's paths leave no cycle, as the lifetime tests
    # hold); the collection drops what torch's own tools (the profiler,
    # FlopCounterMode) may leave in cycles. No reading inside a phase
    # needs it.
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


@contextlib.contextmanager
def collector_off():
    """The cyclic garbage collector disabled: what a step leaves
    allocated is then what it holds by reference."""
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def build_family(arch, dev, dtype="bfloat16", layers=None):
    """``arch`` at its published widths (``layers``: a depth cut), weights
    from seed 0, and its size."""
    from repro_torch.config import ServeConfig
    from repro_torch.launch.serve import arch_config
    from repro_torch.models.registry import build_model

    cfg = arch_config(arch, layers=layers)
    t0 = time.perf_counter()
    model = build_model(cfg, ServeConfig(param_dtype=dtype,
                                         compute_dtype=dtype), device=dev)
    params = model.init(0)
    torch.cuda.synchronize()
    print(f"model {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads}x{cfg.head_dim} heads (kv "
          f"{cfg.num_kv_heads}), d_ff {cfg.d_ff}"
          + (f", {cfg.num_experts} experts top-{cfg.top_k}"
             if cfg.num_experts else "")
          + f", vocab {cfg.vocab_size}, {cfg.param_count() / 1e9:.3f} B "
          f"params, {dtype}, built in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated(dev)} bytes allocated", flush=True)
    return model, params


def rounded_p(s, v, out_dtype):
    """Softmax of masked scores ``s`` (..., T) float32 against ``v``
    (..., T, hd) float32, with p rounded to ``out_dtype`` before p.v and
    l summed over the unrounded p: the kernels' one rounding, in the plain
    arithmetic."""
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    den = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    return torch.matmul(p.to(out_dtype).float(), v) / den


def floor_paged(q, k_pages, v_pages, block_tables, lengths, *, window=0,
                softcap=0.0):
    """The noise-floor path of the paged attention: the plain version
    with p rounded before p.v (:func:`rounded_p`)."""
    multi = q.dim() == 4
    q4 = q if multi else q[:, None]
    B, K, H, hd = q4.shape
    _, bs, Hkv, _ = k_pages.shape
    tables = block_tables.long()
    NB = tables.shape[1]
    flat = tables.clamp(min=0).reshape(-1)
    kg = k_pages[flat].reshape(B, NB * bs, Hkv, hd).float()
    vg = v_pages[flat].reshape(B, NB * bs, Hkv, hd).float()
    kg = kg.repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
    vg = vg.repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
    s = torch.matmul(q4.float().transpose(1, 2), kg.transpose(-1, -2))
    s = s / math.sqrt(hd)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    dev = q.device
    tok = torch.arange(NB * bs, device=dev)[None, None, :]
    qpos = (lengths.long()[:, None] - K
            + torch.arange(K, device=dev)[None, :])[:, :, None]
    ok = (tok <= qpos) & tables.ge(0).repeat_interleave(bs, 1)[:, None, :]
    if window > 0:
        ok = ok & (tok > qpos - window)
    s = torch.where(ok[:, None], s, torch.full_like(s, -1e30))
    out = rounded_p(s, vg, q.dtype).transpose(1, 2).to(q.dtype)
    return out if multi else out[:, 0]


def floor_flash(q, k, v, *, causal=True, window=0, q_offset=0):
    """The noise-floor path of flash attention, in the models' (B, S, H,
    hd) layout: the plain version with p rounded before p.v."""
    B, Sq, H, hd = q.shape
    Hkv, Sk = k.shape[2], k.shape[1]
    kf = k.float().repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
    s = torch.matmul(q.float().transpose(1, 2), kf.transpose(-1, -2))
    s = s / math.sqrt(hd)
    dev = q.device
    qp = q_offset + torch.arange(Sq, device=dev)[:, None]
    kp = torch.arange(Sk, device=dev)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        ok = ok & (kp <= qp)
    if window > 0:
        ok = ok & (kp > qp - window)
    s = torch.where(ok, s, torch.full_like(s, -1e30))
    return rounded_p(s, vf, q.dtype).transpose(1, 2).to(q.dtype)


def held(label, fn, cache, plain, floor, cfg, bf16):
    """``fn(cache, **overrides)`` -> logits, through the kernels (on
    ``cache``) and through the plain versions (on a copy taken before).
    float32: within MODEL_F32_REL_TOL. bfloat16: within the larger of
    MODEL_REL_TOL and NOISE_FLOOR_FACTOR x the step's noise floor (the
    same step through the plain versions with p rounded before p.v, the
    kernels' one rounding) — a MoE model's routing turns a bf16 ulp into
    a different expert, so its floor sits far above a dense model's."""
    def clone(c):
        return None if c is None else {k: v.clone() for k, v in c.items()}

    copies = [clone(cache), clone(cache) if bf16 else None]
    out = fn(cache)
    ref = fn(copies[0], **plain)
    if not bf16:
        return out, compare(label, out, ref, cfg, tol=MODEL_F32_REL_TOL)
    fl = fn(copies[1], **floor)
    f = rel_diff(fl, ref, cfg)
    return out, compare(label, out, ref, cfg,
                        tol=max(MODEL_REL_TOL, NOISE_FLOOR_FACTOR * f),
                        floor=f, floor_agree=argmax_agree(fl, ref, cfg))


def decoder_only_checks(model, params, dev, label):
    """10(b) for a decoder-only config: three paged chunks of 4 rows x 64
    (the last partial), then a decode step, each through the kernels vs
    the plain attention (:func:`held`); a monolithic prefill (B=4, S=256)
    through the flash kernel vs its plain version; in bfloat16 the decode
    step timed and profiled."""
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    cfg = model.cfg
    bf16 = model.dtype == torch.bfloat16
    tag = f"{label} {str(model.dtype).split('.')[-1]}"
    B, C, bs, NB = 4, 64, 16, 16
    rng = np.random.default_rng(0)
    tables = torch.from_numpy(
        rng.permutation(B * NB).astype(np.int32).reshape(B, NB)).to(dev)
    pool = model.init_paged_cache(B * NB, bs)
    prompts = rng.integers(0, cfg.vocab_size, size=(B, 3 * C))
    n_last = np.array([C, C, C, 40])
    plain = {"attention": paged_attention_ref}
    floor = {"attention": floor_paged}

    def chunk(pool, off, n_valid, **kw):
        tok = np.zeros((B, C), np.int64)
        for b in range(B):
            tok[b, :n_valid[b]] = prompts[b, off:off + n_valid[b]]
        return model.prefill_chunk_paged(
            params, pool, torch.from_numpy(tok).to(dev), tables,
            torch.arange(B), torch.full((B,), off, device=dev),
            torch.from_numpy(n_valid).to(dev), **kw)

    for off in (0, C):
        chunk(pool, off, np.full(B, C))
    res = {}
    logits, res["chunk"] = held(
        f"{tag} prefill chunk (pos0=128)",
        lambda c, **kw: chunk(c, 2 * C, n_last, **kw), pool, plain, floor,
        cfg, bf16)
    tokens = logits.argmax(-1, keepdim=True)
    positions = torch.from_numpy(2 * C + n_last).to(dev)

    def decode(c, **kw):
        return model.decode_step_paged(params, c, tokens, positions, tables,
                                       **kw)

    _, res["decode"] = held(f"{tag} decode step (pos 192/168)", decode,
                            pool, plain, floor, cfg, bf16)
    if bf16:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        for _ in range(2):
            ev[0].record()
            decode(pool)
            ev[1].record()
        torch.cuda.synchronize()
        res["decode_step_ms"] = ev[0].elapsed_time(ev[1])
        res["decode_profile"] = profile_step(
            f"{label} paged decode (B=4)", lambda: decode(pool),
            res["decode_step_ms"])
    del pool
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        size=(4, 256))).to(dev)
    _, res["prefill"] = held(
        f"{tag} monolithic prefill (B=4, S=256)",
        lambda c, **kw: model.prefill(params, tok, 272, **kw)[0], None,
        {"attention": plain_flash}, {"attention": floor_flash}, cfg, bf16)
    return res


def whisper_checks(model, params, dev):
    """10(b) for whisper-tiny: the static prefill (B=4, 64 prompt tokens,
    1500 frames) through the flash kernel (encoder and cross-attention
    non-causal, decoder causal) vs its plain version; then on a paged pool
    of 4 rows: the encoder pre-chunk, a decoder chunk (the last row
    partial) and a decode step, kernels vs plain versions
    (:func:`held`)."""
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.launch.serve import frontend_arrays

    cfg = model.cfg
    bf16 = model.dtype == torch.bfloat16
    tag = f"whisper-tiny {str(model.dtype).split('.')[-1]}"
    B, C, bs, NB = 4, 64, 16, 8
    rng = np.random.default_rng(2)
    frames = torch.from_numpy(frontend_arrays(cfg, B, 2)["frames"]).to(dev)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        size=(B, C))).to(dev)
    res = {}
    _, res["prefill"] = held(
        f"{tag} static prefill (B=4, S=64)",
        lambda c, **kw: model.prefill(params, tok, 2 * C, frames=frames,
                                      **kw)[0], None,
        {"attention": plain_flash}, {"attention": floor_flash}, cfg, bf16)
    tables = torch.from_numpy(
        rng.permutation(B * NB).astype(np.int32).reshape(B, NB)).to(dev)
    pool = model.init_paged_cache(B * NB, bs, num_rows=B)
    n_valid = torch.tensor([C, C, C, 40], device=dev)
    args = (tok, tables, torch.arange(B), torch.zeros(B, dtype=torch.long,
                                                      device=dev), n_valid)
    plain = dict(attention=paged_attention_ref, cross_attention=plain_flash)
    floor = dict(attention=floor_paged, cross_attention=floor_flash)

    def prechunk_and_chunk(c, attention=None, cross_attention=None):
        kw = {} if attention is None else dict(
            attention=attention, cross_attention=cross_attention)
        model.encode_prechunk(params, c, frames, list(range(B)),
                              **({} if cross_attention is None else
                                 {"attention": cross_attention}))
        return model.prefill_chunk_paged(params, c, *args, **kw)

    out, res["chunk"] = held(f"{tag} pre-chunk + decoder chunk",
                             prechunk_and_chunk, pool, plain, floor, cfg,
                             bf16)
    nxt = out.argmax(-1, keepdim=True)
    positions = n_valid.clone()
    _, res["decode"] = held(
        f"{tag} paged decode step",
        lambda c, **kw: model.decode_step_paged(params, c, nxt, positions,
                                                tables, **kw),
        pool, plain, floor, cfg, bf16)
    return res


def family_launch_check(counts, cfg, label):
    """Every attention call of a run on the card was a kernel launch:
    the flash kernel exactly as often as the run's forwards imply, the
    paged kernels where the run paged, no plain version."""
    L = cfg.num_layers
    if cfg.is_encoder_decoder:
        want = (cfg.num_encoder_layers * counts["encode_calls"]
                + L * (2 * counts["prefill_calls"] + counts["chunk_calls"]
                       + counts["cross_decode_calls"]))
        what = (f"{counts['encode_calls']} encoder passes x "
                f"{cfg.num_encoder_layers} layers + ({counts['prefill_calls']}"
                f" static prefills x 2 + {counts['chunk_calls']} chunks + "
                f"{counts['cross_decode_calls']} decode forwards) x {L} "
                "layers")
    elif cfg.uses_attention:
        want = L * counts["prefill_calls"]
        what = f"{counts['prefill_calls']} prefills x {L} layers"
    else:
        want, what = 0, "an attention-free model"
    require(counts["flash_launches"] == want,
            f"{label}: flash launched {counts['flash_launches']} times for "
            + what)
    if counts["chunk_calls"] and cfg.uses_attention:
        require(counts["mq_launches"] > 0 and counts["decode_launches"] > 0,
                f"{label}: a paged-attention kernel never launched")
    require(counts["ref_calls"] == counts["flash_ref_calls"]
            == counts["ssd_ref_calls"] == counts["moe_ref_calls"] == 0,
            f"{label}: a plain version ran on the card")
    if cfg.block == "moe":
        require(counts["moe_launches"] > 0,
                f"{label}: the top-k expert kernels never launched")
    if cfg.block in ("ssm", "hybrid"):
        require(counts["ssd_launches"] == L * (counts["chunk_calls"]
                                               + counts["prefill_calls"]),
                f"{label}: ssd_scan launches {counts['ssd_launches']}")


def family_traffic(arch, dtype, params=None, layers=None, **kw):
    """run_traffic on ``arch`` (every arm its capabilities allow), its
    launches checked; float32 runs must be token-identical across arms,
    bfloat16 ones print their equal-token shares."""
    from repro_torch.launch import serve as launch

    free_cuda()
    t0 = time.perf_counter()
    args = dict(FAMILY_TRAFFIC, **kw)
    res = launch.run_traffic(arch, smoke=False, device="cuda", dtype=dtype,
                             params=params, layers=layers, **args)
    cfg = launch.arch_config(arch, layers=layers)
    counts = res["kernels"]
    family_launch_check(counts, cfg, f"{arch} {dtype} run_traffic")
    n = float(args["requests"])
    arms = [a for a in ("static", "continuous", "continuous_monolithic",
                        "continuous_paged") if a in res]
    for arm in arms:
        stats = res[arm]
        require(stats.get("n") == n, f"{arch} {arm}: {stats.get('n')} of "
                f"{n} requests finished")
        outs = res["outputs_by_arm"][arm]
        require(all(len(t) > 0 and all(0 <= x < cfg.vocab_size for x in t)
                    for t in outs),
                f"{arch} {arm}: a request produced no token or one out of "
                "vocab")
    flags = {k: res[k] for k in IDENTITY_FLAGS if k in res}
    shares = {k: res[k] for k in res if k.endswith("equal_token_share")}
    if dtype == "float32":
        require(all(flags.values()),
                f"{arch} float32: arms part: {json.dumps(flags)}")
    secs = time.perf_counter() - t0
    out = {"arms": arms, "flags": flags, "shares": shares, "kernels": counts,
           "max_memory_allocated": res.get("max_memory_allocated"),
           "seconds": secs, "layers": cfg.num_layers,
           "tok_s": {a: res[a]["tok_s"] for a in arms},
           "ttft_p95_ms": {a: 1e3 * res[a]["ttft_p95_s"] for a in arms
                           if "ttft_p95_s" in res[a]}}
    print(f"traffic {arch} {dtype} ({cfg.num_layers} layers): arms "
          f"{arms}, tok/s {json.dumps(out['tok_s'])}, flags "
          f"{json.dumps(flags)}, shares {json.dumps(shares)}, "
          f"max_memory_allocated {out['max_memory_allocated']} bytes, "
          f"{secs:.1f} s", flush=True)
    print(f"traffic {arch} {dtype} kernels: " + json.dumps(counts),
          flush=True)
    return out


def family_serve(arch, layers=None, **kw):
    """run_serve (the paged engine) on ``arch``, launches checked."""
    from repro_torch.launch import serve as launch

    free_cuda()
    t0 = time.perf_counter()
    args = dict(requests=8, slots=8, prompt_len=(16, 256), max_new=(4, 16),
                rate=50.0, prefill_chunk=64, max_prefill_per_step=2,
                block_size=16, seed=0)
    args.update(kw)
    res = launch.run_serve(arch, device="cuda", layers=layers, **args)
    cfg = launch.arch_config(arch, layers=layers)
    stats = res["continuous"]
    require(stats.get("n") == float(args["requests"]),
            f"{arch} run_serve: served {stats.get('n')}")
    for rid, toks in enumerate(res["outputs"]):
        require(len(toks) > 0 and all(0 <= t < cfg.vocab_size
                                      for t in toks),
                f"{arch} request {rid}: no token or out of vocab")
    family_launch_check(res["kernels"], cfg, f"{arch} run_serve")
    secs = time.perf_counter() - t0
    out = {"layers": cfg.num_layers, "tok_s": res["continuous_tok_s"],
           "ttft_p50_ms": res["ttft_p50_ms"],
           "ttft_p95_ms": res["ttft_p95_ms"],
           "max_memory_allocated": res.get("max_memory_allocated"),
           "kernels": res["kernels"], "seconds": secs}
    print(f"serve {arch} ({cfg.num_layers} layers): "
          f"{args['requests']} requests, {stats['useful_tokens']:.0f} tokens "
          f"in {stats['makespan_s']:.3f} s: {out['tok_s']:.2f} tok/s, TTFT "
          f"p50 {out['ttft_p50_ms']:.2f} ms p95 {out['ttft_p95_ms']:.2f} ms, "
          f"max_memory_allocated {out['max_memory_allocated']} bytes, "
          f"{secs:.1f} s", flush=True)
    print(f"serve {arch} kernels: " + json.dumps(res["kernels"]),
          flush=True)
    return out


def family_rows():
    """run_family_rows over the five families (dense, MoE, SSM, hybrid,
    enc-dec) at full width in bfloat16: no row skipped, every request
    served, launches checked."""
    from repro_torch.launch import serve as launch

    free_cuda()
    rows = launch.run_family_rows(smoke=False, device="cuda", requests=6,
                                  slots=4, prompt_len=256, max_new=8,
                                  prefill_chunk=128, block_size=16, seed=0)
    out = {}
    require([r["family"] for r in rows] == list(launch.FAMILY_ARCHS),
            "run_family_rows: the rows are not the five families")
    for arch, row in zip(launch.FAMILY_ARCHS, rows):
        require("skipped" not in row, f"{arch} family row: skipped")
        require(row["n"] == 6.0, f"{arch} family row: {row['n']} of 6")
        family_launch_check(row["kernels"], launch.arch_config(arch),
                            f"{arch} family row")
        out[arch] = {k: row[k] for k in (
            "continuous_tok_s", "ttft_p50_s", "ttft_p95_s", "prefill_chunk",
            "state_bytes_per_slot", "static_tok_identical",
            "static_equal_token_share")}
        out[arch]["kernels"] = row["kernels"]
        print(f"family row {arch}: {row['continuous_tok_s']:.2f} tok/s, "
              f"chunk {row['prefill_chunk']}, state_bytes_per_slot "
              f"{row['state_bytes_per_slot']}, static_tok_identical "
              f"{row['static_tok_identical']} (equal share "
              f"{row['static_equal_token_share']:.4f}); kernels "
              + json.dumps(row["kernels"]), flush=True)
    return out


def phase_model_families(dev):
    """Phase 10: (a) the attention kernels at the families' shapes, (b)
    qwen3-14b, olmoe-1b-7b and whisper-tiny at full width, kernel path vs
    plain path, (c) serving every remaining config. Returns the kernel
    rows' additions and the phase's record."""
    t_phase = time.perf_counter()
    timer = Timer(dev)
    table = {k: {"max_abs_err": 0.0} for k in ("paged_decode", "paged_mq",
                                               "flash_attention")}
    family_paged_kernels(dev, timer, table)
    family_flash_kernel(dev, timer, table["flash_attention"])
    del timer
    record = {"models": {}, "traffic": {}, "serve": {}}
    for arch in ("qwen3-14b", "olmoe-1b-7b", "whisper-tiny"):
        for dtype in ("bfloat16", "float32"):
            free_cuda()
            model, params = build_family(arch, dev, dtype)
            key = f"{arch} {dtype}"
            if arch == "whisper-tiny":
                record["models"][key] = whisper_checks(model, params, dev)
            else:
                record["models"][key] = decoder_only_checks(model, params,
                                                            dev, arch)
            del model
            record["traffic"][key] = family_traffic(arch, dtype,
                                                    params=params)
            del params
    record["family_rows"] = family_rows()
    for arch in ("yi-9b", "qwen2.5-14b"):
        record["serve"][arch] = family_serve(arch)
    record["traffic"]["internvl2-76b bfloat16"] = family_traffic(
        "internvl2-76b", "bfloat16", layers=DEPTH_CUTS["internvl2-76b"],
        requests=4, slots=2, prompt_len=(16, 64), max_new=(4, 8))
    record["serve"]["dbrx-132b"] = family_serve(
        "dbrx-132b", layers=DEPTH_CUTS["dbrx-132b"], requests=6, slots=4,
        prompt_len=(16, 128), max_new=(4, 12))
    free_cuda()
    runs = [r["kernels"] for r in record["traffic"].values()]
    runs += [r["kernels"] for r in record["serve"].values()]
    runs += [r["kernels"] for r in record["family_rows"].values()]
    for name, key in (("paged_decode", "decode_launches"),
                      ("paged_mq", "mq_launches"),
                      ("flash_attention", "flash_launches")):
        table[name]["launches_families"] = sum(c[key] for c in runs)
    record["seconds"] = time.perf_counter() - t_phase
    print(f"model families: {record['seconds']:.1f} s", flush=True)
    print("model families: " + json.dumps(record), flush=True)
    return table, record


# ---------------------------------------------------------------------------

#: (tag, H, Hkv, hd, window, NB, positions): gemma-2b's and hymba-1.5b's
#: heads at the verify (K = k + 1 = 4) and resync (K = 2) shapes; row 2
#: is parked, row 5 of gemma's reaches past the table's width
VERIFY_SHAPES = [
    ("gemma", 8, 1, 256, 0, 32, [17, 100, PARK_POS, 255, 300, 510, 0, 200]),
    ("hymba", 25, 5, 64, HYMBA_WINDOW, 164,
     [17, 100, PARK_POS, 2047, 2100, 2600, 0, 2300]),
]
#: draft tokens a round of phase 9(b)'s speculative arm
SPEC_K = 3
#: phase 9(c)'s prompt length: past hymba-1.5b's window
RING_PROMPT = 2600
#: requests of phase 9's traces: the depth of its repeated runs, cut
#: (from 12 and 4 in its first run) to keep the whole script within
#: about 1.5x of its time before phase 9; the widths are untouched
SPEC_PREFIX_REQUESTS = 8
RING_REQUESTS = 2


def verify_case(dev, dtype, H, Hkv, hd, NB, positions, K, bs=16, seed=0):
    """A verify or resync batch on the card: row b's queries at
    ``positions[b] + j`` (``lengths = positions + K``); each row leases
    only the tokens its valid queries write (``n_valid`` K, 1, .., so its
    padding queries reach past the lease into -1 entries), the parked row
    keeps a lease and walks none of it. ``live``: the rows whose every
    query sees a token."""
    rng = np.random.default_rng(seed + K)
    B = len(positions)
    pos = np.asarray(positions, np.int64)
    n_valid = np.array([K, 1, 0, K, min(2, K), 2, 1, K - 1])
    leases = [0 if p < 0 else min(NB, -(-(p + n) // bs))
              for p, n in zip(pos, n_valid)]
    P = sum(leases) + 8
    perm = rng.permutation(P)
    tables = np.full((B, NB), -1, np.int32)
    used = 0
    for b, n in enumerate(leases):
        tables[b, :n] = perm[used:used + n]
        used += n
    tables[2, :3] = perm[used:used + 3]          # the parked row's lease
    kp = torch.from_numpy(rng.standard_normal((P, bs, Hkv, hd),
                                              dtype=np.float32))
    vp = torch.from_numpy(rng.standard_normal((P, bs, Hkv, hd),
                                              dtype=np.float32))
    q = torch.from_numpy(rng.standard_normal((B, K, H, hd),
                                             dtype=np.float32))
    return dict(q=q.to(dev, dtype), k_pages=kp.to(dev, dtype),
                v_pages=vp.to(dev, dtype),
                block_tables=torch.from_numpy(tables).to(dev),
                lengths=torch.from_numpy((pos + K).astype(np.int32)).to(dev),
                live=[b for b in range(B) if pos[b] >= 0])


def phase_verify_kernels(dev, timer):
    """9(a): ``paged_mq`` at the verify and resync shapes against the
    plain version and the split emulation, twice bitwise; bf16 timed
    against its bound and SDPA on the same gathered K/V."""
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_ref, paged_attention_split_ref)

    worst, times = 0.0, []
    for dtype in (torch.float32, torch.bfloat16):
        for tag, H, Hkv, hd, window, NB, positions in VERIFY_SHAPES:
            for K in (2, SPEC_K + 1):
                label = f"{tag} {'resync' if K == 2 else 'verify'} K={K}"
                case = verify_case(dev, dtype, H, Hkv, hd, NB, positions, K)
                args = [case[k] for k in ("q", "k_pages", "v_pages",
                                          "block_tables", "lengths")]
                before = ops.mq_launches
                out = ops.launch(*args, window=window)
                again = ops.launch(*args, window=window)
                require(ops.mq_launches == before + 2,
                        f"{label}: paged_mq was not launched")
                pl = ops.plan(len(positions), K, H, Hkv, 16, NB)
                ref = paged_attention_ref(*args, window=window)
                split = paged_attention_split_ref(
                    *args, plan=pl, tile_tokens=ops.TILE_TOKENS,
                    window=window)
                torch.cuda.synchronize()
                live = case["live"]
                require(bool(torch.isfinite(out.float()).all()),
                        f"{label} {dtype}: non-finite output")
                require(torch.equal(out, again),
                        f"{label} {dtype}: two launches differ")
                tol = TOL[dtype]
                errs = []
                for name, want in (("ref", ref), ("split_ref", split)):
                    err = (out[live].float() - want[live].float()).abs()
                    bad = err > tol + tol * want[live].float().abs()
                    errs.append(float(err.max()))
                    require(not bool(bad.any()),
                            f"{label} {dtype}: disagrees with {name}")
                parked = [b for b in range(len(positions)) if b not in live]
                parked_zero = bool((out[parked] == 0).all())
                require(parked_zero, f"{label} {dtype}: the row parked at "
                        "PARK_POS has a nonzero output")
                worst = max(worst, errs[0])
                print(f"check paged_mq {label:18s} {str(dtype):14s} "
                      f"max_abs_err vs ref {errs[0]:.3e}, vs split_ref "
                      f"{errs[1]:.3e} (tol {tol:g}), deterministic, parked "
                      f"row zeros {parked_zero}, {pl.splits} splits x "
                      f"{pl.row_tiles} row tiles x {pl.warps} warps",
                      flush=True)
                if dtype != torch.bfloat16:
                    continue
                nbytes, flops = needs(case, window)
                t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
                t_ops = 1e3 * flops / PEAK_FLOPS[dtype]
                lib = library_call(case, window)
                t = dict(shape=label, dtype="bfloat16", plan=pl._asdict(),
                         ms=timer.ms(lambda: ops.paged_attention(
                             *args, window=window)),
                         plain_ms=timer.ms(lambda: paged_attention_ref(
                             *args, window=window)),
                         bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations",
                         bound_bytes=nbytes, bound_flops=flops,
                         library_ms=timer.ms(lib))
                t["bound_share"] = t["bound_ms"] / t["ms"]
                times.append(t)
                print(f"time  paged_mq {label:18s} bf16 ms={t['ms']:.4f} "
                      f"plain_ms={t['plain_ms']:.4f} "
                      f"library_ms={t['library_ms']:.4f} "
                      f"bound_ms={t['bound_ms']:.5f} ({t['bound_by']}: "
                      f"{nbytes} bytes, {flops} flops), bound share "
                      f"{t['bound_share']:.4f}", flush=True)
    return worst, times


def verify_model_check(model, params, cfg, dev, K=SPEC_K + 1):
    """A full-width verify step through the kernels against the same
    step through the plain attention: rows with 1..K valid queries and a
    parked row; the valid queries' logits compared as phase 4 compares
    its steps, both pools written alike, and the parked row's leased
    blocks left as they were in both."""
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    B, bs, NB = 5, 16, 24
    rng = np.random.default_rng(5)
    tables = torch.from_numpy(rng.permutation(B * NB).astype(
        np.int32).reshape(B, NB)).to(dev)
    pool = model.init_paged_cache(B * NB, bs)
    for t in pool.values():
        t.copy_(torch.randn(t.shape, device=dev, dtype=t.dtype))
    ref_pool = {k: v.clone() for k, v in pool.items()}
    parked = 2
    parked_blocks = tables[parked].long()
    parked_before = {k: v[:, parked_blocks].clone() for k, v in pool.items()}
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           size=(B, K))).to(dev)
    positions = torch.tensor([40, 200, PARK_POS, 367, 0], device=dev)
    n_valid = torch.tensor([K, 1, K, 2, K - 1], device=dev)
    out = model.verify_step_paged(params, pool, tokens, positions, tables,
                                  n_valid)
    ref = model.verify_step_paged(params, ref_pool, tokens, positions,
                                  tables, n_valid,
                                  attention=paged_attention_ref)
    valid = ((torch.arange(K, device=dev)[None] < n_valid[:, None])
             & (positions >= 0)[:, None])
    tol = MODEL_REL_TOL if model.dtype == torch.bfloat16 \
        else MODEL_F32_REL_TOL
    res = compare(f"{cfg.name} {str(model.dtype).split('.')[-1]} verify "
                  f"(K={K}, valid rows)", out[valid], ref[valid], cfg,
                  tol=tol)
    for k in pool:
        diff = float((pool[k].float() - ref_pool[k].float()).abs().max())
        require(diff <= tol * max(1.0, float(ref_pool[k].float().abs()
                                             .max())),
                f"verify pools differ in {k}: {diff}")
        for name, p in (("kernel", pool), ("plain", ref_pool)):
            require(torch.equal(p[k][:, parked_blocks], parked_before[k]),
                    f"verify ({name} path) wrote {k} into the blocks of "
                    "the row parked at PARK_POS")
    return res


def spec_prefix_run(dev, dtype):
    """9(b) in one dtype: gemma-2b at full width through ``run_traffic``
    with the speculative arm (k = 3, self-drafted) and the prefix
    comparison (baseline, cold, warm), with the verify step checked
    first."""
    from repro_torch.config import ServeConfig
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch
    from repro_torch.models.registry import build_model

    cfg = get_config("gemma-2b")
    model = build_model(cfg, ServeConfig(param_dtype=dtype,
                                         compute_dtype=dtype), device=dev)
    params = model.init(0)
    out = {"verify_step": verify_model_check(model, params, cfg, dev)}
    launch.reset_kernel_counters()
    res = launch.run_traffic(
        "gemma-2b", smoke=False, device=dev, dtype=dtype, params=params,
        engine="continuous", requests=SPEC_PREFIX_REQUESTS, slots=8,
        prompt_len=(16, 256),
        max_new=(4, 48), rate=50.0, chunk_compare=False, paged_compare=True,
        parity_check=False, prefill_chunk=64, max_prefill_per_step=2,
        block_size=16, spec_compare=True, speculate=SPEC_K,
        draft_arch="self", prefix_compare=True, seed=0)
    require(launch.kernel_counters() == res["kernels"], "counter mismatch")
    L = cfg.num_layers
    arms = {"paged": res["continuous_paged"], "spec": res["continuous_spec"],
            **{f"prefix_{n}": res["prefix"][n]
               for n in ("baseline", "cold", "warm")}}
    for name, stats in arms.items():
        c = stats["kernels"]
        require(stats.get("n") == SPEC_PREFIX_REQUESTS,
                f"{dtype} {name}: {stats.get('n')} of {SPEC_PREFIX_REQUESTS} "
                "requests finished")
        require(c["ref_calls"] == 0 and c["flash_launches"] == 0,
                f"{dtype} {name}: a plain version or flash ran")
        require(c["mq_launches"] == L * (c["chunk_calls"]
                                         + c["verify_calls"]),
                f"{dtype} {name}: {c['mq_launches']} paged_mq launches for "
                f"{c['chunk_calls']} chunk and {c['verify_calls']} verify "
                f"forwards x {L} layers")
        require(c["decode_launches"] > 0, f"{dtype} {name}: no decode")
    sp = res["continuous_spec"]
    c, rounds = sp["kernels"], int(sp["spec_rounds"])
    require(rounds > 0 and c["verify_calls"] == 2 * rounds,
            f"{dtype} spec: {c['verify_calls']} verify forwards for {rounds} "
            "rounds (one resync and one verify each)")
    require(c["decode_launches"] == L * (SPEC_K - 1) * rounds,
            f"{dtype} spec: {c['decode_launches']} paged_decode launches "
            f"for {rounds} rounds x {SPEC_K - 1} drafter steps x {L} layers")
    # the wrapper's launches by query width: K = 2 the drafter's resync,
    # K = k + 1 the target's verify (chunks are prefill_chunk wide)
    by_k = sp["mq_launches_by_k"]
    resync, verify = by_k.get(2, 0), by_k.get(SPEC_K + 1, 0)
    require(resync == verify == L * rounds,
            f"{dtype} spec: paged_mq launches by width {by_k}, want "
            f"{L * rounds} at K=2 and at K={SPEC_K + 1} ({rounds} rounds x "
            f"{L} layers)")
    require(res["spec_accepted_per_dispatch"] > 1.0,
            f"{dtype} spec: accepted per dispatch "
            f"{res['spec_accepted_per_dispatch']}")
    require(res["prefix_hit_rate"] > 0 and res["prefill_dispatches_saved"]
            > 0, f"{dtype} prefix: warm hit rate {res['prefix_hit_rate']}, "
            f"dispatches saved {res['prefill_dispatches_saved']}")
    if dtype == "float32":
        require(res["spec_token_identical_trace"],
                "float32 spec stream differs from the plain paged stream")
        require(res["prefix_token_identical"],
                "float32 prefix baseline, cold and warm streams differ")
    pfx = res["prefix"]
    out.update(
        dtype=dtype, spec_rounds=rounds,
        launches_verify=verify, launches_resync=resync,
        mq_launches_by_k=by_k,
        launches_draft=c["decode_launches"],
        spec_kernels=c,
        prefix_kernels={n: pfx[n]["kernels"] for n in
                        ("baseline", "cold", "warm")},
        max_memory_allocated=res.get("max_memory_allocated"),
        **{k: res[k] for k in (
            "spec_tok_s", "spec_accepted_per_dispatch",
            "spec_acceptance_rate", "spec_token_identical_trace",
            "spec_equal_token_share", "prefix_token_identical",
            "prefix_hit_rate", "prefill_tokens_saved",
            "prefill_dispatches_saved", "prefix_cold_equal_token_share",
            "prefix_warm_equal_token_share")},
        paged_tok_s=res["continuous_paged"]["tok_s"],
        shared_prefix_len=pfx["shared_prefix_len"],
        prefix_ttft={n: {k: pfx[n].get(k) for k in (
            "tok_s", "ttft_p50_s", "ttft_p95_s")}
            for n in ("baseline", "cold", "warm")},
        prefix_cow_clones=pfx["warm"].get("prefix_cow_clones"))
    print(f"spec {dtype}: k={SPEC_K} self-drafted, {res['spec_tok_s']:.2f} "
          f"tok/s vs plain paged {out['paged_tok_s']:.2f}, accepted per "
          f"dispatch {res['spec_accepted_per_dispatch']:.4f}, acceptance "
          f"{res['spec_acceptance_rate']:.4f}, {rounds} rounds, token "
          f"identical {res['spec_token_identical_trace']} (equal share "
          f"{res['spec_equal_token_share']:.4f}); launches verify "
          f"{verify} resync {resync} draft {c['decode_launches']} (paged_mq "
          f"by width {by_k})",
          flush=True)
    print(f"prefix {dtype}: shared prefix {pfx['shared_prefix_len']}, warm "
          f"hit rate {res['prefix_hit_rate']:.4f}, tokens saved "
          f"{res['prefill_tokens_saved']:.0f}, dispatches saved "
          f"{res['prefill_dispatches_saved']:.0f}, identical "
          f"{res['prefix_token_identical']} (cold share "
          f"{res['prefix_cold_equal_token_share']:.4f}, warm "
          f"{res['prefix_warm_equal_token_share']:.4f}); ttft: "
          + json.dumps(out["prefix_ttft"]), flush=True)
    del model, params
    torch.cuda.empty_cache()
    return out


def ring_run(dev):
    """9(c): hymba-1.5b with a ring cache of its 2048 window. A monolithic
    prefill of 2600-token prompts through the kernels against the plain
    path (plain attention and scan; f32 within MODEL_F32_REL_TOL, bf16
    by phase 8(b)'s noise-floor rule), the rotated cache included, with
    its flash and scan launches and peak memory;
    then ``run_traffic(ring=True)`` on the slot engines in float32: the
    static and monolithic slot arms must emit the same tokens."""
    from repro_torch.config import ServeConfig
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_scan, ssd_scan_ref
    from repro_torch.launch import serve as launch
    from repro_torch.models.registry import build_model

    cfg = get_config("hymba-1.5b")
    L, W, S = cfg.num_layers, HYMBA_WINDOW, RING_PROMPT
    out = {}
    for dtype in ("bfloat16", "float32"):
        model = build_model(cfg, ServeConfig(param_dtype=dtype,
                                             compute_dtype=dtype,
                                             ring_buffer=True), device=dev)
        params = model.init(0)
        tok = torch.from_numpy(np.random.default_rng(9).integers(
            0, cfg.vocab_size, size=(2, S))).to(dev)
        launch.reset_kernel_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, tok, W)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated(dev) - base
        counts = launch.kernel_counters()
        require(counts["flash_launches"] == L and counts["ssd_launches"]
                == L, f"ring prefill {dtype}: flash "
                f"{counts['flash_launches']}, scan {counts['ssd_launches']} "
                f"launches for {L} layers")
        plain = {"attention": plain_flash, "scan": ssd_chunked_scan}
        ref_logits, ref_cache = model.prefill(params, tok, W, **plain)
        label = f"hymba-1.5b {dtype} ring prefill (B=2, S={S}, W={W})"
        if dtype == "float32":
            tol = MODEL_F32_REL_TOL
            res = compare(label, logits, ref_logits, cfg, tol=tol)
        else:
            # phase 8(b)'s bf16 rule for this 32-layer model: the larger
            # of MODEL_REL_TOL and NOISE_FLOOR_FACTOR x the noise floor,
            # the same prefill through the sequential plain scan
            floor_logits, _ = model.prefill(
                params, tok, W, attention=plain_flash,
                scan=lambda *a, chunk, return_state: ssd_scan_ref(
                    *a, return_state=return_state))
            floor = rel_diff(floor_logits, ref_logits, cfg)
            tol = max(MODEL_REL_TOL, NOISE_FLOOR_FACTOR * floor)
            res = compare(label, logits, ref_logits, cfg, tol=tol,
                          floor=floor, floor_agree=argmax_agree(
                              floor_logits, ref_logits, cfg))
            del floor_logits
        require(torch.equal(cache["pos"], ref_cache["pos"]),
                f"ring prefill {dtype}: position rows differ")
        pos = cache["pos"][0, :W].long()
        require(bool(((pos % W) == torch.arange(W, device=dev)).all())
                and int(pos.min()) == S - W and int(cache["pos"][0, W])
                == -1, f"ring prefill {dtype}: not the last {W} positions "
                "at columns pos % W")
        for k in ("k", "v", "conv", "ssm"):
            diff = float((cache[k].float() - ref_cache[k].float()).abs()
                         .max())
            scale = max(1.0, float(ref_cache[k].float().abs().max()))
            require(diff <= tol * scale, f"ring prefill {dtype}: cache {k} "
                    f"differs by {diff} (scale {scale})")
            res[f"cache_{k}_rel_err"] = diff / scale
        res.update(host_ms=ms, peak_bytes=int(peak),
                   kernels={k: counts[k] for k in (
                       "flash_launches", "ssd_launches")})
        print(f"ring prefill hymba-1.5b {dtype}: B=2 S={S} W={W} in "
              f"{ms:.2f} ms (host clock, first call), peak memory above "
              f"the model {peak} bytes, cache rel errs "
              + json.dumps({k: res[f'cache_{k}_rel_err'] for k in (
                  "k", "v", "conv", "ssm")}), flush=True)
        out[dtype] = res
        del logits, cache, ref_logits, ref_cache
        if dtype == "bfloat16":
            del model, params
            torch.cuda.empty_cache()

    launch.reset_kernel_counters()
    res = launch.run_traffic(
        "hymba-1.5b", smoke=False, device=dev, dtype="float32",
        params=params, ring=True, engine="both", requests=RING_REQUESTS,
        slots=2, prompt_len=S, max_new=(4, 12), rate=50.0,
        prefill_chunk=128, max_prefill_per_step=2, paged_compare=False,
        parity_check=False, prefix_compare=False, spec_compare=False,
        seed=0)
    counts = launch.kernel_counters()
    require(counts == res["kernels"], "counter mismatch")
    require(res["cache_len"] == W, f"ring cache_len {res['cache_len']}")
    require(counts["flash_launches"] == L * counts["prefill_calls"]
            and counts["ssd_launches"] == L * (counts["prefill_calls"]
                                               + counts["chunk_calls"]),
            f"ring run_traffic launches: {json.dumps(counts)}")
    require(counts["ref_calls"] == counts["flash_ref_calls"]
            == counts["ssd_ref_calls"] == 0, "a plain version ran")
    arms = res["outputs_by_arm"]
    for arm in ("static", "continuous", "continuous_monolithic"):
        require(res[arm].get("n") == RING_REQUESTS,
                f"ring {arm}: not all finished")
    static_mono = arms["static"] == arms["continuous_monolithic"]
    require(static_mono, "ring float32: the static and monolithic slot "
            "arms emit different tokens")
    out["run_traffic"] = dict(
        kernels=counts, static_monolithic_identical=static_mono,
        chunked_equal_token_share=res["static_equal_token_share"],
        tok_s={arm: res[arm]["tok_s"] for arm in (
            "static", "continuous", "continuous_monolithic")},
        max_memory_allocated=res.get("max_memory_allocated"))
    print(f"ring run_traffic hymba-1.5b float32 (cache_len {W}, prompts "
          f"{S}): static == monolithic slot {static_mono}, chunked slot "
          f"equal share {res['static_equal_token_share']:.4f}; tok/s "
          + json.dumps(out["run_traffic"]["tok_s"]) + "; kernels "
          + json.dumps(counts), flush=True)
    del model, params
    torch.cuda.empty_cache()
    return out


def phase_spec_prefix_ring(dev):
    """Phase 9: (a) the verify/resync kernel shapes, (b) speculation and
    prefix caching on gemma-2b in float32 and bfloat16, (c) hymba-1.5b's
    ring cache."""
    t0 = time.perf_counter()
    timer = Timer(dev)
    worst, times = phase_verify_kernels(dev, timer)
    del timer
    torch.cuda.empty_cache()
    runs = {dt: spec_prefix_run(dev, dt) for dt in ("float32", "bfloat16")}
    ring = ring_run(dev)
    seconds = time.perf_counter() - t0
    print(f"phase 9: {seconds:.1f} s", flush=True)
    print("phase 9: " + json.dumps({"spec_prefix": runs, "ring": ring,
                                    "seconds": seconds}), flush=True)
    return worst, times, runs, ring


# ---------------------------------------------------------------------------
# phase 11: the engine's comm binding, burst and sampled traces, tracing
# ---------------------------------------------------------------------------

#: phase 11's trace: 8 requests of phase 5's mixed 16/256 Poisson trace
OBS_TRACE = dict(prompt_len=(16, 256), max_new=(4, 48), rate=50.0, seed=0)
OBS_REQUESTS = 8
#: the replay's step clock: a request enters before the first micro-step
#: whose index reaches ``arrival * OBS_STEPS_PER_S``, so two engines see
#: the same arrivals whatever their speed
OBS_STEPS_PER_S = 100.0


def obs_engine(model, params, dev, comm=None, **kw):
    """Phase 5's paged engine (8 rows, chunk 64 x 2 a step, 16-token
    blocks), bound to ``comm`` when given."""
    from repro_torch.serve import ContinuousEngine
    return ContinuousEngine(
        model, params, cache_len=256 + 48, num_slots=8, prefill_chunk=64,
        max_prefill_per_step=2, kv_layout="paged", block_size=16, comm=comm,
        device=dev, **kw)


def replay(eng, reqs):
    """Drive ``reqs`` through ``eng`` on the step clock; per step the
    block tables, the admitted and the finished rids, and every decoding
    row's tokens so far."""
    log, i, step = [], 0, 0
    pending = sorted(reqs, key=lambda r: r.arrival)
    while i < len(pending) or not eng.idle:
        while (i < len(pending)
               and pending[i].arrival * OBS_STEPS_PER_S <= step):
            eng.submit(pending[i], float(step))
            i += 1
        done = eng.step(float(step))
        live = tuple((r.rid, tuple(int(t) for t in out[:r.generated]))
                     for r, out in zip(eng._slot_req, eng._slot_out)
                     if r is not None)
        log.append((eng.kv._tables.tobytes(),
                    tuple(sorted(r.rid for r in reqs
                                 if r.admit_time == step)),
                    tuple(sorted(r.rid for r in done)), live))
        step += 1
        require(step < 10_000, "replay did not drain")
    return log


def bound_vs_unbound(model, params, dev, root, **kw):
    """Phase 11(a): the same trace through engines bound to ``root`` and
    unbound ones, in turns (unbound, bound, bound, unbound: the host
    times of the two sides read in one call, neither side always first).
    Per step the same tables, admissions, finishes and tokens; the same
    final pools bit for bit (the drafter's too); the same launches, each
    kernel of the path launched."""
    from repro_torch.launch import serve as launch
    from repro_torch.serve import make_trace

    trace = make_trace(OBS_REQUESTS, **OBS_TRACE)
    label = f"speculate={kw['speculate']}" if kw else "plain"
    runs = []
    for name, comm in (("unbound", None), ("bound", root), ("bound", root),
                       ("unbound", None)):
        eng = obs_engine(model, params, dev, comm=comm, **kw)
        reqs = launch.requests_from_trace(model.cfg, trace, seed=0)
        torch.cuda.synchronize()
        launch.reset_kernel_counters()
        t0 = time.perf_counter()
        log = replay(eng, reqs)
        torch.cuda.synchronize()
        runs.append(dict(name=name, eng=eng, log=log,
                         seconds=time.perf_counter() - t0,
                         counts=launch.kernel_counters(),
                         tokens=sum(r.generated for r in reqs)))
        require(all(r.state == "done" for r in reqs),
                f"11(a) {label} {name}: a request did not finish")
    unbound, bound = runs[0], runs[1]
    require(bound["eng"]._decode_stream.name == "decode"
            and bound["eng"]._decode_stream._cuda is not None,
            "11(a): the bound engine's streams are not CUDA streams")
    for run in runs[1:]:
        require(len(run["log"]) == len(unbound["log"]),
                f"11(a) {label}: {len(run['log'])} steps {run['name']} vs "
                f"{len(unbound['log'])} unbound")
        for step, (a, b) in enumerate(zip(run["log"], unbound["log"])):
            require(a == b, f"11(a) {label}: step {step} differs between "
                    f"a {run['name']} and the unbound engine")
        pools = [("kv", run["eng"].kv, unbound["eng"].kv)]
        if kw:
            pools.append(("draft_kv", run["eng"].draft_kv,
                          unbound["eng"].draft_kv))
        for pname, pa, pb in pools:
            for k, t in pa.buffers.items():
                require(torch.equal(t, pb.buffers[k]),
                        f"11(a) {label}: final {pname}[{k!r}] differs")
        require(run["counts"] == unbound["counts"],
                f"11(a) {label}: launches differ: {run['counts']} vs "
                f"{unbound['counts']}")
    counts = bound["counts"]
    seconds = {name: [r["seconds"] for r in runs if r["name"] == name]
               for name in ("bound", "unbound")}
    require(counts["decode_launches"] > 0 and counts["mq_launches"] > 0,
            f"11(a) {label}: a paged kernel never launched: {counts}")
    require(counts["ref_calls"] == 0,
            f"11(a) {label}: plain attention ran {counts['ref_calls']} "
            "times on the card")
    out = {"steps": len(bound["log"]), "tokens": bound["tokens"],
           "decode_launches": counts["decode_launches"],
           "mq_launches": counts["mq_launches"],
           "seconds_bound": seconds["bound"],
           "seconds_unbound": seconds["unbound"]}
    print(f"11(a) {label}: bound == unbound over {out['steps']} steps "
          f"(tables, admissions, finishes, tokens; final pools bitwise), "
          f"{out['tokens']} tokens, paged_decode x{counts['decode_launches']}"
          f" paged_mq x{counts['mq_launches']} each run; host seconds in "
          f"turns: unbound {seconds['unbound'][0]:.3f}, bound "
          f"{seconds['bound'][0]:.3f}, bound {seconds['bound'][1]:.3f}, "
          f"unbound {seconds['unbound'][1]:.3f}", flush=True)
    return out


def sampled_burst(model, params, dev, root):
    """Phase 11(b): a burst trace sampled at temperature 0.8 twice
    through the bound engine (the same tokens: each request has its own
    generator), then greedy: the same admissions, finishes and tables
    (``eos_id=-1``: they do not depend on the tokens)."""
    from repro_torch.launch import serve as launch
    from repro_torch.serve import make_trace

    eng = obs_engine(model, params, dev, comm=root)
    runs = []
    for temp in (0.8, 0.8, 0.0):
        trace = make_trace(OBS_REQUESTS, arrival="burst", burst=4,
                           temperature=temp, **OBS_TRACE)
        reqs = launch.requests_from_trace(model.cfg, trace, seed=0)
        launch.reset_kernel_counters()
        log = replay(eng, reqs)
        counts = launch.kernel_counters()
        require(counts["decode_launches"] > 0 and counts["mq_launches"] > 0
                and counts["ref_calls"] == 0,
                f"11(b) temperature {temp}: launches {counts}")
        runs.append((log, [r.output[:r.generated].tolist() for r in reqs]))
        eng.reset()
    (log1, tok1), (log2, tok2), (glog, gtok) = runs
    require(log1 == log2 and tok1 == tok2,
            "11(b): the sampled trace's two runs differ")
    require(len(log1) == len(glog)
            and all(a[:3] == b[:3] for a, b in zip(log1, glog)),
            "11(b): the sampled run's admissions or tables differ from the "
            "greedy run's")
    V = model.cfg.vocab_size
    require(all(0 <= t < V for row in tok1 for t in row),
            f"11(b): a sampled token out of [0, {V})")
    same = sum(a == b for x, y in zip(tok1, gtok) for a, b in zip(x, y))
    total = sum(len(x) for x in tok1)
    print(f"11(b): burst trace (4 at 1/50 s), temperature 0.8: two runs "
          f"token-identical over {len(log1)} steps; admissions and tables "
          f"equal the greedy run's; {same} of {total} tokens equal greedy",
          flush=True)
    return {"steps": len(log1), "tokens": total, "equal_greedy": same}


def decode_profiles(model, params, dev, root):
    """Decode steps (4 rows) of the bound engine with tracing off and on:
    eight steps timed by CUDA events in turns (off, on, on, off, twice;
    each side's median is its step time), then one step of each side
    profiled. The tracer adds host work only."""
    from repro_torch import obs
    from repro_torch.launch import serve as launch
    from repro_torch.serve import make_trace

    eng = obs_engine(model, params, dev, comm=root)
    trace = make_trace(4, prompt_len=16, max_new=48, arrival="all", seed=1)
    for r in launch.requests_from_trace(model.cfg, trace, seed=1):
        eng.submit(r, 0.0)
    while eng.num_prefilling or eng.scheduler.num_waiting:
        eng.step()
    step_ms = {"untraced": [], "traced": []}
    out = {"step_ms": step_ms}
    try:
        for label in ("untraced", "traced", "traced", "untraced") * 2:
            if label == "traced":
                obs.install()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            eng.step()
            ev[1].record()
            torch.cuda.synchronize()
            obs.uninstall()
            step_ms[label].append(ev[0].elapsed_time(ev[1]))
        for label in ("untraced", "traced"):
            if label == "traced":
                obs.install()
            out[label] = profile_step(f"decode {label} (B=4, bound)",
                                      eng.step,
                                      statistics.median(step_ms[label]))
            obs.uninstall()
    finally:
        obs.uninstall()
    print("decode step ms in turns (untraced / traced): "
          + json.dumps(step_ms), flush=True)
    return out


def traced_traffic(params, dev):
    """Phase 11(c): ``run_traffic`` (continuous arms and the parity
    batch) untraced, then traced: the Chrome trace written and parsed,
    the payload's residual keys, the launches of the traced run."""
    import tempfile

    from repro_torch import obs
    from repro_torch.launch import serve as launch

    args = dict(smoke=False, device="cuda", requests=OBS_REQUESTS, slots=8,
                engine="continuous", prefill_chunk=64,
                max_prefill_per_step=2, block_size=16, prefix_compare=False,
                spec_compare=False, params=params, **OBS_TRACE)
    obs.uninstall()
    offs = [launch.run_traffic("gemma-2b", **args)]
    tr = obs.install()
    try:
        launch.reset_kernel_counters()
        on = launch.run_traffic("gemma-2b", **args)
        counts = launch.kernel_counters()
        payload = launch._finalize_payload(on)
        with tempfile.TemporaryDirectory() as tmp:
            path = str(Path(tmp) / "trace.json")
            launch._write_trace(path)
            with open(path) as f:
                doc = json.load(f)
        n_events, dropped = tr.n_events, tr.dropped
        # a second traced run, then a second untraced one: tok/s read in
        # turns (off, on, on, off)
        obs.install()
        ons = [on, launch.run_traffic("gemma-2b", **args)]
    finally:
        obs.uninstall()
    offs.append(launch.run_traffic("gemma-2b", **args))
    require(counts == on["kernels"], "11(c): counter mismatch")
    require(counts["decode_launches"] > 0 and counts["mq_launches"] > 0
            and counts["flash_launches"] > 0,
            f"11(c): a kernel of the path never launched: {counts}")
    require(counts["ref_calls"] == 0 and counts["flash_ref_calls"] == 0,
            "11(c): a plain attention version ran on the card")
    evs = [e for e in doc["traceEvents"] if e["ph"] != "M"]
    names = {(e["name"], e["ph"]) for e in evs}
    for need in (("prefill_chunk", "X"), ("decode", "X"), ("admit", "i"),
                 ("hop:admission", "X"), ("block_pool", "C")):
        require(need in names, f"11(c): no {need[0]} event in the trace")
    for e in evs:
        if e["name"] == "hop:admission":
            require({"modeled_s", "measured_s", "residual_ratio"}
                    <= set(e["args"]),
                    f"11(c): a hop:admission span lacks its residual: "
                    f"{e['args']}")
    require(doc["metadata"]["dropped_events"] == 0 and dropped == 0,
            f"11(c): {dropped} events dropped")
    for key in ("residual_admission_ratio", "serialization_stall_s"):
        require(key in payload, f"11(c): payload has no {key}")
    arms = ("continuous", "continuous_monolithic", "continuous_paged")
    for arm in arms:
        for res in offs + ons:
            require(res[arm].get("n") == float(OBS_REQUESTS),
                    f"11(c) {arm}: {res[arm].get('n')} of {OBS_REQUESTS} "
                    "finished")
    hops = payload["residual_report"]["hops"]
    ratios = {k: row["ratio"] for k, row in hops.items()}
    tok_s = {arm: {"off": [r[arm]["tok_s"] for r in offs],
                   "on": [r[arm]["tok_s"] for r in ons]} for arm in arms}
    print(f"11(c): {n_events} events, 0 dropped; residual ratio by hop "
          f"(measured / modeled): {json.dumps(ratios)} over "
          f"{json.dumps({k: row['n'] for k, row in hops.items()})} hops; "
          f"serialization_stall_s {payload['serialization_stall_s']}",
          flush=True)
    for arm, v in tok_s.items():
        print(f"11(c) {arm:22s}: tok/s in turns: off {v['off'][0]:.2f}, "
              f"on {v['on'][0]:.2f}, on {v['on'][1]:.2f}, off "
              f"{v['off'][1]:.2f}", flush=True)
    print("11(c) traced launches: " + json.dumps(counts), flush=True)
    return {"events": n_events, "residual_ratio": ratios,
            "hops": {k: row["n"] for k, row in hops.items()},
            "serialization_stall_s": payload["serialization_stall_s"],
            "tok_s": tok_s, "launches_traced": counts}


def phase_comm_obs(dev):
    """Phase 11: gemma-2b at full width in bfloat16 from seed 0 on the
    paged engine bound to a one-rank threadcomm on the card: (a) bound
    vs unbound, plain and ``speculate=3``; (b) a sampled burst trace;
    (c) tracing through ``run_traffic`` and two profiled decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.core import threadcomm_init
    from repro_torch.core.compat import make_mesh

    t_phase = time.perf_counter()
    free_cuda()
    model, params = build_family("gemma-2b", dev)
    root = threadcomm_init(make_mesh((1,), ("ranks",)), process_axes=(),
                           thread_axes=("ranks",))
    root.start()
    try:
        record = {"bound": bound_vs_unbound(model, params, dev, root)}
        record["bound_spec"] = bound_vs_unbound(model, params, dev, root,
                                                speculate=3)
        free_cuda()
        record["sampled_burst"] = sampled_burst(model, params, dev, root)
        record["decode_profile"] = decode_profiles(model, params, dev, root)
    finally:
        root.finish()
        root.free()
    free_cuda()
    require(get_config("gemma-2b").vocab_size == model.cfg.vocab_size,
            "11: not gemma-2b's published config")
    record["traffic"] = traced_traffic(params, dev)
    del model, params
    free_cuda()
    record["seconds"] = time.perf_counter() - t_phase
    print(f"phase 11: {record['seconds']:.1f} s", flush=True)
    print("phase 11: " + json.dumps(record), flush=True)
    return record


# ---------------------------------------------------------------------------
# phase 12: the serving fabric
# ---------------------------------------------------------------------------

#: phase 12's trace and fabric: 16 requests of phase 5's mixed 16/256
#: Poisson trace (50 req/s, 4-48 new tokens), 2 engine ranks of 4 rows,
#: chunk 64 (two a step), 16-token blocks
FABRIC = dict(requests=16, ranks=2, slots=4, prompt_len=(16, 256),
              max_new=(4, 48), rate=50.0, prefill_chunk=64,
              max_prefill_per_step=2, block_size=16, seed=0)
#: blocks migrated by phase 12(d)'s transport check, and the pools' size
FABRIC_BLOCKS = 16
FABRIC_POOL_BLOCKS = 64


def fabric_run(params, dtype, **kw):
    """``run_fabric`` at phase 12's configuration; a lease leaked at a
    fabric's close fails the phase (the warning is raised)."""
    import warnings

    from repro_torch.launch import serve as launch
    from repro_torch.serve import LeaseLeakWarning

    args = dict(FABRIC, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error", LeaseLeakWarning)
        res = launch.run_fabric("gemma-2b", smoke=False, device="cuda",
                                dtype=dtype, params=params, **args)
    for p in res["placements"]:
        for name in ("single", f"fabric_{p}"):
            require(res[name].get("n") == float(args["requests"]),
                    f"12 {dtype} {name}: {res[name].get('n')} of "
                    f"{args['requests']} finished")
        launched = res[f"fabric_{p}"]["kernels"]
        require(launched["ref_calls"] == 0,
                f"12 {dtype} fabric_{p}: plain attention ran on the card")
        require(launched["decode_launches"] > 0
                and launched["mq_launches"] > 0,
                f"12 {dtype} fabric_{p}: paged_decode or paged_mq was not "
                f"launched in the drive: {launched}")
    return res


def fabric_blocks_expected():
    """Blocks the disaggregated run migrates: each prompt's whole blocks
    and its tail, sum of ceil(prompt_len / block_size)."""
    from repro_torch.serve import make_trace
    bs = FABRIC["block_size"]
    trace = make_trace(FABRIC["requests"], prompt_len=FABRIC["prompt_len"],
                       max_new=FABRIC["max_new"], rate=FABRIC["rate"],
                       seed=FABRIC["seed"])
    return sum(-(-e.prompt_len // bs) for e in trace)


def fabric_gated_f32(params):
    """12(a): both placements token-identical to the single engine in
    float32; 16 migrations of sum(ceil(prompt_len / 16)) blocks; the
    prefill rank emits no token."""
    res = fabric_run(params, "float32")
    for p in ("replicated", "disagg"):
        require(res[f"fabric_token_identical_{p}"],
                f"12(a) {p}: tokens differ from the single engine's "
                f"(equal share {res[f'fabric_equal_token_share_{p}']})")
    dis = res["fabric_disagg"]
    blocks = fabric_blocks_expected()
    require(dis["n_migrations"] == float(FABRIC["requests"]),
            f"12(a): {dis['n_migrations']} migrations, not "
            f"{FABRIC['requests']}")
    require(dis["blocks_moved"] == float(blocks),
            f"12(a): {dis['blocks_moved']} blocks moved, not {blocks}")
    pre = dis["per_rank"][0]
    require(pre["role"] == "prefill" and pre["tokens"] == 0.0,
            f"12(a): the prefill rank emitted tokens: {pre}")
    print(f"12(a) float32: replicated and disagg token-identical to the "
          f"single engine; {dis['n_migrations']:.0f} migrations, "
          f"{dis['blocks_moved']:.0f} blocks, {dis['bytes_moved']:.0f} "
          f"bytes; prefill rank 0 tokens", flush=True)
    return res


def fabric_traced(params, dev):
    """12(b): the disaggregated fabric (float32) warmed, then driven once
    under a fresh tracer: spans on the right rank lanes, one
    ``hop:migration`` and one ``kv_transfer`` a request, router dispatch
    hops, no dropped event; ``paged_decode`` / ``paged_mq`` launches 18x
    the decode / chunk forwards the trace records; both pools free after
    the drain and ``close(strict=True)`` clean."""
    from repro_torch import obs
    from repro_torch.config import ServeConfig
    from repro_torch.launch import serve as launch
    from repro_torch.models.registry import build_model
    from repro_torch.serve import ServingFabric, make_trace

    cfg = launch.arch_config("gemma-2b")
    model = build_model(cfg, ServeConfig(param_dtype="float32",
                                         compute_dtype="float32"),
                        device=dev)
    F = FABRIC
    fab = ServingFabric(model, params, ranks=F["ranks"], placement="disagg",
                        cache_len=max(F["prompt_len"]) + F["max_new"][1],
                        slots_per_rank=F["slots"],
                        prefill_chunk=F["prefill_chunk"],
                        max_prefill_per_step=F["max_prefill_per_step"],
                        block_size=F["block_size"], device=dev)
    obs.uninstall()
    try:
        launch._warm_fabric(fab, cfg, seed=0, prompt_len=F["prompt_len"][0])
        trace = make_trace(F["requests"], prompt_len=F["prompt_len"],
                           max_new=F["max_new"], rate=F["rate"], seed=0)
        reqs = launch.requests_from_trace(cfg, trace, seed=0)
        tr = obs.install(capacity=1 << 18)
        torch.cuda.synchronize()
        launch.reset_kernel_counters()
        stats = launch.drive_fabric(fab, reqs)
        counts = launch.kernel_counters()
        events = tr.events()
        dropped = tr.dropped
    finally:
        obs.uninstall()
    try:
        free = [w.engine.kv.pool.num_free == w.engine.kv.pool.num_blocks
                for w in fab.workers]
        require(all(free), f"12(b): a pool is not free after the drain: "
                f"{free}")
    finally:
        fab.close(strict=True)
    names = {}
    for e in events:
        names.setdefault((e["name"], e["tid"]), 0)
        names[(e["name"], e["tid"])] += 1

    def n(name, tid=None):
        return sum(v for (k, t), v in names.items()
                   if k == name and (tid is None or t == tid))

    n_req = F["requests"]
    require(n("decode", 0) == 0, "12(b): a decode span on the prefill rank")
    require(n("prefill_chunk", 1) == 0,
            "12(b): a prefill_chunk span on the decode rank")
    require(n("hop:migration") == n_req and n("kv_transfer") == n_req,
            f"12(b): {n('hop:migration')} hop:migration and "
            f"{n('kv_transfer')} kv_transfer spans for {n_req} requests")
    require(n("hop:router_dispatch") == n_req,
            f"12(b): {n('hop:router_dispatch')} router dispatch hops")
    require(n("rank_step", 0) > 0 and n("rank_step", 1) > 0,
            "12(b): a rank lane holds no rank_step span")
    require(dropped == 0, f"12(b): {dropped} events dropped")
    L = cfg.num_layers
    decodes, chunks = n("decode"), n("prefill_chunk")
    require(counts["decode_launches"] == L * decodes
            and counts["mq_launches"] == L * chunks,
            f"12(b): launches {counts} against {decodes} decode and "
            f"{chunks} chunk forwards x {L} layers")
    require(decodes > 0 and chunks > 0 and counts["ref_calls"] == 0,
            f"12(b): launches {counts}")
    require(stats.get("n") == float(n_req) and all(
        r.state == "done" for r in reqs), "12(b): a request did not finish")
    print(f"12(b): traced disaggregated run: {len(events)} events, 0 "
          f"dropped; {decodes} decode spans (rank 1 only), {chunks} "
          f"prefill_chunk spans (rank 0 only), {n('hop:migration')} "
          f"migrations, {n('kv_transfer')} kv_transfer, "
          f"{n('hop:router_dispatch')} dispatch hops; paged_decode "
          f"x{counts['decode_launches']} = {L} x {decodes}, paged_mq "
          f"x{counts['mq_launches']} = {L} x {chunks}; pools free, "
          f"close(strict=True) clean", flush=True)
    return {"events": len(events), "decode_spans": decodes,
            "chunk_spans": chunks, "decode_launches":
            counts["decode_launches"], "mq_launches": counts["mq_launches"],
            "residual_migration_ratio": stats.get(
                "residual_migration_ratio"),
            "residual_router_dispatch_ratio": stats.get(
                "residual_router_dispatch_ratio")}


def fabric_spec_sampled(params):
    """12(c): the replicated fabric with ``speculate=3`` and a sampled
    (0.8) trace through the disaggregated fabric, each token-identical
    to the single engine (float32)."""
    spec = fabric_run(params, "float32", placements=("replicated",),
                      speculate=3)
    require(spec["fabric_speculate_k_replicated"] == 3,
            "12(c): the replicated ranks did not speculate")
    require(spec["fabric_token_identical_replicated"],
            "12(c): speculate=3 tokens differ from the single engine's")
    require(spec["fabric_replicated"]["kernels"]["verify_calls"] > 0,
            "12(c): no verify forward ran")
    sampled = fabric_run(params, "float32", placements=("disagg",),
                         temperature=0.8)
    require(sampled["fabric_token_identical_disagg"],
            "12(c): the sampled trace's tokens differ between the single "
            "engine and the disaggregated fabric")
    print(f"12(c): speculate=3 replicated fabric token-identical "
          f"({spec['fabric_replicated']['kernels']['verify_calls']} verify "
          f"forwards); sampled (0.8) disaggregated fabric token-identical "
          f"to the single engine", flush=True)
    return {"spec": spec["fabric_replicated"]["kernels"],
            "sampled_equal": sampled["fabric_equal_token_share_disagg"]}


def fabric_transport(model, dev, timer):
    """12(d): a random bf16 pool at gemma-2b's geometry; 16 blocks moved
    to another pool, bitwise; the per-block copy timed (CUDA events, L2
    flushed) and host-inclusive (``migrate``: copies, requests, waitall)
    beside its byte bound and the modeled price."""
    from repro_torch.core import threadcomm_init
    from repro_torch.core.compat import make_mesh
    from repro_torch.serve import KVBlockTransport, PagedKVCache

    mbr = -(-(max(FABRIC["prompt_len"]) + FABRIC["max_new"][1])
            // FABRIC["block_size"])
    geo = dict(num_blocks=FABRIC_POOL_BLOCKS,
               block_size=FABRIC["block_size"], num_slots=4,
               max_blocks_per_req=mbr)
    src, dst = PagedKVCache(model, **geo), PagedKVCache(model, **geo)
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    for t in src.buffers.values():
        t.copy_(torch.randn(t.shape, generator=g, device=dev,
                            dtype=torch.float32))
    perm = torch.randperm(FABRIC_POOL_BLOCKS, generator=torch.Generator()
                          .manual_seed(3)).tolist()
    sb, db = perm[:FABRIC_BLOCKS], perm[FABRIC_BLOCKS:2 * FABRIC_BLOCKS]
    root = threadcomm_init(make_mesh((1,), ("serve",)), process_axes=(),
                           thread_axes=("serve",))
    root.start()
    try:
        tp = KVBlockTransport(root)
        tp.migrate(src, dst, sb, db)
        for name, t in dst.buffers.items():
            s = src.buffers[name]
            require(torch.equal(t[:, db], s[:, sb]),
                    f"12(d): migrated {name} blocks differ from the source")
            rest = [b for b in range(FABRIC_POOL_BLOCKS) if b not in db]
            require(not t[:, rest].any(),
                    "12(d): a block outside the destination list changed")
        nb = tp.block_nbytes(src)
        require(nb == 294_912, f"12(d): {nb} bytes a block, not 294,912")
        modeled_us = tp.stats()["kv_migration_us_per_block"]

        def copies():
            for a, b in zip(sb, db):
                tp._copy_impl(dst.buffers, src.buffers, a, b)
        dev_us = 1e3 * timer.ms(copies) / FABRIC_BLOCKS
        host = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tp.migrate(src, dst, sb, db)
            host.append(time.perf_counter() - t0)
        host_us = 1e6 * statistics.median(host) / FABRIC_BLOCKS
    finally:
        root.finish()
        root.free()
    bound_us = 1e6 * 2 * nb / HBM_BYTES_PER_S
    print(f"12(d): {FABRIC_BLOCKS} blocks of {nb} B (bf16, 18 layers x k,v "
          f"x 16 tokens x 1 kv head x 256) moved bitwise; device "
          f"{dev_us:.3f} us a block (CUDA events, L2 flushed), host-"
          f"inclusive {host_us:.3f} us a block (migrate, median of 20); "
          f"bound {bound_us:.4f} us ({2 * nb} B read + written over 3.35 "
          f"TB/s); modeled {modeled_us:.4f} us a block", flush=True)
    return {"block_bytes": nb, "device_us_per_block": dev_us,
            "host_us_per_block": host_us, "bound_us_per_block": bound_us,
            "modeled_us_per_block": modeled_us}


def fabric_bf16(params):
    """Printed, not gated: the bf16 comparison (the serving dtype)."""
    res = fabric_run(params, "bfloat16")
    out = {}
    for name in ("single", "fabric_replicated", "fabric_disagg"):
        m = res[name]
        out[name] = {"tok_s": m["tok_s"], "ttft_p50_ms": 1e3 * m[
            "ttft_p50_s"], "ttft_p95_ms": 1e3 * m["ttft_p95_s"],
            "makespan_s": m["makespan_s"]}
        if "per_rank" in m:
            out[name]["utilization"] = [r["utilization"]
                                        for r in m["per_rank"]]
        print(f"12 bf16 {name:>17}: {m['tok_s']:.2f} tok/s, TTFT p50 "
              f"{out[name]['ttft_p50_ms']:.2f} ms p95 "
              f"{out[name]['ttft_p95_ms']:.2f} ms, makespan "
              f"{m['makespan_s']:.3f} s"
              + (f", rank utilization {out[name]['utilization']}"
                 if "per_rank" in m else ""), flush=True)
    for p in ("replicated", "disagg"):
        out[f"speedup_vs_single_{p}"] = res[f"speedup_vs_single_{p}"]
        out[f"equal_token_share_{p}"] = res[f"fabric_equal_token_share_{p}"]
    out["kernels"] = {p: res[f"fabric_{p}"]["kernels"]
                      for p in ("replicated", "disagg")}
    print("12 bf16: " + json.dumps({k: v for k, v in out.items()
                                    if k.startswith(("speedup", "equal"))}),
          flush=True)
    return out


def phase_fabric(dev):
    """Phase 12: the serving fabric on gemma-2b at full width from seed
    0: (a) float32 token identity of both placements and the migration
    counts; (b) the traced disaggregated run; (c) speculation and a
    sampled trace; (d) the transport at full width; then the bf16
    comparison, printed."""
    t_phase = time.perf_counter()
    free_cuda()
    model, params = build_family("gemma-2b", dev, dtype="float32")
    record = {"a": fabric_gated_f32(params)}
    record["b"] = fabric_traced(params, dev)
    record["c"] = fabric_spec_sampled(params)
    a = record.pop("a")
    record["f32"] = {k: a[k] for k in ("speedup_vs_single_replicated",
                                       "speedup_vs_single_disagg")}
    record["f32_migration"] = {k: a["fabric_disagg"][k] for k in (
        "n_migrations", "blocks_moved", "bytes_moved",
        "kv_migration_us_per_block")}
    del model, params
    free_cuda()
    model, params = build_family("gemma-2b", dev)
    timer = Timer(dev)
    record["d"] = fabric_transport(model, dev, timer)
    del timer
    record["bf16"] = fabric_bf16(params)
    del model, params
    free_cuda()
    record["seconds"] = time.perf_counter() - t_phase
    print(f"phase 12: {record['seconds']:.1f} s", flush=True)
    print("phase 12: " + json.dumps(record), flush=True)
    return record


# ---------------------------------------------------------------------------
# phase 13: the training path
# ---------------------------------------------------------------------------

#: 13(b)'s mesh: two processes ("pod") of two threads ("data"), model 1:
#: R = 4 ranks, M = 2 threads a process, the smallest with both levels
TRAIN_MESH = ((2, 2, 1), ("pod", "data", "model"))
TRAIN_BATCH, TRAIN_SEQ = 8, 128
#: 13(b)'s depth: gemma-2b's widths at 2 of 18 layers (0.74 B
#: parameters): an explicit step holds ~50 bytes a parameter at R = 4
TRAIN_SYNC_LAYERS = 2
#: the three gradient syncs' losses against each other (float32): the
#: reference's own grad-sync parity bound (``tests/mp_cases.py``)
SYNC_TOL = 1e-4
#: the bf16 wire's losses against float32's: the reference's bound
WIRE_TOL = 2e-2
#: the port's loss and gradient norm on the card against the CPU's, and
#: each family's smoke losses (float32 on both, sums in other orders)
DEVICE_TOL = 1e-4
#: where 13(d) writes its checkpoint (git-ignored, removed after)
TRAIN_CKPT = ROOT / "build" / "phase13_ckpt"


def train_gemma_full(dev):
    """13(a): gemma-2b at full width and depth in bf16 through the
    launcher (``launch.train.run_train``: TrainConfig defaults with remat
    on, loss_chunk 64, lr 3e-3 with 10 warmup steps), B=8 S=128, 4
    steps, the 4th profiled; every loss finite. The collector is off for
    the 4 steps: after each, the bytes allocated beyond the phase's start
    and the state stay under ``HELD_GATE``."""
    from repro_torch.launch.train import run_train
    free_cuda()
    warm_backward(dev)
    outside = torch.cuda.memory_allocated(dev)
    wall_ms, prof, held = [], {}, []

    def wrapper(i, thunk):
        if i < 3:
            t0 = time.perf_counter()
            out = thunk()
            torch.cuda.synchronize()
            wall_ms.append(1e3 * (time.perf_counter() - t0))
        else:
            box = {}

            def step():
                box["out"] = thunk()
            # the profiled step also runs under FlopCounterMode (host-side
            # only: its device time is the same), for phase 15(c)
            with FlopCounterMode(display=False) as fc:
                prof.update(profile_step("13(a) train step, gemma-2b bf16",
                                         step, statistics.median(wall_ms),
                                         names=()) or {})
            prof["flop_count"] = fc.get_total_flops()
            out = box["out"]
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated(dev) - outside
                    - state_bytes(out[0]))
        return out

    t0 = time.perf_counter()
    with collector_off():
        res = run_train("gemma-2b", steps=4, batch=TRAIN_BATCH,
                        seq=TRAIN_SEQ, lr=3e-3, device=dev,
                        step_wrapper=wrapper,
                        log=lambda line: print("13(a) " + line, flush=True))
    losses = res["losses"]
    require(len(losses) == 4 and all(math.isfinite(x) for x in losses),
            f"13(a): the losses are not 4 finite values: {losses}")
    print(f"13(a) held after each step beyond the phase's start and the "
          f"state: {held} bytes (gate {HELD_GATE})", flush=True)
    require(all(h < HELD_GATE for h in held),
            f"13(a): a step left {held} bytes beyond the state, over "
            f"{HELD_GATE}")
    med = statistics.median(wall_ms)
    out = {"losses": losses, "step_ms": wall_ms, "median_step_ms": med,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med * 1e3,
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "params": res["params"], "idle_share": prof.get("idle_share"),
           "device_busy_ms": prof.get("device_busy_ms"),
           "device_launches": prof.get("device_launches"),
           "flop_count": prof.get("flop_count"), "held_beyond_state": held,
           "seconds": time.perf_counter() - t0}
    print(f"13(a) gemma-2b 18 layers bf16 B={TRAIN_BATCH} S={TRAIN_SEQ}: "
          f"losses {losses}; steps 1-3 {wall_ms} ms (host wall clock, "
          f"synchronised), median {med:.3f} ms, "
          f"{out['tokens_per_s']:.1f} tokens/s; peak "
          f"{out['max_memory_allocated']} bytes allocated; idle share "
          f"{out['idle_share']}; {out['seconds']:.1f} s", flush=True)
    del res
    free_cuda()
    # the same 4 steps at a tenth of the rate: is a loss that rises over
    # the warmup the schedule's (printed, not gated)
    slow = run_train("gemma-2b", steps=4, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     lr=3e-4, device=dev, log=lambda line: None)
    require(all(math.isfinite(x) for x in slow["losses"]),
            f"13(a): a non-finite loss at lr 3e-4: {slow['losses']}")
    out["losses_lr_3e-4"] = slow["losses"]
    print(f"13(a) the same at lr 3e-4: losses {slow['losses']}", flush=True)
    del slow
    free_cuda()
    return out


#: bytes a train step may leave allocated beyond its state when it
#: returns: its batch, its metrics, the allocator's 512-B rounding of a
#: few hundred leaves. A step's gradients held by a reference cycle are a
#: copy of the parameters (gemma-2b bf16: 5,012,344,832 B)
HELD_GATE = 64 << 20


def warm_backward(dev):
    """A small product in bf16 and f32, forward and backward: the cuBLAS
    handles of the autograd thread and their workspaces (allocated by the
    caching allocator, kept for the process) exist before a phase reads
    the bytes allocated at its start. Without it the process's first
    backward, in 13(a), allocates 64 MiB of workspace that its held
    bytes then count (67,119,612 B after step 1 on an H100)."""
    for dt in (torch.bfloat16, torch.float32):
        a = torch.ones((64, 64), device=dev, dtype=dt, requires_grad=True)
        (a @ a).sum().backward()
    torch.cuda.synchronize()


def state_bytes(state):
    """The bytes of a train state's tensors: the parameters and AdamW's
    step, m, v and float32 master."""
    from repro_torch.interop import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(state))


def sync_model(dev, grad_sync, wire="float32"):
    """gemma-2b at full width, 2 layers, float32, for 13(b)-(d)."""
    from repro_torch.config import ServeConfig, TrainConfig
    from repro_torch.launch.serve import arch_config
    from repro_torch.models.registry import build_model
    tcfg = TrainConfig(param_dtype="float32", compute_dtype="float32",
                       learning_rate=3e-3, warmup_steps=10, total_steps=100,
                       grad_sync=grad_sync, grad_comm_dtype=wire,
                       loss_chunk=64, attn_chunk_threshold=256)
    cfg = arch_config("gemma-2b", layers=TRAIN_SYNC_LAYERS)
    return build_model(cfg, ServeConfig(), device=dev, train=tcfg), tcfg


def train_batches(cfg, dev, steps=3):
    from repro_torch.data import SyntheticPipeline
    pipe = SyntheticPipeline(cfg, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                             seed=0)
    return [{k: torch.as_tensor(v, device=dev)
             for k, v in pipe.get_batch(i).items()} for i in range(steps)]


def flat_params(state):
    from repro_torch.train.explicit import flatten_tree
    return flatten_tree(state.params)


def sync_run(dev, grad_sync, wire="float32", save_at=None, profile=False):
    """3 steps of 13(b) in one gradient sync; returns the losses, the
    final flat params on the host, the metrics, each step's msgq 1-copy
    launches, the peak memory and the step times (host wall clock, the
    loss read back). ``save_at``: checkpoint the state after that many
    steps (13(d)) and keep the next step's state on the host.
    ``profile``: profile the 3rd step against the 2nd's time."""
    from repro_torch.config import MeshConfig
    from repro_torch.core.compat import make_mesh
    from repro_torch.kernels.msgq import ops as mq
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.explicit import init_explicit_state
    from repro_torch.train.trainer import init_train_state, make_train_step
    free_cuda()
    model, tcfg = sync_model(dev, grad_sync, wire)
    mesh_cfg = MeshConfig(shape=TRAIN_MESH[0], axis_names=TRAIN_MESH[1],
                          process_axes=("pod",))
    if grad_sync == "spmd":
        state = init_train_state(model, 0)
        step = make_train_step(model, mesh_cfg, tcfg)
    else:
        state = init_explicit_state(model, 0, dp=mesh_cfg.dp)
        step = make_train_step(model, mesh_cfg, tcfg, mesh=make_mesh(
            *TRAIN_MESH, device=dev))
    losses, metrics, launches, ms, kept, prof = [], [], [], [], None, None
    for i, batch in enumerate(train_batches(model.cfg, dev)):
        before = mq.one_copy_launches
        t0 = time.perf_counter()
        if profile and i == 2:
            box = {}

            def one(state=state, batch=batch):
                box["out"] = step(state, batch)
            prof = profile_step(f"13(b) {grad_sync} step", one, ms[-1],
                                names=())
            state, met = box["out"]
        else:
            state, met = step(state, batch)
        losses.append(float(met["loss"]))
        ms.append(1e3 * (time.perf_counter() - t0))
        launches.append(mq.one_copy_launches - before)
        metrics.append({k: float(v) for k, v in met.items()})
        if save_at is not None and i + 1 == save_at:
            ckpt.save(str(TRAIN_CKPT), i + 1, state, keep=1)
        if save_at is not None and i == save_at:
            kept = tree_host(state)
    out = {"losses": losses, "metrics": metrics, "one_copy": launches,
           "step_ms": ms, "params": flat_params(state).cpu(),
           "plen": (None if grad_sync == "spmd" else state.opt.m.numel()),
           "peak": torch.cuda.max_memory_allocated(dev), "kept": kept,
           "idle_share": prof and prof.get("idle_share")}
    if grad_sync != "spmd":
        step.comm.finish()
    print(f"13(b) {grad_sync} wire {wire}: losses {losses}, step ms {ms}, "
          f"msgq_one_copy launches a step {launches}, peak "
          f"{out['peak']} bytes allocated, params_rank_spread "
          f"{[m.get('params_rank_spread') for m in metrics]}", flush=True)
    del state, step, model
    free_cuda()
    return out


def tree_host(state):
    from repro_torch.interop import tree_map
    return tree_map(lambda t: t.detach().cpu().clone(), state)


def train_sync(dev):
    """13(b): spmd, threadcomm and flat (float32), then threadcomm over
    a bf16 wire, 3 steps each on the same batches; 13(d) rides on the
    float32 threadcomm run (checkpoint after step 2)."""
    runs = {"spmd": sync_run(dev, "spmd", profile=True),
            "threadcomm": sync_run(dev, "threadcomm", save_at=2,
                                   profile=True),
            "flat": sync_run(dev, "flat")}
    ref = runs["spmd"]["losses"]
    diffs = {}
    for mode in ("threadcomm", "flat"):
        got = runs[mode]["losses"]
        require(all(abs(a - b) <= SYNC_TOL + SYNC_TOL * abs(b)
                    for a, b in zip(got, ref)),
                f"13(b): {mode} losses {got} part from spmd's {ref} "
                f"beyond rtol=atol={SYNC_TOL}")
        spread = max(m["params_rank_spread"] for m in runs[mode]["metrics"])
        require(spread == 0.0, f"13(b): {mode}: the ranks' new params "
                f"differ by up to {spread}")
        diffs[mode] = float((runs[mode]["params"]
                             - runs["spmd"]["params"]).abs().max())
    print(f"13(b) max |params - spmd params| after 3 steps: {diffs}",
          flush=True)
    runs["bf16_wire"] = sync_run(dev, "threadcomm", wire="bfloat16")
    got, f32 = runs["bf16_wire"]["losses"], runs["threadcomm"]["losses"]
    require(all(abs(a - b) <= WIRE_TOL + WIRE_TOL * abs(b)
                for a, b in zip(got, f32)),
            f"13(b): bf16-wire losses {got} part from float32's {f32} "
            f"beyond {WIRE_TOL}")
    wire_launches = sum(runs["bf16_wire"]["one_copy"])
    require(wire_launches > 0, "13(b): the bf16-wire run launched no "
            "msgq_one_copy")
    require(sum(runs["threadcomm"]["one_copy"]) == 0
            and sum(runs["flat"]["one_copy"]) == 0,
            "13(b): a float32 sync launched msgq_one_copy")
    return runs, diffs


def train_wire_kernel(dev, timer, plen):
    """13(c): ``msgq_one_copy`` at 13(b)'s wire message: one round of the
    slow-domain recursive doubling (pod 0 <-> pod 1 in every thread
    family), plen / M bf16 elements a rank, against its plain version
    bitwise; its time (CUDA events, median of 30, L2 flushed), bound,
    plain and library (``index_select``) times."""
    from repro_torch.core import protocol
    from repro_torch.core.compat import make_mesh
    from repro_torch.kernels.msgq import ops as mq
    from repro_torch.kernels.msgq.ref import msgq_round_ref
    free_cuda()
    mesh = make_mesh(*TRAIN_MESH, device=dev)
    region = mesh.region(TRAIN_MESH[1])
    R, n = region.size, plen // region.axis_size("data")
    pairs = region.pairs(("pod",), [(0, 1), (1, 0)])
    g = torch.Generator().manual_seed(13)
    x = torch.randn((R, n), generator=g).to(dev, torch.bfloat16)
    proto = protocol.select_protocol(n * 2)
    require(not mq.is_eager(proto), f"13(c): a {n * 2}-byte message "
            f"takes {proto}, not the 1-copy kernel")
    before = mq.one_copy_launches
    out = mq.msgq_round(x, pairs, proto=proto)
    require(mq.one_copy_launches == before + 1 and mq.last_path == "direct",
            "13(c): the round did not launch msgq_one_copy's direct copy")
    ref = msgq_round_ref(x, pairs)
    err = float((out.float() - ref.float()).abs().max())
    require(bitwise(out, ref), f"13(c): msgq_one_copy differs from "
            f"ref.py at the wire message (max abs err {err:.3e})")
    del out, ref
    inverse = torch.tensor([s for s, _ in sorted(pairs, key=lambda p: p[1])],
                           device=dev)
    nbytes = 2 * R * n * 2
    row = {"train_wire_shape": f"(R={R}, {n}) bf16, pod pairs "
                               f"{pairs}",
           "train_wire_ms": timer.ms(lambda: mq.msgq_round(
               x, pairs, proto=proto)),
           "train_wire_plain_ms": timer.ms(lambda: msgq_round_ref(x, pairs)),
           "train_wire_library_ms": timer.ms(
               lambda: x.index_select(0, inverse)),
           "train_wire_bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
           "train_wire_bound_bytes": nbytes, "train_wire_max_abs_err": err}
    row["train_wire_bound_share"] = (row["train_wire_bound_ms"]
                                     / row["train_wire_ms"])
    print(f"13(c) msgq_one_copy at the wire message {row['train_wire_shape']}"
          f": bitwise; ms={row['train_wire_ms']:.4f} plain_ms="
          f"{row['train_wire_plain_ms']:.4f} library_ms="
          f"{row['train_wire_library_ms']:.4f} bound_ms="
          f"{row['train_wire_bound_ms']:.4f} (bytes: {nbytes}), share "
          f"{row['train_wire_bound_share']:.3f}", flush=True)
    del x
    free_cuda()
    return row, err


def train_resume(dev, kept):
    """13(d): the float32 threadcomm state checkpointed after step 2,
    restored into a fresh state, takes step 3: bitwise the uninterrupted
    step 3's state."""
    from repro_torch.config import MeshConfig
    from repro_torch.core.compat import make_mesh
    from repro_torch.interop import named_leaves
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.explicit import init_explicit_state
    from repro_torch.train.trainer import make_train_step
    free_cuda()
    t0 = time.perf_counter()
    model, tcfg = sync_model(dev, "threadcomm")
    mesh_cfg = MeshConfig(shape=TRAIN_MESH[0], axis_names=TRAIN_MESH[1],
                          process_axes=("pod",))
    fresh = init_explicit_state(model, 1, dp=mesh_cfg.dp)
    state, at, _ = ckpt.restore(str(TRAIN_CKPT), fresh)
    del fresh
    require(at == 2, f"13(d): restored step {at}, not 2")
    step = make_train_step(model, mesh_cfg, tcfg,
                           mesh=make_mesh(*TRAIN_MESH, device=dev))
    state, _ = step(state, train_batches(model.cfg, dev)[2])
    step.comm.finish()
    got, want = named_leaves(state), named_leaves(kept)
    differ = [a.name for a, b in zip(got, want)
              if not all(bitwise(s.cpu(), t) for s, t in
                         zip(a.tensors, b.tensors))]
    require([a.name for a in got] == [b.name for b in want] and not differ,
            f"13(d): the resumed step 3 differs from the uninterrupted "
            f"one in {differ}")
    size = sum(p.stat().st_size for p in TRAIN_CKPT.rglob("*")
               if p.is_file())
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    print(f"13(d) checkpoint of {size} bytes after step 2, restored, "
          f"step 3 bitwise the uninterrupted one ({len(got)} leaves), "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del state
    free_cuda()
    return {"bytes": size}


def train_card_vs_cpu(dev):
    """13(e): gemma-2b's widths at 1 layer in float32, B=2 S=64, the same
    parameters on the card and on the CPU: the loss and the gradient
    norm within DEVICE_TOL relative; then every other architecture at its
    smoke config, 2 spmd steps in float32 on both: finite losses, equal
    within DEVICE_TOL."""
    from repro_torch.config import MeshConfig, ServeConfig, TrainConfig
    from repro_torch.configs import ARCH_NAMES, get_smoke_config
    from repro_torch.data import SyntheticPipeline
    from repro_torch.interop import tree_map
    from repro_torch.launch.serve import arch_config
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw_init, global_norm
    from repro_torch.train.trainer import (TrainState, make_train_step,
                                           value_and_grad)
    free_cuda()
    require(not torch.backends.cuda.matmul.allow_tf32,
            "13(e): float32 matmuls would run in TF32")
    cpu = torch.device("cpu")
    tcfg = TrainConfig(param_dtype="float32", compute_dtype="float32",
                       learning_rate=3e-3, warmup_steps=10, total_steps=100,
                       loss_chunk=64, attn_chunk_threshold=256)
    cfg = arch_config("gemma-2b", layers=1)
    batch = SyntheticPipeline(cfg, batch=2, seq_len=64, seed=0).get_batch(0)
    res = {}
    for d in (dev, cpu):
        model = build_model(cfg, ServeConfig(), device=d, train=tcfg)
        params = (model.init(0) if d == dev else
                  tree_map(lambda t: t.cpu(), res[dev]["params"]))
        loss, _, grads = value_and_grad(
            model.train_loss, params,
            {k: torch.as_tensor(v, device=d) for k, v in batch.items()})
        res[d] = {"params": params, "loss": float(loss),
                  "gnorm": float(global_norm(grads))}
        del grads
    a, b = res[dev], res[cpu]
    rel = {k: abs(a[k] - b[k]) / abs(b[k]) for k in ("loss", "gnorm")}
    print(f"13(e) gemma-2b 1 layer f32 B=2 S=64: card loss {a['loss']} "
          f"gnorm {a['gnorm']}, CPU loss {b['loss']} gnorm {b['gnorm']}, "
          f"relative {rel}", flush=True)
    require(all(v <= DEVICE_TOL for v in rel.values()),
            f"13(e): card and CPU part beyond {DEVICE_TOL}: {rel}")
    del res, a, b
    free_cuda()
    families = {}
    mesh_cfg = MeshConfig(shape=(1,), axis_names=("data",))
    for arch in ARCH_NAMES:
        if arch == "gemma-2b":
            continue
        scfg = get_smoke_config(arch)
        seq = 32 + (scfg.num_frontend_tokens
                    if scfg.frontend == "patch_stub" else 0)
        pipe = SyntheticPipeline(scfg, batch=4, seq_len=seq, seed=0)
        losses, start = {}, None
        for d in (dev, cpu):
            model = build_model(scfg, ServeConfig(), device=d, train=tcfg)
            params = (model.init(0) if d == dev else
                      tree_map(lambda t: t.cpu(), start))
            if d == dev:
                start = tree_map(torch.clone, params)
            state = TrainState(params, adamw_init(params))
            step = make_train_step(model, mesh_cfg, tcfg)
            losses[d] = []
            for i in range(2):
                state, met = step(state, {
                    k: torch.as_tensor(v, device=d)
                    for k, v in pipe.get_batch(i).items()})
                losses[d].append(float(met["loss"]))
        ok = all(math.isfinite(x) for x in losses[dev]) and all(
            abs(x - y) <= DEVICE_TOL * max(1.0, abs(y))
            for x, y in zip(losses[dev], losses[cpu]))
        families[arch] = {"card": losses[dev], "cpu": losses[cpu]}
        print(f"13(e) {scfg.name}: 2 spmd steps f32, card {losses[dev]}, "
              f"CPU {losses[cpu]}", flush=True)
        require(ok, f"13(e) {arch}: card losses {losses[dev]} against the "
                f"CPU's {losses[cpu]} beyond {DEVICE_TOL}")
    free_cuda()
    return {"gemma_1_layer": rel, "families": families}


#: 13(f): gemma-2b at full width and depth at the train_4k cell's
#: sequence, B=4 (reckoned: the state's 35.1 GB and the dry run's 17.7 GB
#: of temporaries, ~53 GB in all)
TRAIN_4K_BATCH, TRAIN_4K_STEPS = 4, 3
#: 13(f)'s measured temporaries over the dry run's prediction, each
#: step, its baseline read with no collection. LiveBytes counts the
#: storages the step creates, as the caching allocator allocates them:
#: on an H100 a warm card's steps read 1.0000002 (the allocator's 512-B
#: rounding) and step 1, from a cold card, 1.0038 (64 MiB of a workspace
#: its first products allocate, which a trace on meta cannot see). 2%
#: (355 MB) holds both and fails a temporaries' model that lost or
#: gained a working set of that size, or a baseline that still holds
#: the previous step's gradients (0.7173 before they were freed by
#: reference counting).
TRAIN_4K_TEMP_BAND = (0.98, 1.02)


def train_4k_chunked(dev):
    """13(f): gemma-2b at full width and depth in bf16 trains at the
    train_4k shape through the chunked attention: ``make_train_step`` /
    ``init_train_state`` with the knobs ``dryrun.train_knobs`` gives a
    one-device train_4k cell (remat, ``attn_chunk_threshold`` 2048,
    ``attn_chunk`` 512, ``attn_chunk_kv`` 2048, ``loss_chunk`` 512, one
    microbatch), parameters from seed 0, B=4 at S=4096, 3 steps. Every
    loss finite; each layer's attention is the chunked one (two calls a
    layer a step: the forward and remat's recompute). The steps run with
    the collector off. Each step's own temporaries (its peak less the
    bytes allocated before it, read with no collection) against the dry
    run's prediction for the same cell, traced on meta; after each step
    the bytes allocated beyond the phase's start and the state under
    ``HELD_GATE``, and the collector, run once after the loop, frees
    under ``HELD_GATE``."""
    import dataclasses

    from repro_torch.config import MESHES, SHAPES, ServeConfig, TrainConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.serve import arch_config
    from repro_torch.models import layers as L
    from repro_torch.models.registry import build_model, make_synthetic_batch
    from repro_torch.train.trainer import init_train_state, make_train_step
    free_cuda()
    outside = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    cfg = arch_config("gemma-2b")
    shape = SHAPES["train_4k"]
    one = dataclasses.replace(MESHES["single_pod"], shape=(1, 1))
    tcfg = TrainConfig(**dryrun.train_knobs(
        cfg, shape, one, extra_train_kwargs={"microbatches": 1}))
    require((tcfg.remat, tcfg.attn_chunk_threshold, tcfg.attn_chunk,
             tcfg.attn_chunk_kv, tcfg.loss_chunk, tcfg.microbatches)
            == (True, 2048, 512, 2048, 512, 1),
            f"13(f): the one-device train_4k knobs are {tcfg}")
    B, S = TRAIN_4K_BATCH, shape.seq_len
    points = dryrun.trace_counts(cfg, shape, tcfg, ServeConfig(), None, B)
    predicted = dryrun.temp_bytes(cfg, shape, points, B, tp=1,
                                  seq_parallel=False)
    model = build_model(cfg, ServeConfig(), device=dev, train=tcfg)
    state = init_train_state(model, 0)
    step = make_train_step(model, None, tcfg)
    batches = [make_synthetic_batch(cfg, B, seq_len=S, seed=i,
                                    compute_dtype=tcfg.compute_dtype,
                                    device=dev)
               for i in range(TRAIN_4K_STEPS)]
    chunked = L.chunked_attention
    calls = [0]

    def counted(*args, **kw):
        calls[0] += 1
        return chunked(*args, **kw)

    losses, ms, temps, peaks, held = [], [], [], [], []
    L.chunked_attention = counted
    try:
        with collector_off():
            for batch in batches:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                before = torch.cuda.memory_allocated(dev)
                t1 = time.perf_counter()
                state, met = step(state, batch)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t1))
                peaks.append(torch.cuda.max_memory_allocated(dev))
                temps.append(peaks[-1] - before)
                held.append(torch.cuda.memory_allocated(dev) - outside
                            - state_bytes(state))
                losses.append(float(met["loss"]))
            last = torch.cuda.memory_allocated(dev)
    finally:
        L.chunked_attention = chunked
    gc.collect()
    torch.cuda.synchronize()
    collected = last - torch.cuda.memory_allocated(dev)
    require(all(math.isfinite(x) for x in losses),
            f"13(f): a loss is not finite: {losses}")
    want = 2 * cfg.num_layers * TRAIN_4K_STEPS
    require(calls[0] == want,
            f"13(f): chunked_attention ran {calls[0]} times, not {want}")
    med = statistics.median(ms)
    ratios = [t / predicted for t in temps]
    out = {"batch": B, "seq": S, "losses": losses, "step_ms": ms,
           "median_step_ms": med, "tokens_per_s": B * S / med * 1e3,
           "max_memory_allocated": max(peaks), "temp_bytes": temps,
           "predicted_temp_bytes": predicted,
           "attn_peak_bytes": points["attn_peak"],
           "measured_over_predicted": ratios, "chunked_calls": calls[0],
           "state_bytes": state_bytes(state), "held_beyond_state": held,
           "collected_after_loop": collected,
           "seconds": time.perf_counter() - t0}
    print(f"13(f) gemma-2b {cfg.num_layers} layers bf16 train_4k B={B} "
          f"S={S}: losses "
          f"{losses}; steps {ms} ms (host wall clock, synchronised), "
          f"median {med:.3f} ms, {out['tokens_per_s']:.1f} tokens/s; "
          f"peak {max(peaks)} bytes allocated; the steps' temporaries "
          f"{temps} bytes against the dry run's {predicted:.0f} "
          f"(attention alone {points['attn_peak']}): ratios {ratios}; "
          f"chunked_attention calls {calls[0]}; {out['seconds']:.1f} s",
          flush=True)
    print(f"13(f) held after each step beyond the phase's start and the "
          f"state ({out['state_bytes']} bytes): {held} bytes; the "
          f"collector freed {collected} bytes after the loop (gate "
          f"{HELD_GATE})", flush=True)
    require(all(h < HELD_GATE for h in held),
            f"13(f): a step left {held} bytes beyond the state, over "
            f"{HELD_GATE}")
    require(collected < HELD_GATE,
            f"13(f): the collector freed {collected} bytes after the "
            f"loop, over {HELD_GATE}")
    lo, hi = TRAIN_4K_TEMP_BAND
    require(all(lo <= r <= hi for r in ratios),
            f"13(f): measured temporaries over the dry run's {ratios} "
            f"outside {TRAIN_4K_TEMP_BAND}")
    del state, step, model, batches
    free_cuda()
    return out


def phase_train(dev):
    """Phase 13: the training path (see the module docstring)."""
    t0 = time.perf_counter()
    full = train_gemma_full(dev)
    runs, diffs = train_sync(dev)
    timer = Timer(dev)
    wire_row, wire_err = train_wire_kernel(dev, timer, runs["threadcomm"][
        "plen"])
    del timer
    resume = train_resume(dev, runs["threadcomm"].pop("kept"))
    devices = train_card_vs_cpu(dev)
    train_4k = train_4k_chunked(dev)
    launches = sum(runs["bf16_wire"]["one_copy"])
    out = {"a": full, "b": {
        m: {k: r[k] for k in ("losses", "one_copy", "step_ms", "peak",
                              "plen", "idle_share")}
        for m, r in runs.items()},
        "b_param_diffs": diffs, "d": resume, "e": devices, "f": train_4k,
        "seconds": time.perf_counter() - t0}
    print("train: " + json.dumps(out), flush=True)
    print(f"phase 13: {out['seconds']:.1f} s", flush=True)
    wire_row["launches_train_bf16_wire"] = launches
    wire_row["launches_train_bf16_wire_per_step"] = \
        runs["bf16_wire"]["one_copy"]
    return wire_row, wire_err, out["b"], out["a"]


# ---------------------------------------------------------------------------
# phase 14: analysis — the sanitizer armed on the card, the lint
# ---------------------------------------------------------------------------

#: the sanitizer's hooks, counted by :func:`arm` (``on_lease_alloc``
#: counts blocks, every other hook its calls)
SAN_HOOKS = ("on_request", "on_request_complete", "on_stream_enter",
             "on_finish", "on_lease_alloc", "on_lease_ref",
             "on_lease_release", "on_double_free", "on_pool_reset",
             "on_migrate_begin", "on_migrate_end")
#: 14(a)'s step clock: a request enters before the first fabric step
#: whose index reaches ``arrival * ANALYSIS_STEPS_PER_S``, so the armed
#: and the unarmed drive see the same arrivals whatever their speed
ANALYSIS_STEPS_PER_S = 100.0


def arm(strict=True):
    """Install a fresh sanitizer whose hooks also count their calls (the
    fabric's rank threads call them at once: the counts take a lock)."""
    import threading

    from repro_torch.analysis import sanitizer as S
    san = S.install(strict=strict)
    counts = dict.fromkeys(SAN_HOOKS, 0)
    lock = threading.Lock()
    for name in SAN_HOOKS:
        def hook(*a, _real=getattr(san, name), _name=name):
            with lock:
                counts[_name] += len(a[1]) if _name == "on_lease_alloc" \
                    else 1
            return _real(*a)
        setattr(san, name, hook)
    return san, counts


def analysis_fabric_drive(model, params, dev, armed):
    """Phase 12's disaggregated fabric (2 ranks of 4 rows, chunk 64 x 2,
    16-token blocks) built, warmed and driven on 16 requests of the mixed
    16/256 trace on the step clock, then closed (``strict``); under the
    strict sanitizer from construction to close when ``armed``. Returns
    the tokens, the drive's launch counts, its host wall clock, the
    migrations and the hook counts."""
    from repro_torch.analysis import sanitizer as S
    from repro_torch.launch import serve as launch
    from repro_torch.serve import ServingFabric, make_trace

    cfg, F = model.cfg, FABRIC
    san, counts = arm() if armed else (None, None)
    try:
        fab = ServingFabric(
            model, params, ranks=F["ranks"], placement="disagg",
            cache_len=max(F["prompt_len"]) + F["max_new"][1],
            slots_per_rank=F["slots"], prefill_chunk=F["prefill_chunk"],
            max_prefill_per_step=F["max_prefill_per_step"],
            block_size=F["block_size"], device=dev)
        try:
            launch._warm_fabric(fab, cfg, seed=0,
                                prompt_len=F["prompt_len"][0])
            trace = make_trace(F["requests"], prompt_len=F["prompt_len"],
                               max_new=F["max_new"], rate=F["rate"],
                               seed=F["seed"])
            reqs = sorted(launch.requests_from_trace(cfg, trace, seed=0),
                          key=lambda r: r.arrival)
            torch.cuda.synchronize()
            launch.reset_kernel_counters()
            t0 = time.perf_counter()
            i, step = 0, 0
            while i < len(reqs) or not fab.idle:
                while (i < len(reqs) and reqs[i].arrival
                       * ANALYSIS_STEPS_PER_S <= step):
                    fab.submit(reqs[i], float(step))
                    i += 1
                fab.step(float(step))
                step += 1
                require(step < 20_000, "14(a): the fabric did not drain")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = launch.kernel_counters()
            migrations = fab.transport.n_migrations
        finally:
            fab.close(strict=True)
        if armed:
            san.assert_clean()
            require(san.findings == [], f"14(a): findings {san.findings}")
    finally:
        S.uninstall()
    return {"tokens": [r.output[:r.generated].tolist() for r in reqs],
            "launches": launched, "wall_s": wall, "steps": step,
            "migrations": migrations, "hooks": counts}


def analysis_fabric(dev):
    """14(a): the disaggregated fabric unarmed, armed (strict), armed,
    unarmed, in float32 and bfloat16: every armed drive clean, every
    drive with the first one's tokens and launch counts; the hooks'
    counts and the four host wall clocks printed (in turns, so neither
    side always runs first)."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        free_cuda()
        model, params = build_family("gemma-2b", dev, dtype=dtype)
        runs = [analysis_fabric_drive(model, params, dev, armed=a)
                for a in (False, True, True, False)]
        del model, params
        plain, armed = runs[0], runs[1]
        for r in runs[1:]:
            require(r["tokens"] == plain["tokens"],
                    f"14(a) {dtype}: a drive's tokens differ from the first "
                    "unarmed drive's")
            require(r["launches"] == plain["launches"],
                    f"14(a) {dtype}: launches {r['launches']} against "
                    f"{plain['launches']} unarmed")
        h, k = armed["hooks"], armed["launches"]
        require(runs[2]["hooks"] == h, f"14(a) {dtype}: the armed drives' "
                f"hooks differ: {h} and {runs[2]['hooks']}")
        require(k["decode_launches"] > 0 and k["mq_launches"] > 0
                and k["ref_calls"] == 0,
                f"14(a) {dtype}: launches {k}")
        require(armed["migrations"] == FABRIC["requests"]
                and h["on_migrate_end"] == h["on_migrate_begin"]
                and h["on_request"] == h["on_request_complete"] > 0,
                f"14(a) {dtype}: {armed['migrations']} migrations, hooks {h}")
        walls = {"unarmed": [runs[0]["wall_s"], runs[3]["wall_s"]],
                 "armed": [runs[1]["wall_s"], runs[2]["wall_s"]]}
        ratio = statistics.mean(walls["armed"]) / statistics.mean(
            walls["unarmed"])
        print(f"14(a) {dtype}: armed (strict) disaggregated fabric clean, "
              f"assert_clean passed; tokens and launches equal the unarmed "
              f"run's (paged_decode x{k['decode_launches']}, paged_mq "
              f"x{k['mq_launches']}, no plain version); {armed['steps']} "
              f"steps; hooks from construction to close (the warm-up's "
              f"{2 * FABRIC['ranks']} requests too) {json.dumps(h)}; drive "
              f"wall clock (host, synchronised; unarmed, armed, armed, "
              f"unarmed) {runs[0]['wall_s']:.4f}, {runs[1]['wall_s']:.4f}, "
              f"{runs[2]['wall_s']:.4f}, {runs[3]['wall_s']:.4f} s: armed / "
              f"unarmed {ratio:.4f}", flush=True)
        out[dtype] = {"launches": k, "hooks": h, "steps": armed["steps"],
                      "wall_s": walls, "armed_over_unarmed": ratio}
    free_cuda()
    return out


def analysis_train(dev, phase13):
    """14(b): 13(b)'s explicit threadcomm trainer (gemma-2b widths at 2
    layers, float32, pod 2 x data 2 x model 1) under the strict
    sanitizer, 2 steps with each wire: clean; the losses of 13(b)'s
    unarmed runs (the same state and batches) within SYNC_TOL; the bf16
    wire launches ``msgq_one_copy`` once a step."""
    from repro_torch.analysis import sanitizer as S
    from repro_torch.config import MeshConfig
    from repro_torch.core.compat import make_mesh
    from repro_torch.kernels.msgq import ops as mq
    from repro_torch.train.explicit import init_explicit_state
    from repro_torch.train.trainer import make_train_step

    out = {}
    for wire, ref in (("float32", "threadcomm"), ("bfloat16", "bf16_wire")):
        free_cuda()
        model, tcfg = sync_model(dev, "threadcomm", wire)
        mesh_cfg = MeshConfig(shape=TRAIN_MESH[0], axis_names=TRAIN_MESH[1],
                              process_axes=("pod",))
        state = init_explicit_state(model, 0, dp=mesh_cfg.dp)
        batches = train_batches(model.cfg, dev, steps=2)
        san, counts = arm()
        try:
            step = make_train_step(model, mesh_cfg, tcfg, mesh=make_mesh(
                *TRAIN_MESH, device=dev))
            losses, launches = [], []
            for batch in batches:
                before = mq.one_copy_launches
                state, met = step(state, batch)
                losses.append(float(met["loss"]))
                launches.append(mq.one_copy_launches - before)
            step.comm.finish()
            san.assert_clean()
        finally:
            S.uninstall()
        want = phase13[ref]["losses"][:2]
        require(all(abs(a - b) <= SYNC_TOL + SYNC_TOL * abs(b)
                    for a, b in zip(losses, want)),
                f"14(b) {wire}: armed losses {losses} against 13(b)'s "
                f"{want}")
        require(launches == phase13[ref]["one_copy"][:2]
                and launches == ([1, 1] if wire == "bfloat16" else [0, 0]),
                f"14(b) {wire}: msgq_one_copy launches {launches}")
        require(counts["on_request"] == counts["on_request_complete"] == 2,
                f"14(b) {wire}: hooks {counts}")
        print(f"14(b) explicit trainer wire {wire}, armed (strict): clean; "
              f"losses {losses} (13(b) unarmed: {want}, bitwise "
              f"{losses == want}); msgq_one_copy a step {launches}; hooks "
              f"{json.dumps(counts)}", flush=True)
        out[wire] = {"losses": losses, "one_copy": launches,
                     "hooks": counts}
        del state, step, model, batches
    free_cuda()
    return out


def analysis_faults(dev):
    """14(c): seeded faults on the card, each giving exactly its finding:
    a Request on a CUDA CommStream never waited; the same op issued on one
    comm from two unordered streams; a double free; a migration
    interrupted mid-chain (gemma-2b's bf16 pool geometry)."""
    from repro_torch.analysis import sanitizer as S
    from repro_torch.core import threadcomm_init
    from repro_torch.core.comm import Request
    from repro_torch.core.compat import make_mesh
    from repro_torch.serve import (BlockPool, KVBlockTransport,
                                   PagedKVCache, SlotError)

    def root():
        comm = threadcomm_init(make_mesh((1,), ("serve",), device=dev),
                               process_axes=(), thread_axes=("serve",))
        comm.start()
        return comm

    def leaked_request():
        comm = root()
        with comm.stream("seeded") as s:
            req = Request(comm, "isend", torch.ones(4, device=dev),
                          stream=s)
        require(req._event is not None and s._cuda is not None,
                "14(c): the seeded request rode no CUDA stream and event")
        comm.finish()
        comm.free()

    def unordered_streams():
        comm = root()
        sub = comm.dup()

        def body(x):
            with comm.stream("a"):
                r1 = sub.iallreduce(x)
            with comm.stream("b"):
                r2 = sub.iallreduce(x)
            r1.wait()
            r2.wait()
            return x
        comm.run(body, torch.ones(1, device=dev))
        comm.finish()
        comm.free()

    def double_free():
        pool = BlockPool(8, 16)
        blocks = pool.alloc(2, "seeded")
        pool.free(blocks)
        try:
            pool.free(blocks)
        except SlotError as e:
            require("first freed at" in str(e), f"14(c): {e}")
        else:
            fail("14(c): the double free did not raise")

    def interrupted_migration():
        model, _ = build_family("gemma-2b", dev, layers=1)
        geo = dict(num_blocks=8, block_size=16, num_slots=2,
                   max_blocks_per_req=4)
        src, dst = PagedKVCache(model, **geo), PagedKVCache(model, **geo)
        comm = root()
        tp = KVBlockTransport(comm)
        real, calls = tp._copy_impl, [0]

        def bomb(*a):
            calls[0] += 1
            if calls[0] == 2:
                raise RuntimeError("seeded device loss")
            return real(*a)
        tp._copy_impl = bomb
        try:
            tp.migrate(src, dst, [0, 1, 2], [3, 4, 5])
        except RuntimeError as e:
            require("seeded" in str(e), f"14(c): {e}")
        else:
            fail("14(c): the seeded migration did not raise")
        comm.finish()
        comm.free()

    out = {}
    for name, fn, kind in (
            ("leaked_request", leaked_request, "unmatched-request"),
            ("unordered_streams", unordered_streams, "serialization-hazard"),
            ("double_free", double_free, "double-free"),
            ("interrupted_migration", interrupted_migration,
             "migration-incomplete")):
        san = S.install()
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            S.uninstall()
        kinds = [f.kind for f in san.findings]
        require(kinds == [kind], f"14(c) {name}: findings {kinds}, not "
                f"[{kind!r}]")
        print(f"14(c) {name}: exactly one {kind}: {san.findings[0]}",
              flush=True)
        out[name] = kind
    free_cuda()
    return out


def analysis_lint():
    """14(d): ``python -m repro_torch.analysis.lint`` over the port's
    package directory (its default) returns 0."""
    res = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint"],
                         capture_output=True, text=True, timeout=300,
                         check=False, cwd=str(ROOT),
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    require(res.returncode == 0 and res.stdout.startswith("clean:"),
            f"14(d): the lint returned {res.returncode}: {res.stdout}"
            f"{res.stderr}")
    print(f"14(d) python -m repro_torch.analysis.lint: "
          f"{res.stdout.strip()}", flush=True)
    return res.stdout.strip()


def phase_analysis(dev, phase13):
    """Phase 14: analysis (see the module docstring)."""
    t0 = time.perf_counter()
    out = {"a": analysis_fabric(dev), "b": analysis_train(dev, phase13),
           "c": analysis_faults(dev), "d": analysis_lint(),
           "seconds": time.perf_counter() - t0}
    print("analysis: " + json.dumps(out), flush=True)
    print(f"phase 14: {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 15: the roofline on the card's constants, the dry run at full
# width, the main path's steps against their bound, the examples
# ---------------------------------------------------------------------------

#: 15(b)'s cells, at full width on meta tensors (the reference test's
#: three among them: gemma-2b train_4k single_pod, mamba2-370m
#: decode_32k multi_pod, olmoe-1b-7b train_4k multi_pod)
DRYRUN_CELLS = ([("gemma-2b", s, m)
                 for s in ("train_4k", "prefill_32k", "decode_32k")
                 for m in ("single_pod", "multi_pod")]
                + [("mamba2-370m", "decode_32k", "multi_pod"),
                   ("mamba2-370m", "long_500k", "multi_pod"),
                   ("olmoe-1b-7b", "train_4k", "multi_pod")])
#: 15(b): the cell run in both of the reference's residual layouts
#: (``act_mode``), at full width
LAYOUT_CELL = ("gemma-2b", "train_4k", "single_pod")
#: 15(b): ``make_production_mesh``'s shape and axes, single and multi pod
PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}
#: a step's bound over its measured (or device-busy) time above this
#: fails: the count, not the step, would be wrong
SHARE_LIMIT = 1.05
#: 15(d): each example at its reference's size, in process; the serving
#: ones take gemma-2b's published widths on the card
#: (``examples.serving_config``: the paged and flash kernels are built
#: for head dims 64/128/256, the smoke config's is 32)
EXAMPLES = [("quickstart", [], "comm"), ("collectives_demo", [], "comm"),
            ("spmv_petsc", [], "comm"),
            ("serve_continuous", [], "serve"),
            ("serve_fabric", [], "serve"),
            ("train_lm", ["--steps", "20"], "train")]


def roofline_constants(smi):
    """15(a): ``roofline.hw.H100`` beside what the card reports."""
    import dataclasses
    props = torch.cuda.get_device_properties(0)
    card = {"name": props.name, "total_memory": props.total_memory,
            "sms": props.multi_processor_count,
            "smem_per_block_optin": getattr(
                props, "shared_memory_per_block_optin", None),
            "smem_per_sm": getattr(props, "shared_memory_per_multiprocessor",
                                   None)}
    print(f"15(a) roofline.hw.H100: {dataclasses.asdict(H100)}", flush=True)
    print(f"15(a) the card: {smi}; {card}", flush=True)
    require(H100.hbm_bytes <= props.total_memory,
            f"15(a): H100.hbm_bytes {H100.hbm_bytes:.0f} exceeds the card's "
            f"{props.total_memory} bytes")
    return {"H100": dataclasses.asdict(H100), "card": card, "smi": smi}


def dryrun_cells():
    """15(b): the dry run's full-width cells through ``run_cell`` (meta
    tensors: nothing touches the card)."""
    from repro_torch.launch.dryrun import run_cell
    t0 = time.perf_counter()
    rows = []
    for arch, shape, mesh in DRYRUN_CELLS:
        res = run_cell(arch, shape, mesh, verbose=False)
        a = res["analysis"]
        require(a["terms"]["compute_s"] > 0 and a["counted"]["flops"] > 0,
                f"15(b) {arch} {shape} {mesh}: nothing counted")
        row = {"arch": arch, "shape": shape, "mesh": mesh,
               "terms": a["terms"], "dominant": a["dominant"],
               "fits_hbm": a["fits_hbm"],
               "live_bytes_per_device": a["live_bytes_per_device"],
               "counted_over_analytic": a["counted_over_analytic"],
               "mfu_at_bound": a.get("mfu_at_bound"),
               "collective_bytes": a["collectives"]["total"][
                   "operand_bytes"],
               "trace_s": res["timings"]["trace_s"]}
        rows.append(row)
        print(f"15(b) {arch} {shape} {mesh}: terms {a['terms']}, dominant "
              f"{a['dominant']}, fits_hbm {a['fits_hbm']} (live "
              f"{a['live_bytes_per_device']} B/device), counted/analytic "
              f"{a['counted_over_analytic']}, mfu@bound "
              f"{a.get('mfu_at_bound')}, trace {row['trace_s']:.2f} s",
              flush=True)
    layouts = dryrun_layouts()
    meshes = production_meshes()
    seconds = time.perf_counter() - t0
    print(f"15(b) dry run: {len(rows)} cells and {len(layouts)} layouts in "
          f"{seconds:.1f} s", flush=True)
    return {"cells": rows, "layouts": layouts, "meshes": meshes,
            "seconds": seconds}


def dryrun_layouts():
    """15(b): LAYOUT_CELL at full width in each residual layout through
    ``build_cell(act_mode=)`` and ``analyze_cell``: its collective operand
    bytes by op and its temporaries a device. Sequence parallelism must
    take the layout and shrink the temporaries."""
    from repro_torch.launch.dryrun import analyze_cell, build_cell
    rows = {}
    for mode in ("sp", "none"):
        trees, knobs, meta = build_cell(*LAYOUT_CELL, act_mode=mode)
        a = analyze_cell(trees, knobs, meta)["analysis"]
        by_op = {op: r["operand_bytes"]
                 for op, r in a["collectives"]["by_op"].items()}
        rows[mode] = {
            "seq_parallel": a["seq_parallel"],
            "microbatches": meta["microbatches"],
            "collective_bytes": a["collectives"]["total"]["operand_bytes"],
            "collective_bytes_by_op": by_op,
            "temp_bytes": a["memory_analysis"]["temp_size_in_bytes"],
            "dominant": a["dominant"], "terms": a["terms"],
            "mfu_at_bound": a.get("mfu_at_bound")}
        r = rows[mode]
        print(f"15(b) {' '.join(LAYOUT_CELL)} act_mode={mode}: "
              f"seq_parallel {r['seq_parallel']}, microbatches "
              f"{r['microbatches']}, collective operand bytes "
              f"{r['collective_bytes']} by op {by_op}, temp "
              f"{r['temp_bytes']} B/device, dominant {r['dominant']}, "
              f"mfu@bound {r['mfu_at_bound']}", flush=True)
    require(rows["sp"]["seq_parallel"] and not rows["none"]["seq_parallel"],
            f"15(b) {LAYOUT_CELL}: the layouts were not told apart")
    require(rows["sp"]["temp_bytes"] < rows["none"]["temp_bytes"],
            f"15(b) {LAYOUT_CELL}: sequence parallelism did not shrink the "
            f"temporaries: {rows['sp']['temp_bytes']} against "
            f"{rows['none']['temp_bytes']}")
    return rows


def production_meshes():
    """15(b): ``make_production_mesh`` on the card, its shape and axes."""
    from repro_torch.launch.mesh import make_production_mesh
    out = {}
    for multi_pod, want in PRODUCTION_MESHES.items():
        mesh = make_production_mesh(multi_pod=multi_pod)
        got = (tuple(mesh.devices.shape), mesh.axis_names)
        print(f"15(b) make_production_mesh(multi_pod={multi_pod}): {mesh}",
              flush=True)
        require(got == want and mesh.device.type == "cuda",
                f"15(b) make_production_mesh(multi_pod={multi_pod}): {got} "
                f"on {mesh.device}, not {want} on the card")
        out["multi_pod" if multi_pod else "single_pod"] = {
            "shape": list(got[0]), "axes": list(got[1]),
            "device": str(mesh.device)}
    return out


def step_against_bound(label, cfg, shape, step_ms, busy_ms, counted,
                       attn_flops):
    """A measured step beside two bounds on ``H100``: the analytic
    formulas' at its shape, and the step's own count (FlopCounterMode
    plus the ported kernels' attention, which it cannot see) with the
    formulas' bytes. The formula can price work the step does not do (a
    prefill's LM head at every prompt token), so the own count's share is
    the one to read. A share over SHARE_LIMIT fails."""
    from repro_torch.config import MeshConfig
    from repro_torch.roofline.flops import (cell_compute_flops,
                                            cell_memory_bytes)
    one_card = MeshConfig(shape=(1,), axis_names=("data",), model_axes=())
    comp = cell_compute_flops(cfg, shape)
    memb = cell_memory_bytes(
        cfg, shape, one_card,
        cache_len=shape.seq_len if shape.kind == "decode" else None)
    memory_ms = 1e3 * memb["bytes"] / H100.hbm_bw

    def bound(flops):
        compute_ms = 1e3 * flops / H100.peak_flops_bf16
        ms = max(compute_ms, memory_ms)
        return {"flops": flops, "compute_ms": compute_ms, "bound_ms": ms,
                "bound_by": "operations" if compute_ms >= memory_ms
                else "bytes", "share": ms / step_ms,
                "share_busy": ms / busy_ms if busy_ms else None}

    formula, own = bound(comp["computed"]), bound(counted + attn_flops)
    out = {"shape": {"seq_len": shape.seq_len, "batch": shape.global_batch,
                     "kind": shape.kind},
           "model_flops": comp["model_flops"], "bytes": memb["bytes"],
           "memory_ms": memory_ms, "step_ms": step_ms, "busy_ms": busy_ms,
           "formula": formula, "own_count": own, "flop_counter": counted,
           "kernel_attention_flops": attn_flops,
           "own_over_formula": (counted + attn_flops) / comp["computed"]}
    busy = busy_ms if busy_ms is not None else "not measured"
    print(f"15(c) {label}: {memb['bytes']:.6e} B, step {step_ms:.4f} ms "
          f"(host wall clock, synchronised, median), device busy {busy} "
          f"ms; FlopCounterMode {counted:.6e} flop (torch ops only: the "
          f"ctypes kernels' launches are invisible to it) + the ported "
          f"kernels' attention {attn_flops:.6e} flop (flops."
          f"_attention_score_flops, the full score rectangle) = "
          f"{counted + attn_flops:.6e}, {out['own_over_formula']:.4f} of "
          f"the formula's", flush=True)
    for name, b in (("formula", formula), ("own count", own)):
        print(f"15(c) {label}: {name} {b['flops']:.6e} flop -> bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}) on {H100.name}; "
              f"bound/step {b['share']:.4f}, bound/busy "
              f"{b['share_busy'] if busy_ms else 'not measured'}",
              flush=True)
        require(b["share"] <= SHARE_LIMIT
                and (b["share_busy"] is None
                     or b["share_busy"] <= SHARE_LIMIT),
                f"15(c) {label}: {name} bound / measured {b['share']} (busy "
                f"{b['share_busy']}) > {SHARE_LIMIT}: the count is wrong")
    return out


def main_path_steps(phase4, train_a):
    """15(c): phase 4's paged decode step (B=4) and static prefill (B=8,
    S=256), and phase 13(a)'s bf16 train step, each against its bound,
    from those phases' own records."""
    from repro_torch.config import ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.roofline.flops import _attention_score_flops

    cfg = get_config("gemma-2b")
    dec, pre = phase4["decode_step"], phase4["static_prefill_step"]
    rows = {}
    rows["paged_decode"] = step_against_bound(
        f"gemma-2b paged decode (B={dec['batch']}; phase 4)", cfg,
        ShapeConfig("paged_decode", dec["cache_len"], dec["batch"],
                    "decode"),
        dec["host_ms"], (phase4.get("decode_profile") or {}).get(
            "device_busy_ms"), dec["flop_count"],
        _attention_score_flops(cfg, 1, dec["cache_len"], dec["batch"]))
    rows["static_prefill"] = step_against_bound(
        f"gemma-2b static prefill (B={pre['batch']}, S={pre['seq_len']}; "
        "phase 4)", cfg,
        ShapeConfig("static_prefill", pre["seq_len"], pre["batch"],
                    "prefill"),
        pre["host_ms"], (phase4.get("static_prefill_profile") or {}).get(
            "device_busy_ms"), pre["flop_count"],
        _attention_score_flops(cfg, pre["seq_len"], pre["seq_len"],
                               pre["batch"]))
    rows["train_step"] = step_against_bound(
        "gemma-2b bf16 train step (B=8, S=128, 18 layers; 13(a))", cfg,
        ShapeConfig("train_step", TRAIN_SEQ, TRAIN_BATCH, "train"),
        train_a["median_step_ms"], train_a.get("device_busy_ms"),
        train_a.get("flop_count") or 0,
        # training never reaches the ported kernels (no backward)
        0.0)
    launches = phase4["launches"]
    print(f"15(c) phase 4's launches: {launches}", flush=True)
    for name in ("paged_decode", "paged_mq", "flash_attention"):
        require(launches[name] > 0, f"15(c): {name} was not launched")
    require(launches["plain_calls"] == 0,
            f"15(c): a plain version ran: {launches}")
    rows["launches"] = launches
    return rows


def examples_on_card():
    """15(d): each example's ``main`` in process on the card."""
    import importlib
    rows = {}
    for name, argv, kind in EXAMPLES:
        free_cuda()
        t0 = time.perf_counter()
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        out = mod.main(argv)
        k = out["kernels"]
        seconds = time.perf_counter() - t0
        print(f"15(d) {' '.join([name] + argv)}: checks {out['checks']}, "
              f"launches {k}, {seconds:.1f} s", flush=True)
        require(out["ok"], f"15(d) {name}: a check failed: {out['checks']}")
        require(k["plain_calls"] == 0,
                f"15(d) {name}: a plain version ran: {k}")
        if kind == "comm":
            require(k["msgq_eager"] + k["msgq_one_copy"] > 0,
                    f"15(d) {name}: no msgq kernel was launched")
        if kind == "serve":
            require(k["paged_decode"] > 0 and k["paged_mq"] > 0,
                    f"15(d) {name}: the paged kernels were not launched")
        rows[name] = {"kernels": k, "checks": out["checks"],
                      "seconds": seconds}
    return rows


def phase_roofline(smi, phase4, train_a):
    """Phase 15 (see the module docstring)."""
    t0 = time.perf_counter()
    out = {"a": roofline_constants(smi), "b": dryrun_cells(),
           "c": main_path_steps(phase4, train_a),
           "d": examples_on_card()}
    out["seconds"] = time.perf_counter() - t0
    print("roofline: " + json.dumps(out, default=str), flush=True)
    print(f"phase 15: {out['seconds']:.1f} s", flush=True)
    return out


def main() -> None:
    require(torch.cuda.is_available(), "no CUDA device is available")
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
    spills = {}
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
            if "bytes spill stores" in line:
                spills[name] = spills.get(name, 0) + int(
                    line.split("bytes spill stores")[0].split()[-1])
    print("ptxas spill store bytes by source: " + json.dumps(spills),
          flush=True)

    timer = Timer(dev)
    table = phase_kernels(dev, timer)
    table["flash_attention"] = phase_flash(dev, timer)
    table["moe_experts"] = phase_moe(dev, timer)
    del timer
    torch.cuda.empty_cache()
    model = phase_model(dev)
    _, serve_counts = phase_serve()
    torch.cuda.empty_cache()
    _, counts = phase_engines()
    torch.cuda.empty_cache()
    table.update(phase_threadcomm(dev))
    torch.cuda.empty_cache()
    table["ssd_scan"], family_launches = phase_families(dev)
    torch.cuda.empty_cache()
    verify_err, verify_times, spec_runs, ring = phase_spec_prefix_ring(dev)
    torch.cuda.empty_cache()
    family_table, _ = phase_model_families(dev)
    torch.cuda.empty_cache()
    comm_obs = phase_comm_obs(dev)
    torch.cuda.empty_cache()
    fabric = phase_fabric(dev)
    torch.cuda.empty_cache()
    train_row, train_err, train_runs, train_full = phase_train(dev)
    torch.cuda.empty_cache()
    analysis = phase_analysis(dev, train_runs)
    torch.cuda.empty_cache()
    roofline = phase_roofline(smi, model, train_full)

    # launches: the --engine both run, which drives all three kernels;
    # the paged serve phase's own counts stand beside them
    table["paged_decode"]["launches"] = counts["decode_launches"]
    table["paged_mq"]["launches"] = counts["mq_launches"]
    table["flash_attention"]["launches"] = counts["flash_launches"]
    table["paged_decode"]["launches_paged_serve"] = \
        serve_counts["decode_launches"]
    table["paged_mq"]["launches_paged_serve"] = serve_counts["mq_launches"]
    # hymba's runs in phase 8 drive the three attention kernels too
    hymba = [c for k, c in family_launches.items() if k.startswith("hymba")]
    for name, key in (("paged_decode", "decode_launches"),
                      ("paged_mq", "mq_launches"),
                      ("flash_attention", "flash_launches")):
        table[name]["launches_hymba"] = sum(c[key] for c in hymba)
    # phase 9: the verify and resync shapes, and the launches of the
    # speculative arm (bf16, the serving dtype; f32 beside it)
    table["paged_mq"]["max_abs_err"] = max(table["paged_mq"]["max_abs_err"],
                                           verify_err)
    table["paged_mq"]["verify_times"] = verify_times
    for dt, spec in spec_runs.items():
        sfx = "" if dt == "bfloat16" else "_f32"
        table["paged_mq"]["launches_verify" + sfx] = spec["launches_verify"]
        table["paged_mq"]["launches_resync" + sfx] = spec["launches_resync"]
        table["paged_decode"]["launches_draft" + sfx] = \
            spec["launches_draft"]
    table["flash_attention"]["launches_ring"] = \
        ring["run_traffic"]["kernels"]["flash_launches"]
    table["ssd_scan"]["launches_ring"] = \
        ring["run_traffic"]["kernels"]["ssd_launches"]
    # phase 10: the families' shapes (hd 128, non-causal flash) and the
    # launches of their runs
    for name, add in family_table.items():
        table[name]["max_abs_err"] = max(table[name]["max_abs_err"],
                                         add.pop("max_abs_err"))
        table[name].update(add)
    # phase 11: the bound engine's launches (plain, then speculate=3)
    # and the traced run_traffic's
    table["paged_decode"]["launches_comm_bound"] = \
        comm_obs["bound"]["decode_launches"]
    table["paged_mq"]["launches_comm_bound"] = \
        comm_obs["bound"]["mq_launches"]
    table["paged_decode"]["launches_comm_bound_spec"] = \
        comm_obs["bound_spec"]["decode_launches"]
    table["paged_mq"]["launches_comm_bound_spec"] = \
        comm_obs["bound_spec"]["mq_launches"]
    traced = comm_obs["traffic"]["launches_traced"]
    for name, key in (("paged_decode", "decode_launches"),
                      ("paged_mq", "mq_launches"),
                      ("flash_attention", "flash_launches")):
        table[name]["launches_traced"] = traced[key]
    # phase 12: the traced disaggregated fabric's launches (float32) and
    # each bf16 fabric drive's, every one counted from zero just before it
    for name, key in (("paged_decode", "decode_launches"),
                      ("paged_mq", "mq_launches")):
        table[name]["launches_fabric_disagg"] = fabric["b"][key]
        for p in ("replicated", "disagg"):
            table[name][f"launches_fabric_bf16_{p}"] = \
                fabric["bf16"]["kernels"][p][key]
    # phase 13: the training path's bf16-wire launches (one round a step)
    # and the kernel at its wire message
    table["msgq_one_copy"]["max_abs_err"] = max(
        table["msgq_one_copy"]["max_abs_err"], train_err)
    table["msgq_one_copy"].update(train_row)
    # phase 14: the armed fabric's launches (each dtype's armed drive,
    # equal to its unarmed one) and the armed trainer's bf16 wire
    for name, key in (("paged_decode", "decode_launches"),
                      ("paged_mq", "mq_launches")):
        for dt, sfx in (("float32", "f32"), ("bfloat16", "bf16")):
            table[name][f"launches_analysis_fabric_{sfx}"] = \
                analysis["a"][dt]["launches"][key]
    table["msgq_one_copy"]["launches_analysis_train_bf16_wire"] = \
        sum(analysis["b"]["bfloat16"]["one_copy"])
    # phase 4's kernel path, whose steps 15(c) holds to their bound, and
    # each example's launches in 15(d)
    for name in ("paged_decode", "paged_mq", "flash_attention"):
        table[name]["launches_phase4"] = roofline["c"]["launches"][name]
    for name in ("paged_decode", "paged_mq", "flash_attention",
                 "msgq_eager", "msgq_one_copy", "ssd_scan"):
        table[name]["launches_examples"] = {
            ex: row["kernels"][name]
            for ex, row in roofline["d"].items() if row["kernels"][name]}
    print("model: " + json.dumps(model), flush=True)
    print(json.dumps({"kernels": list(table.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
