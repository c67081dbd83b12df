"""Continuous-batching request scheduler: bounded cell-queue admission
(paper §3.2 recast as serving admission control) — the port of the
reference's ``serve/scheduler.py``: admission, paged pricing, the
prefix-cache repricing and the speculative-decoding accounting.

A request's prompt is its message (``nbytes = prompt tokens x
itemsize``), classified by :func:`repro_torch.core.protocol.
select_protocol`: eager-class prompts are buffered into the bounded cell
queue on submit; rendezvous-class prompts wait in a deferral queue until
a row is free and every buffered request ahead of them has drained;
eager submissions that find the cells full overflow and are promoted back
as cells free. Admission priority is cells -> promoted overflow ->
rendezvous, FIFO within each class.

Per-request arrival/admit/first-token/finish times are stamped on the
:class:`ServeRequest` itself. :func:`make_trace` draws from numpy in the
reference's order, so one seed gives the reference's trace (Poisson,
burst or all-at-once arrivals, sampling temperatures, shared prefix
groups).
The scheduler keeps every request of the trial in ``req_log`` (by rid;
the serving fabric's router census reads it), and :func:`shard_trace`
deals a trace to data-parallel replicas.

Telemetry (``REPRO_TRACE=1``, :mod:`repro_torch.obs`): ``admit`` and
``defer`` instants, the ``sched.admitted`` counter and
``sched.queue_depth`` gauge at each admission, and the ``tokens_out``
counter and ``latency_s`` / ``ttft_s`` histograms at each finish; off,
each site is one global read and a ``None`` check.
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch.core import protocol
from repro_torch.obs.metrics import active as _reg_active
from repro_torch.obs.trace import active as _tr_active

#: scheduler classes mapped from the protocol model
EAGER_CLASS = ("eager_fast", "eager")


@dataclass
class ServeRequest:
    """One generation request plus its lifecycle accounting."""
    rid: int
    batch: Dict[str, np.ndarray]          # model inputs, leading dim 1
    max_new_tokens: int
    temperature: float = 0.0
    seed: int = 0
    arrival: float = 0.0                  # trace arrival time (seconds)

    # -- stamped by the scheduler / engine --
    protocol: str = ""
    nbytes: int = 0
    cells: int = 0
    admit_cost_s: float = 0.0             # protocol-model admission price
    # lifecycle: queued -> prefilling -> decoding -> done; a prefill
    # rank's request is "migrating" between its first token and its
    # import on a decode rank
    state: str = "queued"
    prefill_chunks: int = 0               # chunk dispatches this rode in
    prefix_hit_tokens: int = 0            # prompt tokens served from the
                                          # radix prefix cache (no prefill)
    # -- stamped by the serving fabric --
    rank: int = -1                        # engine rank that served/prefilled
    decode_rank: int = -1                 # disagg: rank that decoded
    kv_migration_s: float = 0.0           # modeled KV-handoff latency
    kv_blocks_moved: int = 0              # blocks migrated for this request
    submit_time: Optional[float] = None
    admit_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    output: Optional[np.ndarray] = None   # (max_new_tokens,) int32
    generated: int = 0

    @property
    def prompt_len(self) -> int:
        return int(self.batch["tokens"].shape[1])

    @property
    def latency(self) -> float:
        if self.finish_time is None:
            raise ValueError(f"request {self.rid} not finished")
        return self.finish_time - self.arrival

    @property
    def queue_delay(self) -> float:
        if self.admit_time is None:
            raise ValueError(f"request {self.rid} not admitted")
        return self.admit_time - (self.submit_time
                                  if self.submit_time is not None
                                  else self.arrival)

    @property
    def ttft(self) -> float:
        """Time to first token, from trace arrival."""
        if self.first_token_time is None:
            raise ValueError(f"request {self.rid} has no first token yet")
        return self.first_token_time - self.arrival


class CellQueueScheduler:
    """Bounded cell-pool admission queue with rendezvous deferral."""

    def __init__(self, num_cells: int = 16,
                 cell_size: int = protocol.DEFAULT_CELL_SIZE,
                 itemsize: int = 4, prefill_chunk_bytes: int = 0,
                 block_bytes: int = 0, state_bytes: int = 0):
        if num_cells < 1:
            raise ValueError("need at least one cell")
        self.num_cells = int(num_cells)
        self.cell_size = int(cell_size)
        self.itemsize = int(itemsize)
        # the SAME HostModel (same cell) classifies and prices
        self.host_model = protocol.HostModel(cell=int(cell_size))
        # >0: prompts larger than a chunk stream in chunk by chunk and are
        # priced as chunked handoffs
        self.prefill_chunk_bytes = int(prefill_chunk_bytes)
        # >0: the deposit target is a paged pool — chunked prompts pay the
        # per-block table surcharge on top of the chunked handoff
        self.block_bytes = int(block_bytes)
        # >0: the model carries per-request non-KV state (SSM/hybrid
        # recurrent state) of this many bytes per row; each admission pays
        # one extra interthread handoff for installing it, priced once in
        # _classify
        self.state_bytes = int(state_bytes)
        self._state_cost_s = (
            protocol.interthread_latency(self.state_bytes, self.host_model)
            if self.state_bytes > 0 else 0.0)
        self.cells_free = int(num_cells)
        self._cellq: Deque[ServeRequest] = deque()      # buffered (eager)
        self._overflow: Deque[ServeRequest] = deque()   # eager, pool full
        self._rendezvous: Deque[ServeRequest] = deque() # 1-copy sized
        self.finished: List[ServeRequest] = []
        # every request submitted this trial, keyed by rid: the fabric's
        # router reads its dispatch-hop scheduler's log (in-flight
        # census, arrival span). rids restart at 0 every trial, so reset
        # clears it: a warm-up entry would alias the next trial's request
        self.req_log: Dict[int, ServeRequest] = {}
        self.n_submitted = 0
        self.n_eager_admits = 0       # buffered straight into cells
        self.n_deferred = 0           # overflow + rendezvous submissions
        self.n_block_deferrals = 0    # admissions stalled on free blocks
        self.modeled_admit_cost_s = 0.0
        self._zero_feature_counters()

    def _zero_feature_counters(self) -> None:
        # prefix-cache repricing: hits replace the full admission price
        # with the table-lease walk
        self.n_prefix_hits = 0
        self.prefix_tokens_saved = 0
        self.modeled_prefix_hit_cost_s = 0.0
        # speculative decoding: one dispatch per live row per verify
        # round; accepted counts the tokens each dispatch emitted
        self.n_spec_dispatches = 0
        self.spec_accepted_tokens = 0
        self.spec_drafted_tokens = 0
        self.spec_matched_tokens = 0
        self.spec_modeled_cost_s = 0.0

    def reset(self) -> None:
        """Drop all queued/finished requests and zero the accounting (the
        queue configuration is kept)."""
        self.cells_free = self.num_cells
        self._cellq.clear()
        self._overflow.clear()
        self._rendezvous.clear()
        self.finished = []
        self.req_log.clear()
        self.n_submitted = 0
        self.n_eager_admits = 0
        self.n_deferred = 0
        self.n_block_deferrals = 0
        self.modeled_admit_cost_s = 0.0
        self._zero_feature_counters()

    # -- classification ----------------------------------------------------
    def _price(self, nbytes: int, proto: str) -> float:
        """Protocol-model admission price, matching what the engine does
        with the prompt: a prompt larger than one chunk streams in and
        pays the chunked (paged) handoff; one that fits a chunk keeps its
        eager/1-copy price."""
        if 0 < self.prefill_chunk_bytes < nbytes:
            if self.block_bytes > 0:
                return protocol.paged_admission_latency(
                    nbytes, self.prefill_chunk_bytes, self.block_bytes,
                    self.host_model)
            return protocol.chunked_handoff_latency(
                nbytes, self.prefill_chunk_bytes, self.host_model)
        return protocol.interthread_latency(nbytes, self.host_model,
                                            proto=proto)

    def _classify(self, req: ServeRequest, now: float) -> str:
        req.submit_time = now
        req.nbytes = int(req.batch["tokens"].size) * self.itemsize
        req.protocol = protocol.select_protocol(
            req.nbytes, interthread=True, cell=self.cell_size)
        req.admit_cost_s = (self._price(req.nbytes, req.protocol)
                            + self._state_cost_s)
        req.cells = (max(1, math.ceil(req.nbytes / self.cell_size))
                     if req.protocol in EAGER_CLASS else 0)
        self.modeled_admit_cost_s += req.admit_cost_s
        return req.protocol

    def reprice_prefix(self, req: ServeRequest, hit_tokens: int,
                       cow_blocks: int = 0) -> float:
        """Re-price an admission whose prompt prefix came from the radix
        cache: the hit tokens cost a trie walk and a table-lease envelope
        per block (and a block copy per CoW clone,
        :func:`repro_torch.core.protocol.prefix_hit_latency`); only the
        miss suffix still pays the chunked/paged deposit. Replaces
        ``req.admit_cost_s``, patches ``modeled_admit_cost_s`` (the full
        price was added at submit) and returns the new price."""
        hit_bytes = int(hit_tokens) * self.itemsize
        miss_bytes = max(0, req.nbytes - hit_bytes)
        bb = self.block_bytes if self.block_bytes > 0 else self.cell_size
        new_cost = protocol.prefix_hit_latency(
            hit_bytes, bb, self.host_model, cow_blocks=cow_blocks)
        if miss_bytes > 0:
            new_cost += self._price(miss_bytes, req.protocol)
        new_cost += self._state_cost_s
        self.modeled_admit_cost_s += new_cost - req.admit_cost_s
        self.modeled_prefix_hit_cost_s += new_cost
        self.n_prefix_hits += 1
        self.prefix_tokens_saved += int(hit_tokens)
        req.admit_cost_s = new_cost
        req.prefix_hit_tokens = int(hit_tokens)
        return new_cost

    # -- submission --------------------------------------------------------
    def submit(self, req: ServeRequest, now: float = 0.0) -> str:
        """Queue a request; returns the queue it landed in
        (``"cells" | "overflow" | "rendezvous"``)."""
        proto = self._classify(req, now)
        self.n_submitted += 1
        self.req_log[req.rid] = req
        req.state = "queued"
        if proto in EAGER_CLASS and req.cells <= self.num_cells:
            if req.cells <= self.cells_free:
                self.cells_free -= req.cells
                self._cellq.append(req)
                self.n_eager_admits += 1
                return "cells"
            self._overflow.append(req)
            self.n_deferred += 1
            return "overflow"
        if proto in EAGER_CLASS:
            # eager prompts that could never fit the cell pool re-route to
            # the rendezvous discipline, and their accounting says so
            self.modeled_admit_cost_s -= req.admit_cost_s
            req.protocol = "one_copy"
            req.admit_cost_s = (self._price(req.nbytes, "one_copy")
                                + self._state_cost_s)
            self.modeled_admit_cost_s += req.admit_cost_s
        req.cells = 0
        self._rendezvous.append(req)
        self.n_deferred += 1
        return "rendezvous"

    def _promote(self) -> None:
        """Refill freed cells from the overflow queue (FIFO)."""
        while self._overflow and self._overflow[0].cells <= self.cells_free:
            req = self._overflow.popleft()
            self.cells_free -= req.cells
            self._cellq.append(req)

    # -- admission ---------------------------------------------------------
    def admit(self, now: float, free_slots: int,
              can_admit=None) -> List[ServeRequest]:
        """Hand over up to ``free_slots`` requests for prefill, priority
        cells -> promoted overflow -> rendezvous. ``can_admit(req)`` is the
        engine's second gate (free blocks); admission is head-of-line
        within the priority order."""
        out: List[ServeRequest] = []
        tr = _tr_active()
        while free_slots > 0:
            if self._cellq:
                queue = self._cellq
            elif self._rendezvous:
                queue = self._rendezvous
            else:
                break
            req = queue[0]
            if can_admit is not None and not can_admit(req):
                self.n_block_deferrals += 1
                if tr is not None:
                    tr.instant("defer", cat="sched", rid=req.rid,
                               reason="blocks")
                break
            queue.popleft()
            if queue is self._cellq:
                self.cells_free += req.cells
                self._promote()
            req.admit_time = now
            out.append(req)
            if tr is not None:
                tr.instant("admit", cat="sched", rid=req.rid,
                           protocol=req.protocol)
            free_slots -= 1
        reg = _reg_active()
        if reg is not None:
            if out:
                reg.counter("sched.admitted").inc(len(out))
            reg.gauge("sched.queue_depth").set(self.num_waiting)
        return out

    def record_spec_dispatch(self, accepted: int, drafted: int,
                             matched: int, cost_s: float) -> None:
        """Account one row's draft-verify round: ``accepted`` tokens it
        emitted (matched draft prefix + the target's own token),
        ``drafted`` tokens proposed, ``matched`` of them accepted, and
        the round's protocol price
        (:func:`repro_torch.core.protocol.speculative_verify_latency`)."""
        self.n_spec_dispatches += 1
        self.spec_accepted_tokens += int(accepted)
        self.spec_drafted_tokens += int(drafted)
        self.spec_matched_tokens += int(matched)
        self.spec_modeled_cost_s += float(cost_s)

    def spec_stats(self) -> Dict[str, float]:
        """Speculative accounting rows; zeros when speculation is off."""
        d = max(1, self.n_spec_dispatches)
        return {
            "spec_dispatches": float(self.n_spec_dispatches),
            "spec_accepted_tokens": float(self.spec_accepted_tokens),
            "spec_drafted_tokens": float(self.spec_drafted_tokens),
            "accepted_per_dispatch": self.spec_accepted_tokens / d,
            "acceptance_rate": (
                self.spec_matched_tokens / self.spec_drafted_tokens
                if self.spec_drafted_tokens else 0.0),
            "spec_modeled_cost_us": 1e6 * self.spec_modeled_cost_s,
        }

    # -- completion / stats ------------------------------------------------
    def record_finish(self, req: ServeRequest, now: float) -> None:
        req.finish_time = now
        req.state = "done"
        self.finished.append(req)
        reg = _reg_active()
        if reg is not None:
            reg.counter("tokens_out").inc(req.generated)
            reg.histogram("latency_s").observe(req.latency)
            if req.first_token_time is not None:
                reg.histogram("ttft_s").observe(req.ttft)

    @property
    def num_waiting(self) -> int:
        return len(self._cellq) + len(self._overflow) + len(self._rendezvous)

    def queue_depths(self) -> Dict[str, int]:
        return {"cells": len(self._cellq), "overflow": len(self._overflow),
                "rendezvous": len(self._rendezvous),
                "cells_free": self.cells_free}

    def latency_stats(self) -> Dict[str, float]:
        """Percentiles over finished requests (seconds)."""
        return latency_stats_over(self.finished)


def latency_stats_over(finished: List[ServeRequest]) -> Dict[str, float]:
    """Latency/TTFT percentiles over a finished-request collection."""
    if not finished:
        return {}
    lat = np.array([r.latency for r in finished])
    qd = np.array([r.queue_delay for r in finished])
    toks = int(sum(r.generated for r in finished))
    out = {
        "n": float(len(lat)),
        "latency_p50_s": float(np.percentile(lat, 50)),
        "latency_p95_s": float(np.percentile(lat, 95)),
        "latency_mean_s": float(lat.mean()),
        "queue_delay_p50_s": float(np.percentile(qd, 50)),
        "queue_delay_p95_s": float(np.percentile(qd, 95)),
        "tokens": float(toks),
    }
    ttft = np.array([r.ttft for r in finished
                     if r.first_token_time is not None])
    if ttft.size:
        out["ttft_p50_s"] = float(np.percentile(ttft, 50))
        out["ttft_p95_s"] = float(np.percentile(ttft, 95))
        out["ttft_mean_s"] = float(ttft.mean())
    return out


# ---------------------------------------------------------------------------
# Traffic traces
# ---------------------------------------------------------------------------

@dataclass
class TraceEntry:
    arrival: float
    max_new: int
    temperature: float = 0.0
    prompt_len: int = 0
    # shared-prefix workloads: requests of one group open with the same
    # ``prefix_len`` template tokens; -1 = an independent prompt
    prefix_group: int = -1
    prefix_len: int = 0


def make_trace(n_requests: int, *, prompt_len, max_new,
               arrival: str = "poisson", rate: float = 100.0,
               burst: int = 4, temperature: float = 0.0,
               shared_prefix_len: int = 0, share_ratio: float = 1.0,
               prefix_groups: int = 1,
               seed: int = 0) -> List[TraceEntry]:
    """Arrival trace: ``arrival`` is ``"poisson"`` (exponential gaps at
    ``rate`` req/s), ``"burst"`` (groups of ``burst`` at 1/rate spacing)
    or ``"all"`` (everything at t=0). Every entry samples at
    ``temperature`` (0 = greedy). ``max_new`` is an int or an inclusive
    ``(lo, hi)`` range sampled per request.
    ``prompt_len`` is an int or a sequence cycled across requests — e.g.
    ``(16, 256)``. ``shared_prefix_len > 0`` makes a shared-prefix trace:
    each request joins one of ``prefix_groups`` template families with
    probability ``share_ratio`` and opens with its first
    ``min(shared_prefix_len, prompt_len)`` tokens (the tokens themselves
    come from ``launch.serve.requests_from_trace``). The numpy draws
    follow the reference's order, so one seed gives the reference's
    trace."""
    rng = np.random.default_rng(seed)
    if arrival == "poisson":
        gaps = rng.exponential(1.0 / rate, size=n_requests)
        times = np.cumsum(gaps) - gaps[0]
    elif arrival == "burst":
        times = np.array([(i // burst) * (1.0 / rate)
                          for i in range(n_requests)])
    elif arrival == "all":
        times = np.zeros(n_requests)
    else:
        raise ValueError(f"unknown arrival kind {arrival!r} (poisson, "
                         "burst or all)")
    if isinstance(max_new, int):
        news = np.full(n_requests, max_new)
    else:
        lo, hi = max_new
        news = rng.integers(lo, hi + 1, size=n_requests)
    plens = ([int(prompt_len)] if isinstance(prompt_len, (int, np.integer))
             else [int(p) for p in prompt_len])
    out = [TraceEntry(arrival=float(times[i]), max_new=int(news[i]),
                      temperature=temperature,
                      prompt_len=plens[i % len(plens)])
           for i in range(n_requests)]
    if shared_prefix_len > 0:
        if not 0.0 <= share_ratio <= 1.0:
            raise ValueError(f"share_ratio {share_ratio} not in [0, 1]")
        if prefix_groups < 1:
            raise ValueError("need at least one prefix group")
        for e in out:
            # a 1-token prompt re-prefills its one token anyway: no group
            if e.prompt_len > 1 and rng.random() < share_ratio:
                e.prefix_group = int(rng.integers(prefix_groups))
                e.prefix_len = min(int(shared_prefix_len), e.prompt_len)
    return out


def shard_trace(trace: List[TraceEntry], replica: int,
                n_replicas: int, seed: Optional[int] = None
                ) -> List[TraceEntry]:
    """Data-parallel fan-out: the slice of the trace that replica
    ``replica`` of ``n_replicas`` serves. ``seed=None`` deals entry ``i``
    to replica ``i % n_replicas``; with a seed the entries are dealt
    through a seeded numpy permutation instead (the reference's draw), an
    exact partition still, decorrelated from any period of the trace
    (round robin hands every long prompt of a 16/256 interleave to one
    replica when ``n_replicas`` divides its cycle). Arrival order within
    a shard is kept."""
    if not 0 <= replica < n_replicas:
        raise ValueError(f"replica {replica} out of range({n_replicas})")
    if seed is None:
        return [e for i, e in enumerate(trace) if i % n_replicas == replica]
    perm = np.random.default_rng(seed).permutation(len(trace))
    mine = sorted(int(perm[j]) for j in range(replica, len(trace),
                                              n_replicas))
    return [trace[i] for i in mine]
