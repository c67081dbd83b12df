"""The serving fabric's router rank (the port of the reference's
``serve/fabric/router.py``).

``ServingFabric`` turns one ``ContinuousEngine`` into a multi-rank
serving fabric over the threadcomm substrate: a **router** that
classifies, prices and dispatches requests, and **N engine ranks**
(:class:`~repro_torch.serve.fabric.worker.EngineWorker`), each a paged
``ContinuousEngine`` bound to its own derived communication context.
Engine ranks come from the root threadcomm by ``split`` (one colour
class per engine rank when the comm is wide enough) and each rank's
context is a ``dup``: same group, fresh context, so one rank's
communication never orders against a peer's.

The router reuses the serving substrate's admission machinery for the
**dispatch hop**: new requests land in the router's
``CellQueueScheduler`` (bounded cells, eager/rendezvous classification,
protocol-model pricing: paper §3.2) and are dealt to engine ranks
join-shortest-queue by predicted cost as ranks have room. The placement
policy decides who is eligible (:mod:`~repro_torch.serve.fabric.
placement`):

* **replicated**: every rank a full replica, JSQ over all of them;
* **disaggregated**: prefill ranks deposit prompts, then the router's
  migrate hop moves each finished prefill's KV block by block to a
  decode rank through :class:`~repro_torch.serve.fabric.transport.
  KVBlockTransport` (request-based sends, ``waitall`` completion,
  ``protocol.kv_migration_latency`` pricing), handing the block lease
  off rather than recomputing the prefill.

Without a ``comm`` the fabric owns a one-rank threadcomm on the device
(``make_mesh((1,), ("serve",), device)``: one card is one device, as the
reference's local device count is one on one chip), so every engine rank
takes a ``dup`` of it. The ranks are host threads (a
``ThreadPoolExecutor``): each steps its own engine; dispatch and
migration stay on the router's thread. On the card every rank dispatches
on the device's current stream, the default one: a host sync in one
rank's step (the paged forward's ``_write_targets``, the token
read-back) waits for the other rank's queued work too, so on one card the
ranks are correct but largely serialised.
"""

from __future__ import annotations

import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import threadcomm_init
from repro_torch.core.compat import make_mesh
from repro_torch.obs import flush_trial as _obs_flush_trial
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import active as _tr_active
from repro_torch.serve.engine import ContinuousEngine
from repro_torch.serve.fabric.placement import Placement, make_placement
from repro_torch.serve.fabric.transport import KVBlockTransport
from repro_torch.serve.fabric.worker import EngineWorker
from repro_torch.serve.kv_cache import LeaseLeakError, LeaseLeakWarning
from repro_torch.serve.scheduler import (CellQueueScheduler, ServeRequest,
                                         latency_stats_over)


class ServingFabric:
    """Router + N engine ranks over one communication substrate.

    Drive it like an engine: ``submit(req, now)`` then ``step(now)``
    until ``idle``: the router dispatches, every rank advances one
    micro-step, and (disaggregated) finished prefills migrate. The
    constructor owns a started one-rank threadcomm on ``device`` unless
    ``comm`` (already started) is passed in; call :meth:`close` to
    finish and free an owned comm.
    """

    def __init__(self, model, params, *, ranks: int = 2,
                 placement="replicated", cache_len: int,
                 slots_per_rank: int = 4, eos_id: int = -1,
                 prefill_chunk: int = 64, max_prefill_per_step: int = 2,
                 block_size: int = 16,
                 blocks_per_rank: Optional[int] = None,
                 n_prefill_ranks: int = 1,
                 dispatch_window: Optional[int] = None,
                 speculate: int = 0, comm=None, device="cuda"):
        self.placement: Placement = (placement if isinstance(placement,
                                                             Placement)
                                     else make_placement(placement,
                                                         n_prefill_ranks))
        roles = self.placement.roles(ranks)
        self.ranks = int(ranks)
        # speculative ranks: every rank of a replicated placement runs
        # draft-verify rounds. Disaggregated placement is refused up
        # front: the drafter's twin pool never sees the prompt KV a
        # migration ships, so a decode rank could not draft (the engine
        # enforces role == "full" too)
        self.speculate = int(speculate)
        if self.speculate and self.placement.needs_migration:
            raise ValueError(
                "speculative decoding is not supported on disaggregated "
                "placements: the drafter's twin pool cannot receive the "
                "migrated prompt KV (use placement='replicated')")

        # capability gate: disaggregation migrates KV blocks between
        # ranks, which would strand any per-request carried state
        # (SSM/hybrid recurrent state, enc-dec cross K/V) at the prefill
        # rank: refuse up front, naming the capability
        caps = getattr(model, "capabilities", None)
        if (self.placement.needs_migration and caps is not None
                and not caps.kv_migration):
            raise ValueError(
                "model lacks capability 'kv_migration' — disaggregated "
                "placement migrates KV blocks between ranks, which would "
                "strand per-request carried state at the prefill rank: "
                + caps.reason)

        # -- substrate: root threadcomm + per-rank derived contexts --
        if comm is None:
            # one card is one device: a one-rank root, dup'd per rank
            mesh = make_mesh((1,), ("serve",), device)
            comm = threadcomm_init(mesh, process_axes=(),
                                   thread_axes=("serve",))
            comm.start()               # service-mode: finish at close()
            self._owns_comm = True
        else:
            self._owns_comm = False
        self.comm = comm
        subs = self._engine_comms(comm, ranks)

        #: JSQ backpressure: a rank above this load receives no new
        #: dispatches; excess requests wait in the router's cell queue
        #: (the bounded-buffer discipline of paper §3.2, one hop up)
        self.dispatch_window = (int(dispatch_window) if dispatch_window
                                else 2 * slots_per_rank)

        self.workers: List[EngineWorker] = []
        for i, role in enumerate(roles):
            eng = ContinuousEngine(
                model, params, cache_len=cache_len,
                num_slots=slots_per_rank, eos_id=eos_id, comm=subs[i],
                prefill_chunk=prefill_chunk,
                max_prefill_per_step=max_prefill_per_step,
                kv_layout="paged", block_size=block_size,
                num_blocks=blocks_per_rank, role=role,
                speculate=self.speculate if role == "full" else 0,
                device=device)
            self.workers.append(EngineWorker(i, role, eng, comm=subs[i]))
        #: the device every rank runs on
        self.device = self.workers[0].engine.device

        # -- the dispatch hop's admission queue (router rank) --
        # built after the engines so carried-state families price the
        # per-admission state handoff at this hop too (same surcharge
        # the per-rank engine schedulers apply)
        self.scheduler = CellQueueScheduler(
            num_cells=4 * ranks * slots_per_rank,
            prefill_chunk_bytes=4 * prefill_chunk,
            block_bytes=4 * block_size,
            state_bytes=self.workers[0].engine._carried_state_bytes())

        self.transport = (KVBlockTransport(comm)
                          if self.placement.needs_migration else None)
        self.finished: List[ServeRequest] = []
        self.total_steps = 0
        # ranks are THREADS (the paper's thesis): each engine rank owns
        # disjoint host state (its derived comm context, KV pools,
        # scheduler, decode rows), so their micro-steps run on threads
        # of their own; the model's launch counters are locked for them
        self._rank_pool = (ThreadPoolExecutor(
            max_workers=self.ranks, thread_name_prefix="fabric-rank")
            if self.ranks > 1 else None)

    @staticmethod
    def _engine_comms(root, ranks: int) -> List:
        """One derived communication context per engine rank. With a
        root wide enough, ``split`` assigns each engine rank a
        contiguous color class of unified ranks (its own sub-comm
        family); a narrower root (the owned one-rank comm) gives each
        rank a ``dup``: same group, fresh context. Either way every
        rank's streams order only against themselves."""
        S = root.size
        if S >= ranks:
            color = [ur * ranks // S for ur in range(S)]
            sub = root.split(color)
            return [sub.dup() for _ in range(ranks)]
        return [root.dup() for _ in range(ranks)]

    # -- intake (the dispatch hop) -----------------------------------------
    def submit(self, req: ServeRequest, now: float = 0.0) -> str:
        """Queue a request at the router: classified and priced by the
        cell-queue admission model, dispatched to an engine rank at the
        next :meth:`step`. The full decode budget is validated against
        the serving ranks here — a request no rank could ever lease
        must fail at submit, not blow up mid-step after the dispatch
        hop already popped it (or livelock the migrate hop)."""
        budget = req.prompt_len + req.max_new_tokens
        decode_role = ("decode" if self.placement.needs_migration
                       else "full")
        cap = max((w.engine.admittable_tokens for w in self.workers
                   if w.role == decode_role), default=0)
        if budget > cap:
            raise ValueError(
                f"request {req.rid}: prompt+max_new = {budget} tokens "
                f"exceeds every {decode_role}-rank capacity {cap}; raise "
                "cache_len/blocks_per_rank or lower max_new_tokens")
        return self.scheduler.submit(req, now)

    def _dispatch(self, now: float) -> None:
        """Deal queued requests join-shortest-queue to eligible ranks,
        stopping at the dispatch window (bounded per-rank backlog)."""
        tr = _tr_active()
        while True:
            w = self.placement.select_submit(self.workers)
            if w is None or w.queue_depth >= self.dispatch_window:
                return
            if tr is None:
                admitted = self.scheduler.admit(now, 1)
                if not admitted:
                    return
                w.submit(admitted[0], now)
            else:
                # the router-dispatch hop's wall-clock twin of the
                # admission price stamped at this hop's scheduler
                t0 = time.perf_counter()
                admitted = self.scheduler.admit(now, 1)
                if not admitted:
                    return
                w.submit(admitted[0], now)
                tr.hop("router_dispatch", admitted[0].admit_cost_s, t0,
                       time.perf_counter(), rid=admitted[0].rid,
                       rank=w.rank)

    # -- the migrate hop (disaggregated only) ------------------------------
    def _migrate(self, now: float) -> None:
        """Move prefill-complete requests whose decode rank can post
        the receive. Head-of-line within each prefill rank, mirroring
        ``CellQueueScheduler.admit`` one hop down: when the oldest held
        handoff fits no decode rank, migration for that rank defers
        entirely — later (smaller) handoffs must not keep taking the
        blocks the stalled one is waiting for, starving it without
        bound while its prompt blocks stay leased at the prefill rank."""
        for w in self.workers:
            if w.role != "prefill":
                continue
            held = []
            pending = w.engine.take_handoffs()
            for i, h in enumerate(pending):
                budget = h.req.prompt_len + h.req.max_new_tokens
                d = self.placement.select_decode(self.workers, budget)
                if d is None:
                    held.extend(pending[i:])   # FIFO: defer the rest too
                    break
                slot = None
                tr = _tr_active()
                t0 = time.perf_counter() if tr is not None else 0.0
                try:
                    slot, dst_blocks = d.engine.begin_import(h.req)
                    state_row = w.engine.handoff_state(h.slot)
                    cost = self.transport.migrate(
                        w.engine.kv, d.engine.kv, h.blocks,
                        dst_blocks[:len(h.blocks)])
                    d.engine.finish_import(slot, h, state_row, now)
                    if tr is not None:
                        # the migrate hop's wall-clock twin: posted
                        # receive + block messages + waitall + install
                        tr.hop("migration", cost, t0,
                               time.perf_counter(), rid=h.req.rid,
                               src=w.rank, dst=d.rank,
                               blocks=len(h.blocks))
                except BaseException:
                    # an error mid-migration must not lose in-flight
                    # requests: undo the posted receive and put this
                    # handoff (and everything after it, FIFO) back on
                    # hold — the source rows/blocks are still leased
                    # and intact (migration only reads them), so the
                    # whole handoff is retryable
                    if slot is not None:
                        d.engine.kv.free(slot)
                    w.engine.ready_handoffs.extend(pending[i:])
                    raise
                w.engine.release_handoff(h.slot)
                h.req.decode_rank = d.rank
                h.req.kv_migration_s = cost
                h.req.kv_blocks_moved = len(h.blocks)
                w.note_migrated_out(h.req)
                d.note_migrated_in(h.req)
            w.engine.ready_handoffs.extend(held)

    # -- micro-step --------------------------------------------------------
    def step(self, now: float = 0.0) -> List[ServeRequest]:
        """One fabric micro-step: dispatch, advance every rank (each on a
        rank thread), migrate. Returns the requests that finished
        anywhere this step. Dispatch and migration stay on the router
        thread: they read and write cross-rank state (JSQ loads, block
        leases on two pools), while a rank's micro-step touches only its
        own."""
        tr = _tr_active()
        if tr is not None:
            # router-thread runnable hint: queued requests the router
            # could be dispatching; time it then spends blocked inside a
            # migrate waitall is measured serialization (paper §2)
            tr.set_runnable(self.scheduler.num_waiting)
        self._dispatch(now)
        finished: List[ServeRequest] = []
        if self._rank_pool is not None:
            for done in self._rank_pool.map(
                    lambda w: w.step(now), self.workers):
                finished.extend(done)
        else:
            for w in self.workers:
                finished.extend(w.step(now))
        if self.placement.needs_migration:
            self._migrate(now)
        self.finished.extend(finished)
        self.total_steps += 1
        return finished

    @property
    def idle(self) -> bool:
        return (self.scheduler.num_waiting == 0
                and all(w.idle for w in self.workers))

    # -- reporting ---------------------------------------------------------
    def stats(self) -> Dict:
        """Aggregate fabric measurements: router-level latency/TTFT
        percentiles over every finished request, the dispatch hop's
        admission accounting, per-rank utilization rows, and (disagg)
        the KV-migration rows."""
        out = latency_stats_over(self.finished)
        out.update(
            placement=self.placement.name,
            ranks=float(self.ranks),
            fabric_steps=float(self.total_steps),
        )
        # trial-scoped census + admission accounting of the dispatch
        # hop, and the per-rank rows: the schema collectors of
        # repro_torch.obs.metrics
        out.update(obs_metrics.scheduler_census(self.scheduler))
        out["per_rank"] = [w.utilization() for w in self.workers]
        if self.transport is not None:
            out.update(self.transport.stats())
            mig = [r.kv_migration_s for r in self.finished
                   if r.kv_blocks_moved > 0]
            if mig:
                out["kv_migration_p50_us"] = 1e6 * float(
                    np.percentile(mig, 50))
                out["kv_migration_p95_us"] = 1e6 * float(
                    np.percentile(mig, 95))
        return out

    # -- lifecycle ---------------------------------------------------------
    def reset(self) -> None:
        """Post-warm-up clean slate across the whole fabric: router
        queue + per-request accounting maps, every rank's engine and
        counters, migration accounting."""
        self.scheduler.reset()
        for w in self.workers:
            w.reset()
        if self.transport is not None:
            self.transport.reset()
        self.finished = []
        self.total_steps = 0

    def close(self, *, strict: bool = False) -> None:
        """Finish/free the root threadcomm if this fabric owns it —
        after a fabric-wide lease census. Requests still in flight
        (dispatch log), KV rows still leased on any rank, or handoffs
        still awaiting migration are leaks at close: each is named via
        ``LeaseLeakWarning``, or ``LeaseLeakError`` when ``strict``
        (finish/free still runs, so an owned comm is never stranded)."""
        leaks: List[str] = []
        in_flight = sorted(r.rid for r in self.scheduler.req_log.values()
                           if r.state != "done")
        if in_flight:
            leaks.append(f"{len(in_flight)} request(s) in flight at the "
                         f"router: {', '.join(map(str, in_flight[:8]))}"
                         + (" ..." if len(in_flight) > 8 else ""))
        for w in self.workers:
            live = w.engine.kv.num_live
            if live:
                owners = [w.engine.kv.owner(s)
                          for s in w.engine.kv.live_slots]
                leaks.append(f"rank {w.rank} ({w.role}) holds {live} "
                             f"live KV lease(s): owners {owners!r}")
            if w.engine.ready_handoffs:
                rids = [h.req.rid for h in w.engine.ready_handoffs]
                leaks.append(f"rank {w.rank} ({w.role}) holds "
                             f"{len(rids)} unmigrated handoff(s): "
                             f"{rids!r}")
        try:
            if leaks:
                msg = ("fabric closed with leaked leases: "
                       + "; ".join(leaks))
                if strict:
                    raise LeaseLeakError(msg)
                warnings.warn(msg, LeaseLeakWarning, stacklevel=2)
        finally:
            if self._rank_pool is not None:
                self._rank_pool.shutdown(wait=True)
                self._rank_pool = None
            if self._owns_comm:
                self.comm.finish()
                self.comm.free()
                self._owns_comm = False
            # a closed fabric ends the trial: drop the router's rid-keyed
            # log and admission accounting and the transport's counters
            # (rids restart at 0 next trial, so a stale entry would alias
            # a new request), and flush the global telemetry (residual
            # ledger + registry) so nothing recorded here aggregates into
            # a later trial. Worker and engine counters stay readable
            # until their own reset(): close() must not re-run the
            # engines' lease census the block above already reported.
            self.scheduler.reset()
            if self.transport is not None:
                self.transport.reset()
            self.finished = []
            self.total_steps = 0
            _obs_flush_trial()
