"""Engine rank of the serving fabric (the port of the reference's
``serve/fabric/worker.py``): one paged ``ContinuousEngine`` bound to its
own derived communication context, plus the per-rank accounting the
router aggregates (the predicted-cost load of join-shortest-queue, the
utilization rows of the stats).

The worker is thin: the engine is the serving loop; the worker is the
*rank* around it: identity, role, dispatch counters, and the load the
placement policies compare. Each worker is a rank of the serving
threadcomm with its own derived context, stepped on its own host thread
by the router. On the card every rank dispatches on the device's current
(default) stream, as every engine does.

Telemetry: each rank step runs inside the tracer's ``rank_scope`` and a
``rank_step`` span, so every span a pool thread emits lands on its
rank's lane (threads take ranks in any order from step to step).
"""

from __future__ import annotations

from typing import Dict, List

from repro_torch.core import protocol
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import active as _tr_active
from repro_torch.serve.engine import ContinuousEngine
from repro_torch.serve.scheduler import ServeRequest


class EngineWorker:
    """One engine rank: a ``ContinuousEngine`` plus rank accounting."""

    def __init__(self, rank: int, role: str, engine: ContinuousEngine,
                 comm=None):
        self.rank = int(rank)
        self.role = role
        self.engine = engine
        self.comm = comm
        # -- per-rank accounting (the router's utilization rows) --
        self.total_steps = 0
        self.busy_steps = 0
        self.n_dispatched = 0      # requests routed here by the router
        self.n_migrated_out = 0    # prefill rank: handoffs shipped
        self.n_migrated_in = 0     # decode rank: handoffs received
        self.n_finished = 0
        self.tokens_out = 0        # generated tokens of requests finished here
        # -- predicted-cost load (join-shortest-queue input) --
        # rid -> modeled seconds of work this rank still owes the
        # request; summed into _load_s so `load` is O(1)
        self._cost_s: Dict[int, float] = {}
        self._load_s = 0.0

    # -- intake ------------------------------------------------------------
    def submit(self, req: ServeRequest, now: float = 0.0) -> str:
        """Accept a router dispatch into this rank's engine scheduler."""
        req.rank = self.rank
        self.n_dispatched += 1
        out = self.engine.submit(req, now)
        self._track(req, self.predicted_cost_s(req))
        return out

    # -- load metric (join-shortest-queue input) ---------------------------
    def predicted_cost_s(self, req: ServeRequest,
                         decode_only: bool = False) -> float:
        """Modeled seconds of work this request brings to a rank (the
        paper's §3.2 protocol model): the prompt deposit priced exactly
        as the engine scheduler will price it (chunked/paged when
        configured), plus one interthread token handoff per decode
        dispatch. A count-based JSQ would rate a 16-token and a 256-token
        prompt the same; ranks equalize modeled *work*, not request
        count. ``decode_only`` is the migrated-in share: the decode rank
        never re-pays the prompt deposit.

        Decode is priced per *dispatch*, not per token: a speculative
        engine emits ``decode_tokens_per_dispatch`` tokens per round
        (observed acceptance, or its prior before data), so its dispatch
        count for the same ``max_new_tokens`` is proportionally lower; a
        one-token-per-dispatch price would overprice speculative ranks
        by that factor and steer a mixed-fleet JSQ away from them."""
        s = self.engine.scheduler
        m = s.host_model
        per_dispatch = self.engine.decode_tokens_per_dispatch
        dispatches = -(-req.max_new_tokens // max(1.0, per_dispatch))
        spec_k = getattr(self.engine, "speculate", 0)
        if spec_k:
            cost = dispatches * protocol.speculative_verify_latency(
                spec_k, s.itemsize, m)
        else:
            cost = dispatches * protocol.interthread_latency(
                s.itemsize, m)
        if not decode_only:
            nbytes = req.prompt_len * s.itemsize
            proto = protocol.select_protocol(nbytes, interthread=True,
                                             cell=s.cell_size)
            cost += s._price(nbytes, proto)
        return cost

    def _track(self, req: ServeRequest, cost: float) -> None:
        self._cost_s[req.rid] = cost
        self._load_s += cost

    def _untrack(self, req: ServeRequest) -> None:
        self._load_s -= self._cost_s.pop(req.rid, 0.0)

    @property
    def load(self) -> float:
        """Predicted seconds of work this rank is responsible for right
        now: the summed protocol-model cost of every request queued,
        prefilling, decoding, or held as an unmigrated handoff here
        (held handoffs keep their rows leased, so their cost stays on
        the prefill rank until migrated — exactly the backpressure the
        prefill JSQ should see)."""
        return self._load_s

    @property
    def queue_depth(self) -> int:
        """Requests this rank is responsible for right now — the
        dispatch-window backpressure gate (a *count* bound on per-rank
        backlog; `load` is the JSQ placement key)."""
        e = self.engine
        return e.scheduler.num_waiting + e.kv.num_live

    # -- migration accounting (disaggregated placement) --------------------
    def note_migrated_out(self, req: ServeRequest) -> None:
        """A handoff shipped from this prefill rank: its remaining work
        (the decode share) now belongs to the decode rank."""
        self.n_migrated_out += 1
        self._untrack(req)

    def note_migrated_in(self, req: ServeRequest) -> None:
        """A handoff landed on this decode rank: it owes the decode
        share only (the prompt deposit already happened upstream)."""
        self.n_migrated_in += 1
        self._track(req, self.predicted_cost_s(req, decode_only=True))

    @property
    def idle(self) -> bool:
        return self.engine.idle and not self.engine.ready_handoffs

    # -- micro-step --------------------------------------------------------
    def step(self, now: float = 0.0) -> List[ServeRequest]:
        busy = not self.idle
        tr = _tr_active()
        if tr is None:
            finished = self.engine.step(now)
        else:
            with tr.rank_scope(self.rank), \
                    tr.span("rank_step", cat="fabric", rank=self.rank,
                            role=self.role, busy=busy):
                finished = self.engine.step(now)
        self.total_steps += 1
        self.busy_steps += int(busy)
        self.n_finished += len(finished)
        self.tokens_out += sum(r.generated for r in finished)
        for r in finished:
            self._untrack(r)
        return finished

    # -- reporting ---------------------------------------------------------
    def utilization(self) -> dict:
        """Thin alias: the per-rank row schema lives in
        :func:`repro_torch.obs.metrics.worker_utilization`."""
        return obs_metrics.worker_utilization(self)

    def reset(self) -> None:
        """Post-warm-up clean slate: engine state AND rank accounting
        (a warm trial's busy steps must not pollute the measured
        utilization rows)."""
        self.engine.reset()
        self.total_steps = 0
        self.busy_steps = 0
        self.n_dispatched = 0
        self.n_migrated_out = 0
        self.n_migrated_in = 0
        self.n_finished = 0
        self.tokens_out = 0
        self._cost_s.clear()
        self._load_s = 0.0
