"""Span tracer of the port (``REPRO_TRACE=1``) — the port of
``src/repro/obs/trace.py`` (DESIGN.md §15).

Nestable spans with thread, rank and stream context over what the
paper's threading story touches: comm waits and ``CommStream`` regions,
engine micro-steps (``prefill_chunk`` / ``decode`` / ``spec_round``),
scheduler admit/defer decisions and the priced hops. Events land in a
bounded ring buffer (overflow drops the oldest first) and export as
Chrome ``trace_event`` JSON, which opens in Perfetto or
``chrome://tracing`` as one timeline, a lane per rank.

What a span measures on the card. ``ts`` / ``dur`` are host wall clock
(``perf_counter``) around the host call, as in the reference; kernel
launches are asynchronous, so they cover the device work only up to
the call's last host synchronisation. A span opened with
``span(..., device=dev)`` on a CUDA device also records a CUDA event on
the current stream at its start and at its end, and carries the device
time between them as ``args["device_ms"]``: the paged engine's
``prefill_chunk`` and ``decode`` spans, their ``.pack`` / ``.forward``
/ ``.sample`` phases (``cat="phase"``) and the MoE block's ``moe``
spans (``cat="block"``). The event pairs are read off the hot path: a
pair whose end event ``query()`` finds done is read when a timed span
ends (its events go back to a free list), and :meth:`Tracer.events`
/ :meth:`Tracer.chrome_trace` wait on each pair still pending. The
tracer adds no synchronisation inside a step: a traced run is the
untraced program plus its events. On a CPU device there is no
``device_ms``.

While a ``torch.profiler`` run is active, every ``span()`` also enters
a ``record_function`` range of its name and leaves it at ``end()``, so
the span is one of the profiler's host events, on the clock its device
events share: an idle stretch of the card can be named after the engine
phase that was running. No profiler, no range.

Cost discipline: disabled, every instrumented site is one module-global
read plus a ``None`` check; nothing allocates, nothing reads the clock,
no CUDA event is made and no ``record_function`` entered. Enabled, the
hot-path API is ``complete(name, t0, t1)``: the caller reads
``perf_counter`` around the timed region and the tracer records one
pre-timed "X" event. The structured API, ``span()`` as a context
manager or a handle whose ``end()`` runs on every path, is for
region-shaped sites (stream regions, rank steps, engine phases). A span
opened inside another takes the enclosing span's ``step`` unless it is
given one, so every span of one engine step shares it.

Rank attribution: rank threads of a pool are reassigned to ranks
arbitrarily, so thread identity is not rank identity. ``rank_scope(rank)``
pushes the rank onto a thread-local stack; every event emitted inside
carries that rank as its lane (``tid``). Span nesting state is
thread-local too.

The tracer owns the trial's :class:`~repro_torch.obs.residuals.
ResidualLedger` (``tracer.residuals``): ``hop()`` records a
modeled-vs-measured pair and emits the hop's span in one call, and
``on_wait`` feeds the serialization-stall detector from
``Request.wait``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import torch

from repro_torch.obs.residuals import ResidualLedger

#: default ring capacity: a serving trial of a few hundred micro-steps
#: is a few thousand events
DEFAULT_CAPACITY = 65536

#: lane of events outside any rank scope (driver threads get DRIVER_TID
#: plus a per-thread index)
DRIVER_TID = 1000


class Span:
    """Handle for an open span. Context-manager use is exception-safe by
    construction; manual use must call :meth:`end` on every path."""

    __slots__ = ("_tracer", "name", "cat", "args", "t0", "tid", "parent",
                 "_open", "_range", "_events")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Dict[str, Any], t0: float, tid: int,
                 parent: Optional[str]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.t0 = t0
        self.tid = tid
        self.parent = parent
        self._open = True
        #: the profiler's ``record_function`` range, while one runs
        self._range = None
        #: (start event, stream) of a device-timed span
        self._events = None

    def end(self) -> None:
        if self._open:
            self._open = False
            self._tracer._end_span(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        self.end()
        return False


class Tracer:
    """Ring-buffered span recorder with per-thread nesting state."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError("ring capacity must be >= 1")
        self.capacity = int(capacity)
        self._events: deque = deque()
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._t0 = time.perf_counter()
        self.dropped = 0          # events evicted oldest-first
        self.unbalanced = 0       # manual end() out of LIFO order
        self.residuals = ResidualLedger()
        # tid -> lane name for the thread_name metadata
        self._lane_names: Dict[int, str] = {}
        self._next_driver_lane = DRIVER_TID
        # device-timed spans: (event dict, start, end) awaiting their
        # device_ms, oldest end first; events read and free for reuse
        self._pending: deque = deque()
        self._free_events: List[Any] = []

    # -- thread-local context ----------------------------------------------
    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _ranks(self) -> List[int]:
        rk = getattr(self._tls, "ranks", None)
        if rk is None:
            rk = self._tls.ranks = []
        return rk

    def current_rank(self) -> Optional[int]:
        rk = self._ranks()
        return rk[-1] if rk else None

    def rank_scope(self, rank: int):
        """Attribute everything emitted on this thread to ``rank`` until
        exit."""
        return _RankScope(self, int(rank))

    def set_runnable(self, n: int) -> None:
        """Thread-local runnable-work hint for the stall detector: live
        rows + queued requests this rank could be advancing now. Set by
        the engine at each micro-step."""
        self._tls.runnable = int(n)

    def _runnable(self) -> int:
        return getattr(self._tls, "runnable", 0)

    def _tid(self) -> int:
        """Lane: the innermost rank scope, else a stable per-thread
        driver lane."""
        rank = self.current_rank()
        if rank is not None:
            with self._lock:
                self._lane_names.setdefault(rank, f"rank {rank}")
            return rank
        lane = getattr(self._tls, "lane", None)
        if lane is None:
            with self._lock:
                lane = self._next_driver_lane
                self._next_driver_lane += 1
                self._lane_names[lane] = threading.current_thread().name
            self._tls.lane = lane
        return lane

    # -- recording ---------------------------------------------------------
    def _us(self, t: float) -> float:
        return (t - self._t0) * 1e6

    def _emit(self, ev: dict) -> None:
        with self._lock:
            if len(self._events) >= self.capacity:
                self._events.popleft()    # ring: oldest-first eviction
                self.dropped += 1
            self._events.append(ev)

    def span(self, name: str, cat: str = "", device=None, **args) -> Span:
        """Open a span on this thread's stack: a context manager, or a
        handle to ``end()`` on every path. On a CUDA ``device`` the span
        also carries the device time between its start and end on the
        device's current stream, as ``args["device_ms"]``. A span opened
        inside another takes that span's ``step`` unless given one."""
        stack = self._stack()
        parent = stack[-1] if stack else None
        if parent is not None and "step" in parent.args:
            args.setdefault("step", parent.args["step"])
        sp = Span(self, name, cat, args, time.perf_counter(), self._tid(),
                  parent.name if parent is not None else None)
        if torch.autograd._profiler_enabled():
            sp._range = torch.autograd.profiler.record_function(name)
            sp._range.__enter__()
        if getattr(device, "type", None) == "cuda":
            stream = torch.cuda.current_stream(device)
            start = self._event()
            start.record(stream)
            sp._events = (start, stream)
        stack.append(sp)
        return sp

    def _end_span(self, sp: Span) -> None:
        end = None
        if sp._events is not None:
            end = self._event()
            end.record(sp._events[1])
        if sp._range is not None:
            sp._range.__exit__(None, None, None)
        t1 = time.perf_counter()
        stack = self._stack()
        if stack and stack[-1] is sp:
            stack.pop()
        else:
            # ended out of LIFO order (or on another thread): remove it
            # wherever it sits and count the misuse
            try:
                stack.remove(sp)
            except ValueError:
                pass
            self.unbalanced += 1
        args = dict(sp.args)
        if sp.parent is not None:
            args["parent"] = sp.parent
        ev = {"name": sp.name, "cat": sp.cat or "span", "ph": "X",
              "ts": self._us(sp.t0), "dur": (t1 - sp.t0) * 1e6,
              "pid": 0, "tid": sp.tid, "args": args}
        self._emit(ev)
        if end is not None:
            with self._lock:
                self._pending.append((ev, sp._events[0], end))
            self._read_device_times(wait=False)

    # -- device times --------------------------------------------------------
    def _event(self):
        with self._lock:
            if self._free_events:
                return self._free_events.pop()
        return torch.cuda.Event(enable_timing=True)

    def _read_device_times(self, wait: bool) -> None:
        """Put ``device_ms`` into the events of finished device-timed
        spans, oldest first: those whose end event is done, or with
        ``wait`` every one, waiting on each end event."""
        while True:
            with self._lock:
                if not self._pending:
                    return
                ev, start, end = self._pending[0]
                if not wait and not end.query():
                    return
                self._pending.popleft()
            if wait:
                end.synchronize()
            ev["args"]["device_ms"] = start.elapsed_time(end)
            with self._lock:
                self._free_events += (start, end)

    def complete(self, name: str, t0: float, t1: float, cat: str = "",
                 **args) -> None:
        """Hot-path pre-timed event: the caller read ``perf_counter``
        around the region; no stack bookkeeping, one emit."""
        stack = self._stack()
        if stack:
            args["parent"] = stack[-1].name
        self._emit({"name": name, "cat": cat or "span", "ph": "X",
                    "ts": self._us(t0), "dur": (t1 - t0) * 1e6,
                    "pid": 0, "tid": self._tid(), "args": args})

    def instant(self, name: str, cat: str = "", **args) -> None:
        """Point event (scheduler admit/defer decisions)."""
        self._emit({"name": name, "cat": cat or "event", "ph": "i",
                    "ts": self._us(time.perf_counter()), "s": "t",
                    "pid": 0, "tid": self._tid(), "args": args})

    def counter(self, name: str, **values) -> None:
        """Counter track (block-pool occupancy, queue depth)."""
        self._emit({"name": name, "cat": "counter", "ph": "C",
                    "ts": self._us(time.perf_counter()),
                    "pid": 0, "tid": self._tid(), "args": values})

    def hop(self, kind: str, modeled_s: float, t0: float, t1: float,
            **args) -> None:
        """A priced hop: record the modeled-vs-measured pair in the
        residual ledger and emit the hop's span, carrying its residual in
        ``args``."""
        measured = t1 - t0
        rank = self.current_rank()
        self.residuals.record(kind, modeled_s, measured, rank=rank)
        args["modeled_s"] = float(modeled_s)
        args["measured_s"] = float(measured)
        if modeled_s > 0:
            args["residual_ratio"] = measured / modeled_s
        self.complete(f"hop:{kind}", t0, t1, cat="residual", **args)

    def on_wait(self, op: str, t0: float, t1: float) -> None:
        """Comm completion point (``Request.wait``): emit the wait span
        and, when this thread's runnable hint is set, charge the blocked
        time to the serialization-stall detector."""
        runnable = self._runnable()
        if runnable > 0:
            self.residuals.stall(t1 - t0, rank=self.current_rank())
        self.complete(f"wait:{op}", t0, t1, cat="comm", runnable=runnable)

    # -- trial lifecycle ---------------------------------------------------
    def flush_trial(self) -> None:
        """Trial boundary (the engine's post-warm-up reset): drop the
        residual pairs and stall accumulators, so warm-up measurements
        never aggregate into a measured trial's report. The event ring is
        kept: the timeline shows warm-up next to the trial."""
        self.residuals.reset()

    # -- export ------------------------------------------------------------
    def events(self) -> List[dict]:
        self._read_device_times(wait=True)
        with self._lock:
            return list(self._events)

    @property
    def n_events(self) -> int:
        with self._lock:
            return len(self._events)

    def chrome_trace(self) -> dict:
        """Chrome ``trace_event`` JSON object: per-lane thread_name
        metadata (rank lanes sort first) + the ring's events by time."""
        with self._lock:
            events = list(self._events)
            lanes = dict(self._lane_names)
        meta: List[dict] = [
            {"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
             "args": {"name": "repro-serve"}},
        ]
        for tid, lane_name in sorted(lanes.items()):
            meta.append({"name": "thread_name", "ph": "M", "pid": 0,
                         "tid": tid, "args": {"name": lane_name}})
            meta.append({"name": "thread_sort_index", "ph": "M", "pid": 0,
                         "tid": tid, "args": {"sort_index": tid}})
        events.sort(key=lambda e: e["ts"])
        return {"displayTimeUnit": "ms",
                "traceEvents": meta + events,
                "metadata": {"dropped_events": self.dropped}}

    def export_json(self) -> str:
        return json.dumps(self.chrome_trace())

    def write_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.export_json())


class _RankScope:
    __slots__ = ("_tracer", "_rank")

    def __init__(self, tracer: Tracer, rank: int):
        self._tracer = tracer
        self._rank = rank

    def __enter__(self):
        self._tracer._ranks().append(self._rank)
        return self

    def __exit__(self, *exc):
        rk = self._tracer._ranks()
        if rk and rk[-1] == self._rank:
            rk.pop()
        return False


# ---------------------------------------------------------------------------
# Global activation: instrumented sites read one module global and
# None-check it; when nothing is installed the telemetry costs that read.
# ---------------------------------------------------------------------------

_TRACER: Optional[Tracer] = None


def active() -> Optional[Tracer]:
    return _TRACER


def install(capacity: int = DEFAULT_CAPACITY) -> Tracer:
    global _TRACER
    _TRACER = Tracer(capacity=capacity)
    return _TRACER


def uninstall() -> None:
    global _TRACER
    _TRACER = None


def flush_trial() -> None:
    """Module-level trial flush for reset hooks: a no-op when tracing is
    off, a residual-ledger reset when on."""
    tr = _TRACER
    if tr is not None:
        tr.flush_trial()


def _truthy(v: str) -> bool:
    return v.strip().lower() in ("1", "true", "yes", "on")


if _truthy(os.environ.get("REPRO_TRACE", "")):
    install(capacity=int(os.environ.get("REPRO_TRACE_CAPACITY",
                                        str(DEFAULT_CAPACITY))))
