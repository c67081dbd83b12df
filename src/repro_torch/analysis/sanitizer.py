"""Runtime threadcomm sanitizer (the port of
``src/repro/analysis/sanitizer.py``, DESIGN.md §11): happens-before
tracking over ``core/comm.py`` operations plus a lease ledger over the
serving pools. Enable with ``REPRO_SANITIZE=1`` (add
``REPRO_SANITIZE_STRICT=1`` to raise at the first finding instead of
accumulating); this module reads both variables itself.

What it checks, mapped to the paper's pathologies:

* **Unmatched requests** — a :class:`~repro_torch.core.comm.Request`
  issued but never completed by ``wait``/``test``/``waitall`` when its
  root threadcomm ``finish()``es (the window that invalidates it). The
  MPI analogue is an ``MPI_Isend`` whose request leaks: the transfer may
  never complete and the buffer lifetime is undefined. On the card a
  request completes through ``wait()`` or the ``test()`` call whose CUDA
  event query turns it done, exactly once.
* **Accidental-serialization hazards** (paper §2) — the *same* comm
  object issued the *same* kind of operation from two execution
  contexts with no happens-before edge between the issues. Collectives
  on one communicator match by issue order, so concurrent unordered
  issues either serialize behind a runtime lock or mismatch; the fix is
  a ``dup()``'d comm per context (what the serving fabric does) or an
  explicit ordering edge (``wait()`` the first before issuing the
  second).
* **Lease safety** — double free / refcount underflow on the KV block
  pool reported with allocation provenance ("allocated at X, first
  freed at Y"), and leases still live when a pool resets.
* **Migration completeness** — a ``KVBlockTransport.migrate`` that
  began but never reached its ``waitall`` completion point.

Execution contexts are ``CommStream`` objects plus one implicit "host"
context per root threadcomm; every hook is O(1) and each instrumented
site is a single global read and a ``None`` check when the sanitizer is
off. Every hook is host bookkeeping: it launches no device work.

Unlike the reference's, the collector takes one lock around its state:
the serving fabric's engine ranks are host threads that lease and free
blocks at once, and the ledger's read-then-write updates and its scans
at reset must not interleave.
"""

from __future__ import annotations

import os
import sys
import threading
from dataclasses import dataclass
from typing import Dict, Hashable, List, Optional, Tuple

from repro_torch.analysis.hb import VectorClock
from repro_torch.analysis.ledger import LeaseLedger


class SanitizerError(RuntimeError):
    """Raised at the first finding when the sanitizer runs strict."""


@dataclass
class SanitizerFinding:
    kind: str          # "unmatched-request" | "serialization-hazard" |
                       # "double-free" | "lease-leak" | "migration-incomplete"
    message: str
    site: str = ""

    def __str__(self) -> str:
        loc = f" ({self.site})" if self.site else ""
        return f"[{self.kind}] {self.message}{loc}"


# frames never reported as a user-facing site: the sanitizer itself and
# the instrumented runtime modules (the interesting frame is their caller)
_INTERNAL_BASENAMES = frozenset({
    "sanitizer.py", "ledger.py", "hb.py", "comm.py", "block_pool.py",
    "transport.py",
})


def _call_site() -> str:
    """``file:line`` of the innermost frame outside the instrumented
    modules (a frame walk: no source lines are read)."""
    fr = sys._getframe(1)
    while fr is not None:
        fn = fr.f_code.co_filename
        if os.path.basename(fn) not in _INTERNAL_BASENAMES:
            return f"{fn}:{fr.f_lineno}"
        fr = fr.f_back
    return "<unknown>"


@dataclass
class _RequestRecord:
    op: str
    comm_id: int
    root_id: int
    ctx: Hashable
    ctx_name: str
    clock: VectorClock
    site: str


@dataclass
class _MigrationRecord:
    n_blocks: int
    root_id: int
    site: str


class ThreadSanitizer:
    """The collector: one instance per process, installed by
    :func:`install` (tests) or the ``REPRO_SANITIZE`` env (CI)."""

    def __init__(self, strict: bool = False):
        self.strict = bool(strict)
        self.findings: List[SanitizerFinding] = []
        self.ledger = LeaseLedger()
        self._clocks: Dict[Hashable, VectorClock] = {}
        self._pending: Dict[int, _RequestRecord] = {}     # id(req) -> record
        self._last_issue: Dict[Tuple[int, str], _RequestRecord] = {}
        self._migrations: Dict[int, _MigrationRecord] = {}
        self._lock = threading.RLock()

    # ------------------------------------------------------------------
    # reporting
    # ------------------------------------------------------------------
    def _emit(self, kind: str, message: str, site: str = "") -> None:
        f = SanitizerFinding(kind, message, site)
        self.findings.append(f)
        if self.strict:
            raise SanitizerError(str(f))

    def findings_of(self, kind: str) -> List[SanitizerFinding]:
        with self._lock:
            return [f for f in self.findings if f.kind == kind]

    def assert_clean(self) -> None:
        """Raise if any finding (including still-pending requests or
        migrations) is outstanding — the test-suite epilogue check."""
        with self._lock:
            leaks = list(self.findings)
            leaks += [SanitizerFinding(
                "unmatched-request",
                f"request({r.op}) never completed", r.site)
                for r in self._pending.values()]
            leaks += [SanitizerFinding(
                "migration-incomplete",
                f"migration of {m.n_blocks} blocks never completed", m.site)
                for m in self._migrations.values()]
        if leaks:
            raise SanitizerError(
                "sanitizer found:\n  " + "\n  ".join(map(str, leaks)))

    # ------------------------------------------------------------------
    # happens-before plumbing
    # ------------------------------------------------------------------
    def _clock(self, ctx: Hashable) -> VectorClock:
        c = self._clocks.get(ctx)
        if c is None:
            c = self._clocks[ctx] = VectorClock()
        return c

    @staticmethod
    def _active_ctx(root) -> Tuple[Hashable, str]:
        """The context currently executing for ``root``: the innermost
        entered stream, else the host context."""
        stack = getattr(root, "_stream_stack", None)
        if stack:
            s = stack[-1]
            return ("stream", id(s)), f"stream {s.name!r}"
        return ("host", id(root)), "host context"

    @staticmethod
    def _issue_ctx(req) -> Tuple[Hashable, str]:
        """The context a request was issued on: its bound stream when it
        has one (covers direct ``Request`` construction, e.g. the KV
        transport), else the host context of its root."""
        if req.stream is not None:
            return ("stream", id(req.stream)), f"stream {req.stream.name!r}"
        return ("host", id(req.comm._root)), "host context"

    # ------------------------------------------------------------------
    # comm hooks (called from repro_torch.core.comm)
    # ------------------------------------------------------------------
    def on_request(self, req) -> None:
        """A nonblocking operation was issued (Request constructed)."""
        site = _call_site()
        ctx, ctx_name = self._issue_ctx(req)
        with self._lock:
            clock = self._clock(ctx)
            clock.tick(ctx)
            rec = _RequestRecord(
                op=req.op, comm_id=id(req.comm), root_id=id(req.comm._root),
                ctx=ctx, ctx_name=ctx_name, clock=clock.copy(), site=site)
            self._pending[id(req)] = rec
            key = (rec.comm_id, rec.op)
            last = self._last_issue.get(key)
            if (last is not None and last.ctx != rec.ctx
                    and last.clock.concurrent_with(rec.clock)):
                self._emit(
                    "serialization-hazard",
                    f"{rec.op} issued on the same comm from "
                    f"{last.ctx_name} (at {last.site}) and {rec.ctx_name} "
                    "with no happens-before edge: operations on one "
                    "communicator match by issue order, so concurrent "
                    "contexts accidentally serialize (paper §2) — issue "
                    "on dup()'d comms or order the contexts (wait() the "
                    "first request before the second issue)",
                    rec.site)
            self._last_issue[key] = rec

    def on_request_complete(self, req) -> None:
        """``wait()``/successful ``test()``: the completion merges the
        issue-time snapshot into the waiter's context (a happens-before
        edge from everything ordered before the issue)."""
        with self._lock:
            rec = self._pending.pop(id(req), None)
            if rec is None:
                return
            ctx, _ = self._active_ctx(req.comm._root)
            waiter = self._clock(ctx)
            waiter.merge(rec.clock)
            waiter.tick(ctx)

    def on_stream_enter(self, stream) -> None:
        """Entering a stream region: program order flows from the
        enclosing context into the stream (what makes issue -> wait ->
        enter-new-stream properly ordered instead of a false hazard)."""
        with self._lock:
            parent, _ = self._active_ctx(stream.comm._root)
            self._clock(("stream", id(stream))).merge(self._clock(parent))

    def on_finish(self, root) -> None:
        """``ThreadComm.finish()``: every pending request issued under
        this root is now permanently unmatched — report and drop them.
        Incomplete migrations riding this root surface here too."""
        rid = id(root)
        with self._lock:
            for key in [k for k, r in self._pending.items()
                        if r.root_id == rid]:
                rec = self._pending.pop(key)
                self._emit(
                    "unmatched-request",
                    f"request({rec.op}) issued on {rec.ctx_name} never "
                    "reached wait()/test()/waitall() before finish() "
                    "closed its activation window",
                    rec.site)
            for key in [k for k, m in self._migrations.items()
                        if m.root_id == rid]:
                mig = self._migrations.pop(key)
                self._emit(
                    "migration-incomplete",
                    f"KV migration of {mig.n_blocks} blocks never reached "
                    "its waitall completion point",
                    mig.site)

    # ------------------------------------------------------------------
    # lease hooks (called from repro_torch.serve.block_pool)
    # ------------------------------------------------------------------
    def on_lease_alloc(self, pool, resources, owner) -> None:
        site = _call_site()
        with self._lock:
            for r in resources:
                self.ledger.on_alloc(id(pool), int(r), owner, site)

    def on_lease_ref(self, pool, resource, owner=None) -> None:
        """A shared reference (prefix lease / CoW source) was added —
        the ledger keeps who and where, so a later double free on the
        shared block reports the whole chain."""
        site = _call_site()
        with self._lock:
            self.ledger.on_ref(id(pool), int(resource), owner=owner,
                               site=site)

    def on_lease_release(self, pool, resource) -> None:
        site = _call_site()
        with self._lock:
            self.ledger.on_release(id(pool), int(resource), site)

    def on_double_free(self, pool, resource, last_owner) -> str:
        """Refcount underflow / double free: emit a finding carrying the
        full provenance and return the provenance string so the pool's
        permanent ``SlotError`` can include it."""
        site = _call_site()
        with self._lock:
            prov = self.ledger.provenance(id(pool), int(resource))
            self._emit(
                "double-free",
                f"double free of block {resource} (last owner "
                f"{last_owner!r}): {prov}",
                site)
        return prov

    def on_pool_reset(self, pool) -> None:
        """Pool reset: leases still live are leaks — report each with
        its allocation site, then forget the pool's history."""
        site = _call_site()
        with self._lock:
            for res, rec in self.ledger.live_for(id(pool)):
                self._emit(
                    "lease-leak",
                    f"block {res} (owner {rec.owner!r}) still leased at "
                    f"reset(); allocated at {rec.alloc_site}"
                    + self.ledger._shared_history(rec),
                    site)
            self.ledger.forget_pool(id(pool))

    # ------------------------------------------------------------------
    # migration hooks (called from repro_torch.serve.fabric.transport)
    # ------------------------------------------------------------------
    def on_migrate_begin(self, transport, n_blocks: int) -> None:
        site = _call_site()
        with self._lock:
            self._migrations[id(transport)] = _MigrationRecord(
                n_blocks=int(n_blocks),
                root_id=id(transport.comm._root),
                site=site)

    def on_migrate_end(self, transport) -> None:
        with self._lock:
            self._migrations.pop(id(transport), None)


# ---------------------------------------------------------------------------
# process-wide installation
# ---------------------------------------------------------------------------

_SAN: Optional[ThreadSanitizer] = None


def active() -> Optional[ThreadSanitizer]:
    """The installed sanitizer, or None. Instrumented code guards every
    hook with this — one global read and a None check when disabled."""
    return _SAN


def install(strict: bool = False) -> ThreadSanitizer:
    """Install a fresh sanitizer (tests; idempotent over re-install)."""
    global _SAN
    _SAN = ThreadSanitizer(strict=strict)
    return _SAN


def uninstall() -> None:
    global _SAN
    _SAN = None


def _truthy(v: str) -> bool:
    return v.strip().lower() in ("1", "true", "yes", "on")


if _truthy(os.environ.get("REPRO_SANITIZE", "")):
    install(strict=_truthy(os.environ.get("REPRO_SANITIZE_STRICT", "")))
