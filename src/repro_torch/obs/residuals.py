"""Modeled-vs-measured cost residuals — the port of
``src/repro/obs/residuals.py`` (DESIGN.md §15).

Every serving hop the §3.2 protocol model prices (admission, prefix hit,
KV migration, speculative verify round, router dispatch) has a
wall-clock twin the tracer measures at the same site. The ledger keeps
the (modeled, measured) pairs per hop kind, and :meth:`report` shows
where the model is off by more than a factor (default 2x): a hop whose
measured cost dwarfs its modeled one is where threads serialize on
shared communication state.

The ledger also owns the serialization-stall detector: time a rank
spends blocked inside a comm completion (``Request.wait``) while it has
runnable work (live rows, queued requests: the tracer's thread-local
runnable hint, set by the engine at each micro-step).

Everything here is trial-scoped: ``ContinuousEngine.reset`` flushes the
ledger (``trace.flush_trial()``), so warm-up measurements never enter a
measured trial's residuals.

Pure host arithmetic: for the same recorded pairs the report is the
reference's, key for key.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

#: hop kinds with a §3.2 modeled price (the report orders by this)
HOP_KINDS = ("admission", "prefix_hit", "migration", "spec_verify",
             "router_dispatch")


class ResidualLedger:
    """Accumulates (modeled, measured) cost pairs per hop kind, plus
    serialization-stall time. Thread-safe: rank threads may record
    concurrently with a driver thread."""

    def __init__(self):
        self._lock = threading.Lock()
        # kind -> list of (modeled_s, measured_s, rank)
        self._hops: Dict[str, List[Tuple[float, float, int]]] = {}
        self._stall_s = 0.0
        self._stall_events = 0
        self._stall_by_rank: Dict[int, float] = {}

    # -- recording ---------------------------------------------------------
    def record(self, kind: str, modeled_s: float, measured_s: float,
               rank: Optional[int] = None) -> None:
        """One hop: its protocol-model price and its wall-clock twin."""
        row = (float(modeled_s), float(measured_s),
               -1 if rank is None else int(rank))
        with self._lock:
            self._hops.setdefault(kind, []).append(row)

    def stall(self, dt_s: float, rank: Optional[int] = None) -> None:
        """A rank spent ``dt_s`` blocked on comm completion while its
        runnable hint was set: accidental serialization, measured."""
        r = -1 if rank is None else int(rank)
        with self._lock:
            self._stall_s += float(dt_s)
            self._stall_events += 1
            self._stall_by_rank[r] = (self._stall_by_rank.get(r, 0.0)
                                      + float(dt_s))

    # -- reporting ---------------------------------------------------------
    def counts(self) -> Dict[str, int]:
        with self._lock:
            return {k: len(v) for k, v in self._hops.items()}

    def report(self, factor: float = 2.0) -> dict:
        """Per-hop aggregate modeled vs measured, flagging hop kinds whose
        aggregate ratio is off by more than ``factor`` in either
        direction. Seconds throughout; ``ratio = measured / modeled``."""
        with self._lock:
            hops_copy = {k: list(v) for k, v in self._hops.items()}
            stall_s = self._stall_s
            stall_events = self._stall_events
            stall_by_rank = dict(self._stall_by_rank)
        hops: Dict[str, dict] = {}
        flagged: List[str] = []
        order = [k for k in HOP_KINDS if k in hops_copy]
        order += [k for k in hops_copy if k not in HOP_KINDS]
        for kind in order:
            rows = hops_copy[kind]
            modeled = sum(r[0] for r in rows)
            measured = sum(r[1] for r in rows)
            ratio = measured / modeled if modeled > 0 else math.inf
            per = [r[1] / r[0] for r in rows if r[0] > 0]
            n_off = sum(1 for p in per if p > factor or p < 1.0 / factor)
            hops[kind] = {
                "n": len(rows),
                "modeled_s": modeled,
                "measured_s": measured,
                "ratio": ratio,
                "n_off": n_off,
                "worst_over": max(per, default=0.0),
                "worst_under": min(per, default=0.0),
            }
            if not (1.0 / factor <= ratio <= factor):
                flagged.append(kind)
        return {
            "factor": float(factor),
            "hops": hops,
            "flagged": flagged,
            "serialization_stall_s": stall_s,
            "stall_events": stall_events,
            "stall_by_rank": {str(k): v for k, v in stall_by_rank.items()},
        }

    def reset(self) -> None:
        """Trial boundary: drop every pair and the stall accumulators."""
        with self._lock:
            self._hops.clear()
            self._stall_s = 0.0
            self._stall_events = 0
            self._stall_by_rank.clear()


def merge_reports(reports: Sequence[dict], factor: float = 2.0) -> dict:
    """Recombine per-run residual reports (one per driver sub-trial) into
    one: hop sums add, ratios recompute from the merged sums, and stall
    time totals. A launcher payload carries the merged view, so one
    artifact answers "where is the model off" for the whole run."""
    merged: Dict[str, dict] = {}
    stall_s = 0.0
    stall_events = 0
    stall_by_rank: Dict[str, float] = {}
    for rep in reports:
        if not rep:
            continue
        stall_s += rep.get("serialization_stall_s", 0.0)
        stall_events += rep.get("stall_events", 0)
        for r, v in rep.get("stall_by_rank", {}).items():
            stall_by_rank[r] = stall_by_rank.get(r, 0.0) + v
        for kind, row in rep.get("hops", {}).items():
            m = merged.setdefault(kind, {
                "n": 0, "modeled_s": 0.0, "measured_s": 0.0, "n_off": 0,
                "worst_over": 0.0, "worst_under": math.inf})
            m["n"] += row["n"]
            m["modeled_s"] += row["modeled_s"]
            m["measured_s"] += row["measured_s"]
            m["n_off"] += row["n_off"]
            m["worst_over"] = max(m["worst_over"], row["worst_over"])
            m["worst_under"] = min(m["worst_under"], row["worst_under"])
    flagged = []
    for kind, m in merged.items():
        m["ratio"] = (m["measured_s"] / m["modeled_s"]
                      if m["modeled_s"] > 0 else math.inf)
        if m["worst_under"] is math.inf:
            m["worst_under"] = 0.0
        if not (1.0 / factor <= m["ratio"] <= factor):
            flagged.append(kind)
    return {
        "factor": float(factor),
        "hops": merged,
        "flagged": flagged,
        "serialization_stall_s": stall_s,
        "stall_events": stall_events,
        "stall_by_rank": stall_by_rank,
    }
