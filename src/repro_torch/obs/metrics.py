"""Metrics registry and the serving stats schema — the port of
``src/repro/obs/metrics.py`` (DESIGN.md §15).

Two surfaces in one module:

**Push registry**: counters, gauges and histograms that instrumented
sites update live (scheduler admissions, TTFT observations, block-pool
occupancy, queue depth). Enabled with the tracer (``REPRO_TRACE=1``) or
:func:`install`; disabled, every site is one global read plus a
``None`` check. ``snapshot()`` renders the registry as one plain dict;
``reset()`` is the trial flush (wired into ``ContinuousEngine.reset``).

**Pull collectors**: the one schema of the stats the engine reports,
``engine_kv_accounting`` / ``engine_prefix_stats`` /
``engine_spec_stats``; the engine's ``kv_accounting`` / ``prefix_stats``
/ ``spec_stats`` are thin aliases of them. :func:`snapshot` merges them
into the one dict the launcher consumes. The serving fabric's
collectors, ``worker_utilization`` (one per-rank row) and
``scheduler_census`` (the router's trial census), are the schema of its
``stats()``; ``snapshot(workers=)`` adds the per-rank rows.

No imports from ``repro_torch.serve``: the collectors duck-type their
argument, so serve modules import this registry without a cycle.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Iterable, List, Optional

import numpy as np


# ---------------------------------------------------------------------------
# Push registry
# ---------------------------------------------------------------------------

class Counter:
    """Monotonic accumulator (resets only at trial flush)."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Streaming summary: count/total/min/max plus a bounded sample
    reservoir for percentiles (the most recent ``cap`` samples: a
    serving trial's tail is what the percentiles should describe)."""

    __slots__ = ("count", "total", "min", "max", "_samples", "_cap",
                 "_lock")

    def __init__(self, cap: int = 4096):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._samples: List[float] = []
        self._cap = int(cap)
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)
            if len(self._samples) >= self._cap:
                self._samples.pop(0)
            self._samples.append(v)

    def summary(self) -> Dict[str, float]:
        with self._lock:
            if not self.count:
                return {"count": 0.0}
            s = np.asarray(self._samples)
            return {
                "count": float(self.count),
                "mean": self.total / self.count,
                "min": self.min,
                "max": self.max,
                "p50": float(np.percentile(s, 50)),
                "p95": float(np.percentile(s, 95)),
            }


class MetricsRegistry:
    """Named counter/gauge/histogram store with get-or-create access and
    one ``snapshot()``. Thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram()
            return h

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "counters": {k: c.value for k, c in sorted(counters.items())},
            "gauges": {k: g.value for k, g in sorted(gauges.items())},
            "histograms": {k: h.summary()
                           for k, h in sorted(histograms.items())},
        }

    def reset(self) -> None:
        """Trial flush: drop every metric (names re-create on next use)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


# ---------------------------------------------------------------------------
# Pull collectors: the one stats schema (the engine's methods are aliases)
# ---------------------------------------------------------------------------

def engine_kv_accounting(engine) -> dict:
    """HBM-efficiency evidence: total cache bytes (the sum of the pool
    tensors' ``nbytes``: the slot pool's scratch column and position rows
    included), bytes pinned per resident token (time-averaged over
    non-idle steps), and peak concurrent in-flight requests. The slot
    pool's token capacity is ``num_slots * cache_len``."""
    total = engine.kv.kv_bytes
    cap_tokens = (engine.kv.capacity_tokens if engine.kv_layout == "paged"
                  else engine.kv.num_slots * engine.cache_len)
    per_tok = total / max(1, cap_tokens)
    resident = max(1, engine._resident_tok_sum)
    return {
        "kv_layout": engine.kv_layout,
        "kv_bytes_total": float(total),
        "kv_capacity_tokens": float(cap_tokens),
        "kv_bytes_per_token": per_tok,
        # reserved/resident > 1 is over-reservation: memory pinned for
        # tokens that are not there (the slot pool's cache_len rounding)
        "kv_reserved_over_resident": engine._reserved_tok_sum / resident,
        "kv_bytes_per_resident_token":
            per_tok * engine._reserved_tok_sum / resident,
        "peak_concurrent": float(engine.peak_live),
    }


def engine_prefix_stats(engine) -> dict:
    """Prefix-cache evidence (empty when the cache is off): hit rate in
    tokens, prefill work saved, CoW clones, the modeled hit-path cost and
    the trie's own counters."""
    pc = engine.prefix_cache
    if pc is None:
        return {}
    return {
        "prefix_lookups": float(engine.prefix_lookups),
        "prefix_hits": float(engine.prefix_hits),
        "prefix_hit_rate": (engine.prefix_hit_tokens
                            / max(1, engine.prefix_prompt_tokens)),
        "prefill_tokens_saved": float(engine.prefix_hit_tokens),
        "prefill_dispatches_saved": float(engine.prefill_dispatches_saved),
        "prefix_cow_clones": float(engine.prefix_cow_clones),
        "prefix_modeled_hit_cost_us":
            1e6 * engine.scheduler.modeled_prefix_hit_cost_s,
        **pc.stats(),
    }


def engine_spec_stats(engine) -> dict:
    """Speculative-decoding evidence (empty when speculation is off):
    per-dispatch acceptance and the modeled §3.2 round cost the scheduler
    aggregated."""
    if not engine.speculate:
        return {}
    return {"speculate_k": float(engine.speculate),
            **engine.scheduler.spec_stats()}


def worker_utilization(worker) -> dict:
    """One per-rank row of the fabric's stats."""
    return {
        "rank": worker.rank,
        "role": worker.role,
        "steps": float(worker.total_steps),
        "busy_steps": float(worker.busy_steps),
        "utilization": (worker.busy_steps / worker.total_steps
                        if worker.total_steps else 0.0),
        "dispatched": float(worker.n_dispatched),
        "migrated_in": float(worker.n_migrated_in),
        "migrated_out": float(worker.n_migrated_out),
        "finished": float(worker.n_finished),
        "tokens": float(worker.tokens_out),
        # residual predicted work (0 after a drained trial): the JSQ key
        # the router balanced on
        "predicted_load_s": float(worker._load_s),
    }


def scheduler_census(scheduler, prefix: str = "router_") -> dict:
    """Trial-scoped census from a scheduler's rid-keyed ``req_log``:
    everything submitted this trial, what is still in flight, the arrival
    window, and the hop's admission accounting."""
    log = scheduler.req_log
    out = {
        prefix + "eager_admits": float(scheduler.n_eager_admits),
        prefix + "deferred": float(scheduler.n_deferred),
        prefix + "dispatch_cost_us": 1e6 * scheduler.modeled_admit_cost_s,
        prefix + "submitted": float(len(log)),
        prefix + "in_flight": float(sum(1 for r in log.values()
                                        if r.state != "done")),
    }
    if log:
        arr = [r.arrival for r in log.values()]
        out["arrival_span_s"] = max(arr) - min(arr)
    return out


def snapshot(engine=None, scheduler=None, workers: Iterable = (),
             registry: Optional[MetricsRegistry] = None,
             extra: Optional[dict] = None) -> dict:
    """The one merged stats dict the launcher consumes: latency
    percentiles from the scheduler's finished list, the engine's
    KV/prefix/spec accounting, per-rank utilization rows (``workers``,
    under ``"per_rank"``), and (when the push registry is live) its
    counters, gauges and histograms under ``"metrics"``."""
    out: dict = {}
    if scheduler is not None:
        out.update(scheduler.latency_stats())
    if engine is not None:
        if scheduler is None:
            out.update(engine.scheduler.latency_stats())
        out.update(engine.kv_accounting())
        out.update(engine.prefix_stats())
        out.update(engine.spec_stats())
    rows = [worker_utilization(w) for w in workers]
    if rows:
        out["per_rank"] = rows
    reg = registry if registry is not None else _REG
    if reg is not None:
        out["metrics"] = reg.snapshot()
    if extra:
        out.update(extra)
    return out


# ---------------------------------------------------------------------------
# Global activation: REPRO_TRACE turns on the whole obs subsystem (tracer
# + registry) with one switch.
# ---------------------------------------------------------------------------

_REG: Optional[MetricsRegistry] = None


def active() -> Optional[MetricsRegistry]:
    return _REG


def install() -> MetricsRegistry:
    global _REG
    _REG = MetricsRegistry()
    return _REG


def uninstall() -> None:
    global _REG
    _REG = None


def flush_trial() -> None:
    """Trial-boundary flush for reset hooks (no-op when off)."""
    reg = _REG
    if reg is not None:
        reg.reset()


def _truthy(v: str) -> bool:
    return v.strip().lower() in ("1", "true", "yes", "on")


if _truthy(os.environ.get("REPRO_TRACE", "")):
    install()
