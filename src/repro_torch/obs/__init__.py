"""Observability of the port — the twin of ``src/repro/obs/``
(DESIGN.md §15): span tracing, the metrics registry, and
modeled-vs-measured cost residuals.

Off by default; when off, every instrumented site is one module-global
read plus a ``None`` check. ``REPRO_TRACE=1`` (or :func:`install`) turns
on the whole subsystem: the span tracer (:mod:`repro_torch.obs.trace`),
the push-metrics registry (:mod:`repro_torch.obs.metrics`) and the
residual ledger the tracer owns (:mod:`repro_torch.obs.residuals`).
"""

from __future__ import annotations

from repro_torch.obs import metrics, residuals, trace
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.residuals import ResidualLedger, merge_reports
from repro_torch.obs.trace import Span, Tracer


def install(capacity: int = trace.DEFAULT_CAPACITY) -> Tracer:
    """Turn on the full subsystem (tracer + registry); returns the
    tracer. Equivalent to launching under ``REPRO_TRACE=1``."""
    metrics.install()
    return trace.install(capacity=capacity)


def uninstall() -> None:
    trace.uninstall()
    metrics.uninstall()


def flush_trial() -> None:
    """Trial-boundary flush (residual ledger + push registry), wired into
    ``ContinuousEngine.reset`` so warm-up never aggregates into a
    measured trial. No-op when off."""
    trace.flush_trial()
    metrics.flush_trial()


__all__ = [
    "MetricsRegistry", "ResidualLedger", "Span", "Tracer",
    "flush_trial", "install", "merge_reports", "metrics", "residuals",
    "trace", "uninstall",
]
