"""Static and runtime invariant analysis of the port (the twin of
``src/repro/analysis/``, DESIGN.md §11).

Two halves:

* :mod:`repro_torch.analysis.lint` / :mod:`repro_torch.analysis.rules` —
  AST lint for the port's invariants (filtered index writes into device
  pools and carried state, in-place steps, Request lifecycles, stream
  ordering, host syncs in the model's step bodies). Run
  ``python -m repro_torch.analysis.lint``; the port's tree lints clean.
* :mod:`repro_torch.analysis.sanitizer` — the runtime threadcomm
  sanitizer (``REPRO_SANITIZE=1``): happens-before tracking over comm
  ops (:mod:`repro_torch.analysis.hb`), lease provenance over the
  serving pools (:mod:`repro_torch.analysis.ledger`), unmatched requests
  at ``finish()``, accidental-serialization hazards, migration
  completeness.

This package must stay import-light: ``core/comm.py`` and the serving
pools import :mod:`repro_torch.analysis.sanitizer` at module load to
reach their hooks, so nothing here may import back into
``repro_torch.core`` or ``repro_torch.serve``.
"""

from repro_torch.analysis.sanitizer import (SanitizerError, SanitizerFinding,
                                            ThreadSanitizer, active, install,
                                            uninstall)

__all__ = [
    "SanitizerError",
    "SanitizerFinding",
    "ThreadSanitizer",
    "active",
    "install",
    "uninstall",
]
