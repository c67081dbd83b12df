"""Vector clocks for the runtime threadcomm sanitizer: the port of
``src/repro/analysis/hb.py`` (DESIGN.md §11), pure Python, kept as the
port's own copy.

The sanitizer models every execution context that can issue communication
— each ``CommStream`` plus one implicit "host" context per root threadcomm
— as a vector-clock process. Issues tick the issuing context's clock;
``wait()`` merges the request's issue-time snapshot into the waiter's
context; entering a stream merges the parent context (program order flows
into the stream). Two operations are *concurrent* — the paper's §2
accidental-serialization precondition — exactly when neither snapshot
happens-before the other.
"""

from __future__ import annotations

from typing import Dict, Hashable


class VectorClock:
    """A sparse vector clock over hashable context keys."""

    __slots__ = ("_c",)

    def __init__(self, init: Dict[Hashable, int] = None):
        self._c: Dict[Hashable, int] = dict(init) if init else {}

    def tick(self, ctx: Hashable) -> int:
        """Advance this clock's component for ``ctx``; returns the new
        component value."""
        v = self._c.get(ctx, 0) + 1
        self._c[ctx] = v
        return v

    def merge(self, other: "VectorClock") -> None:
        """Pointwise max — the happens-before join (message receive)."""
        for k, v in other._c.items():
            if v > self._c.get(k, 0):
                self._c[k] = v

    def copy(self) -> "VectorClock":
        return VectorClock(self._c)

    def leq(self, other: "VectorClock") -> bool:
        """True iff self happens-before-or-equals other (pointwise <=)."""
        return all(v <= other._c.get(k, 0) for k, v in self._c.items())

    def concurrent_with(self, other: "VectorClock") -> bool:
        """Neither snapshot ordered before the other: a real race window."""
        return not self.leq(other) and not other.leq(self)

    def __repr__(self) -> str:  # debugging aid only
        return f"VectorClock({self._c!r})"
