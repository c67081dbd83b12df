"""The arithmetic of the end-to-end tails: what a request saw, on the
benchmark's own clock.

Every time here is the harness's ``perf_counter`` reading after the
engine step that made a token visible to the caller (the step returns
with its tokens read back to the host), minus when the request was due.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def percentile(values, q: float) -> Optional[float]:
    """The ``q``-th percentile (linear interpolation between the closest
    ranks, numpy's default); None for no values."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


class RequestClock:
    """What one request saw: when it fell due, when each of its tokens
    became visible. ``observe(generated, t)`` is called after every step
    with the request's token count; tokens that appear in one step
    become visible together (gaps of 0 after the first)."""

    __slots__ = ("due", "seen", "first", "last", "gaps")

    def __init__(self, due: float):
        self.due = due
        self.seen = 0
        self.first: Optional[float] = None
        self.last: Optional[float] = None
        self.gaps: List[float] = []

    def observe(self, generated: int, t: float) -> int:
        """Stamp the tokens that became visible at ``t``; returns how
        many."""
        new = generated - self.seen
        if new <= 0:
            return 0
        if self.first is None:
            self.first = t
            self.gaps.extend([0.0] * (new - 1))
        else:
            self.gaps.append(t - self.last)
            self.gaps.extend([0.0] * (new - 1))
        self.last = t
        self.seen = generated
        return new

    def ttft(self, window_end: float) -> float:
        """Time to first token; a request still without one at the
        window's end counts as ``window_end - due``, so a stall cannot
        hide."""
        if self.first is None:
            return window_end - self.due
        return self.first - self.due


def ttft_p95_ms(clocks, window_end: float) -> Optional[float]:
    """95th percentile of the time to first token over every request due
    in the window, in ms."""
    v = percentile([c.ttft(window_end) for c in clocks], 95)
    return None if v is None else 1e3 * v


def itl_p95_ms(clocks) -> Optional[float]:
    """95th percentile of every gap between consecutive visible tokens of
    one request, over all requests, in ms."""
    gaps = [g for c in clocks for g in c.gaps]
    v = percentile(gaps, 95)
    return None if v is None else 1e3 * v
