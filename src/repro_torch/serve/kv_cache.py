"""Lease errors of the serving pools (the reference's
``serve/kv_cache.py``). The slot-pool cache itself, ``SlotKVCache``,
arrives with the slice of the port that brings the slot layout."""

from __future__ import annotations


class SlotError(RuntimeError):
    """Pool misuse (double free, exhaustion, lease overrun)."""


class LeaseLeakError(SlotError):
    """Live leases found where a clean pool was required (``strict=True``
    reset). The message names every leaked owner."""


class LeaseLeakWarning(UserWarning):
    """Live leases found at reset (non-strict): the pool is wiped anyway,
    but the leak — requests that never reached ``free`` — is named so it
    can't pass silently."""
