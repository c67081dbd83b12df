"""Lease ledger for the runtime sanitizer (the port of
``src/repro/analysis/ledger.py``, DESIGN.md §11): allocation provenance
for pool resources (KV blocks, request rows).

The pools themselves (``BlockPool``/``PagedKVCache``/``SlotKVCache``)
enforce correctness permanently — double free and refcount underflow
raise, ``reset()`` warns on leaked leases. The ledger adds what the
permanent checks cannot afford to keep: the *site* (file:line) where
every live lease was allocated and where a freed lease was released, so
a double free reports "allocated at X, first freed at Y" instead of just
the owner, and a leak at reset names where the leak was created.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Hashable, List, Optional, Tuple


@dataclass
class LeaseRecord:
    """One resource lease: who allocated it, where, and (after release)
    where it was last freed. Shared leases (prefix caching) also carry
    every ``ref()`` site and every shared (non-final) ``free()`` site,
    so an N-way-shared block's history reads end to end."""
    owner: object
    alloc_site: str
    free_site: Optional[str] = None
    refs: int = 1
    ref_sites: List[str] = field(default_factory=list)
    shared_free_sites: List[str] = field(default_factory=list)


@dataclass
class LeaseLedger:
    """Provenance tracking for a family of resource pools.

    Keys are ``(pool_key, resource_id)`` — the sanitizer uses
    ``id(pool)`` as the pool key, so two pools never alias. Freed
    records are retained (with their free site) until the pool resets,
    which is what makes double-free provenance possible.
    """

    _live: Dict[Tuple[Hashable, int], LeaseRecord] = field(
        default_factory=dict)
    _freed: Dict[Tuple[Hashable, int], LeaseRecord] = field(
        default_factory=dict)

    def on_alloc(self, pool: Hashable, resource: int, owner: object,
                 site: str) -> None:
        key = (pool, resource)
        self._freed.pop(key, None)
        self._live[key] = LeaseRecord(owner=owner, alloc_site=site)

    def on_ref(self, pool: Hashable, resource: int,
               owner: object = None, site: Optional[str] = None) -> None:
        """A shared reference was added (prefix lease / CoW source);
        records who took it and where."""
        rec = self._live.get((pool, resource))
        if rec is not None:
            rec.refs += 1
            if site is not None:
                rec.ref_sites.append(
                    site if owner is None else f"{site} by {owner!r}")

    def on_release(self, pool: Hashable, resource: int, site: str) -> None:
        """One reference dropped; the resource fully freed when refs hit
        zero (mirrors ``BlockPool.free`` semantics). Non-final drops of
        a shared lease keep their site for provenance."""
        key = (pool, resource)
        rec = self._live.get(key)
        if rec is None:
            return
        rec.refs -= 1
        if rec.refs <= 0:
            rec.free_site = site
            self._freed[key] = rec
            del self._live[key]
        elif rec.ref_sites:
            rec.shared_free_sites.append(site)

    @staticmethod
    def _shared_history(rec: LeaseRecord) -> str:
        if not rec.ref_sites:
            return ""
        msg = (f", shared {len(rec.ref_sites) + 1}-way "
               f"(ref'd at {', '.join(rec.ref_sites)})")
        if rec.shared_free_sites:
            msg += (", shared refs freed at "
                    + ", ".join(rec.shared_free_sites))
        return msg

    def provenance(self, pool: Hashable, resource: int) -> str:
        """Human-readable history of a resource — the double-free
        diagnostic ("allocated at X, first freed at Y"), including the
        full ref/free chain of a shared (prefix-cached / CoW) lease."""
        rec = self._freed.get((pool, resource))
        if rec is not None:
            return (f"allocated at {rec.alloc_site} by {rec.owner!r}"
                    + self._shared_history(rec)
                    + f", first freed at {rec.free_site}")
        rec = self._live.get((pool, resource))
        if rec is not None:
            return (f"still live; allocated at {rec.alloc_site} by "
                    f"{rec.owner!r}" + self._shared_history(rec))
        return "no recorded lease"

    def live_for(self, pool: Hashable) -> List[Tuple[int, LeaseRecord]]:
        """Leases still outstanding against ``pool`` — the leak set a
        ``reset()`` should find empty."""
        return sorted((res, rec) for (p, res), rec in self._live.items()
                      if p == pool)

    def forget_pool(self, pool: Hashable) -> None:
        """Drop every record for ``pool`` (called at pool reset, after
        the leak check — a fresh pool starts with a clean history)."""
        for d in (self._live, self._freed):
            for key in [k for k in d if k[0] == pool]:
                del d[key]
