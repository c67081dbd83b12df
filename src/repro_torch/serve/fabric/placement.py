"""Placement policies for the serving fabric, the port's copy of the
reference's ``serve/fabric/placement.py`` (host code, unchanged).

A policy answers three questions the router rank asks:

* what **role** each engine rank plays (``roles``) — every rank a full
  prefill+decode replica, or dedicated prefill ranks feeding dedicated
  decode ranks;
* which rank receives a **new request** (``select_submit``) — always
  least-loaded / join-shortest-queue over the eligible ranks, the
  serving analogue of dealing messages to the emptiest cell queue;
* which rank receives a **migrating prefill** (``select_decode``) —
  disaggregated only: least-loaded decode rank *that can lease the
  request's full token budget right now* (the posted-receive gate of
  the rendezvous handoff; with no eligible rank the handoff stays held
  at its prefill rank, blocks still leased, and retries next step).

Load is the rank's predicted seconds of work
(:attr:`~repro_torch.serve.fabric.worker.EngineWorker.load`), so
join-shortest-queue self-balances even when a burst arrives in one router
step: each dispatch adds to the target's load before the next candidate
is placed.
"""

from __future__ import annotations

from typing import List, Optional, Sequence


class Placement:
    """Policy interface; see module docstring for the contract."""

    name = "?"
    #: True when the policy routes prefill-complete requests through the
    #: KV-block migration transport (the router then runs the migrate
    #: hop each step)
    needs_migration = False

    def roles(self, n_ranks: int) -> List[str]:
        raise NotImplementedError

    def select_submit(self, workers: Sequence) -> Optional[object]:
        """Least-loaded rank eligible for new requests, or None."""
        raise NotImplementedError

    def select_decode(self, workers: Sequence,
                      token_budget: int) -> Optional[object]:
        """Least-loaded decode rank able to lease ``token_budget`` tokens
        now, or None (the handoff waits at its prefill rank)."""
        return None

    @staticmethod
    def _least_loaded(cands) -> Optional[object]:
        cands = list(cands)
        if not cands:
            return None
        return min(cands, key=lambda w: (w.load, w.rank))


class ReplicatedPlacement(Placement):
    """Data parallelism: every rank is a full prefill+decode replica and
    new requests join the shortest queue. The static analogue is
    ``shard_trace`` fan-out; the router's JSQ is the dynamic version
    (it sees actual queue depths, not just arrival indices)."""

    name = "replicated"
    needs_migration = False

    def roles(self, n_ranks: int) -> List[str]:
        if n_ranks < 1:
            raise ValueError("need at least one engine rank")
        return ["full"] * n_ranks

    def select_submit(self, workers):
        return self._least_loaded(workers)


class DisaggregatedPlacement(Placement):
    """Prefill/decode disaggregation: ``n_prefill`` ranks run
    prompt-deposit only (``role="prefill"`` engines, prompt-sized block
    leases) and stream finished KV block-by-block to the decode ranks,
    which never prefill. Separating the phases keeps the long-running
    decode pool free of prefill head-of-line stalls entirely — the
    decode ranks' micro-steps never share a dispatch with chunk work."""

    name = "disagg"
    needs_migration = True

    def __init__(self, n_prefill: int = 1):
        if n_prefill < 1:
            raise ValueError("need at least one prefill rank")
        self.n_prefill = int(n_prefill)

    def roles(self, n_ranks: int) -> List[str]:
        if n_ranks < 2:
            raise ValueError("disaggregation needs >= 2 engine ranks "
                             "(prefill + decode)")
        if self.n_prefill >= n_ranks:
            raise ValueError(
                f"n_prefill={self.n_prefill} leaves no decode rank of "
                f"{n_ranks}")
        return (["prefill"] * self.n_prefill
                + ["decode"] * (n_ranks - self.n_prefill))

    def select_submit(self, workers):
        return self._least_loaded(w for w in workers
                                  if w.role == "prefill")

    def select_decode(self, workers, token_budget: int):
        return self._least_loaded(
            w for w in workers
            if w.role == "decode" and w.engine.kv.can_admit(token_budget))


def make_placement(name: str, n_prefill: int = 1) -> Placement:
    """Policy by CLI name (``--fabric replicated|disagg``)."""
    if name == "replicated":
        return ReplicatedPlacement()
    if name == "disagg":
        return DisaggregatedPlacement(n_prefill)
    raise ValueError(f"unknown placement {name!r} "
                     "(expected 'replicated' or 'disagg')")
