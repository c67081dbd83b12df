"""Paged KV substrate: a global pool of fixed-size KV blocks leased
through per-request block tables (the reference's
``serve/block_pool.py``).

One cell of the paper's cell pool is one KV *block* of ``block_size``
tokens; a request leases exactly the blocks its tokens occupy, so
admission gates on free blocks instead of free slots.

* :class:`BlockPool` — the host-side allocator: O(1) free-list
  alloc/free, per-block reference counts (a block backs every request
  sharing its prefix, and the prefix cache holds a reference of its
  own), owners recorded for error reporting, and an optional reclaimer
  (the prefix cache) whose parked blocks count as free and are evicted
  when ``alloc`` runs short.
* :class:`PagedKVCache` — the engine-facing cache: the device pool
  (``model.init_paged_cache``), a fixed set of request rows, one block
  table per row, and a device copy of the tables that is rebuilt only
  after an alloc, free or reset. For the SSM and hybrid families the
  pool also holds each request row's carried state (conv/ssm leaves,
  row-aligned, ``(L, num_slots, ...)``), for the encoder-decoder its
  cross K/V (``cross_k``/``cross_v``, the same way); an attention-free
  model's pool
  holds the state alone. ``alloc_prefix`` backs a row partly with
  cached prefix blocks (prefix caching).

Host-side length and refcount bookkeeping is ``np.int32``, the dtype of
the device positions and tables.
"""

from __future__ import annotations

import warnings
from typing import List, Optional

import numpy as np
import torch

from repro_torch.analysis.sanitizer import active as _san_active
from repro_torch.obs.metrics import active as _reg_active
from repro_torch.obs.trace import active as _tr_active
from repro_torch.serve.kv_cache import (LeaseLeakError, LeaseLeakWarning,
                                        SlotError, check_same_buffers)


class BlockPool:
    """O(1) free-list allocator over a fixed population of KV blocks."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1:
            raise SlotError("need at least one block")
        if block_size < 1:
            raise SlotError("block_size must be >= 1")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._ref = np.zeros((num_blocks,), np.int32)
        self._owner: List[Optional[object]] = [None] * num_blocks
        self._last_owner: List[Optional[object]] = [None] * num_blocks
        self._reclaimer = None        # e.g. a PrefixCache

    def attach_reclaimer(self, reclaimer) -> None:
        """Register a deferred reclaimer (the prefix cache): its
        evictable parked blocks count as free (``num_free``), ``alloc``
        asks it to ``reclaim`` when the free list runs short, and
        ``free`` tells it when a block's last reference may be its own
        (``on_sole_ref``)."""
        if self._reclaimer is not None and self._reclaimer is not reclaimer:
            raise SlotError("pool already has a reclaimer attached")
        self._reclaimer = reclaimer

    @property
    def num_free(self) -> int:
        free = len(self._free)
        if self._reclaimer is not None:
            free += self._reclaimer.evictable()
        return free

    @property
    def num_live(self) -> int:
        return self.num_blocks - len(self._free)

    def refcount(self, block: int) -> int:
        return int(self._ref[block])

    def owner(self, block: int):
        return self._owner[block]

    def blocks_needed(self, ntokens: int) -> int:
        """Table entries a request of ``ntokens`` tokens occupies."""
        if ntokens < 0:
            raise SlotError(f"negative token count {ntokens}")
        return -(-int(ntokens) // self.block_size)

    def alloc(self, n: int, owner: object) -> List[int]:
        """Lease ``n`` blocks for ``owner`` (refcount 1 each). Raises on
        exhaustion — admission control must gate on ``num_free``."""
        if owner is None:
            raise SlotError("block owner must be non-None")
        if n > len(self._free) and self._reclaimer is not None:
            # evict parked prefix-cache blocks (LRU) until the free list
            # covers the request
            self._reclaimer.reclaim(n - len(self._free))
        if n > len(self._free):
            raise SlotError(
                f"block pool exhausted: need {n}, have {len(self._free)} "
                "(admission must gate on num_free)")
        blocks = [self._free.pop() for _ in range(n)]
        for b in blocks:
            self._ref[b] = 1
            self._owner[b] = owner
            self._last_owner[b] = owner
        san = _san_active()
        if san is not None:       # lease ledger records the alloc site
            san.on_lease_alloc(self, blocks, owner)
        self._observe_occupancy()
        return blocks

    def ref(self, block: int, owner: object = None) -> None:
        """Add a reference to a live block (a shared-prefix lease);
        ``owner`` feeds the sanitizer ledger's shared-ref provenance."""
        if self._ref[block] < 1:
            raise SlotError(f"ref of free block {block}")
        self._ref[block] += 1
        san = _san_active()
        if san is not None:
            san.on_lease_ref(self, block, owner)

    def free(self, blocks) -> None:
        """Drop one reference per block; blocks reaching zero return to
        the free list. Double-free names the last owner (and, under the
        sanitizer, where the block was allocated and first freed)."""
        san = _san_active()
        for b in blocks:
            if self._ref[b] < 1:
                msg = (f"double free of block {b} "
                       f"(last owner {self._last_owner[b]!r})")
                if san is not None:
                    msg += "; " + san.on_double_free(
                        self, b, self._last_owner[b])
                raise SlotError(msg)
            self._ref[b] -= 1
            if self._ref[b] == 0:
                self._owner[b] = None
                self._free.append(b)
            elif self._ref[b] == 1 and self._reclaimer is not None:
                # the survivor may be the reclaimer's own reference: it
                # parks the block if so
                self._reclaimer.on_sole_ref(b)
            if san is not None:
                san.on_lease_release(self, b)
        self._observe_occupancy()

    def _observe_occupancy(self) -> None:
        """Telemetry: block-pool occupancy as a ``block_pool`` counter
        track and two registry gauges, sampled at lease transitions (alloc
        and free are the only places occupancy moves)."""
        tr = _tr_active()
        if tr is not None:
            free = len(self._free)
            tr.counter("block_pool", free=free,
                       live=self.num_blocks - free)
        reg = _reg_active()
        if reg is not None:
            reg.gauge("block_pool.free_blocks").set(len(self._free))
            reg.gauge("block_pool.live_blocks").set(
                self.num_blocks - len(self._free))

    def reset(self, *, strict: bool = False) -> None:
        """Wipe every lease. Blocks still live are leaks and are named:
        warn (:class:`LeaseLeakWarning`) by default, raise
        (:class:`LeaseLeakError`) under ``strict=True``."""
        leaked = [(b, self._owner[b]) for b in range(self.num_blocks)
                  if self._ref[b] > 0]
        san = _san_active()
        if san is not None:       # ledger adds allocation provenance
            san.on_pool_reset(self)
        if leaked:
            msg = (f"reset with {len(leaked)} live block lease(s): "
                   + ", ".join(f"block {b} (owner {o!r})"
                               for b, o in leaked[:8])
                   + (f", ... {len(leaked) - 8} more" if len(leaked) > 8
                      else ""))
            if strict:
                raise LeaseLeakError(msg)
            warnings.warn(msg, LeaseLeakWarning, stacklevel=2)
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self._ref[:] = 0
        self._owner = [None] * self.num_blocks
        if self._reclaimer is not None:
            # every lease, the reclaimer's included, was just wiped: it
            # drops its index without freeing anything again
            self._reclaimer.on_pool_reset()


class PagedKVCache:
    """Paged decode-state cache: fixed request rows + leased KV blocks.

    ``num_slots`` is the decode batch width (request rows); the block
    pool is sized independently by ``num_blocks``. A request's admission
    cost is ``blocks_for(prompt + max_new)`` blocks, reserved up front so
    a live request never runs out mid-decode, plus one row.
    """

    def __init__(self, model, *, num_blocks: int, block_size: int,
                 num_slots: int, max_blocks_per_req: int):
        if num_slots < 1:
            raise SlotError("need at least one request row")
        if max_blocks_per_req < 1:
            raise SlotError("max_blocks_per_req must be >= 1")
        self.model = model
        self.num_slots = int(num_slots)
        self.block_size = int(block_size)
        self.max_blocks_per_req = int(max_blocks_per_req)
        self.pool = BlockPool(num_blocks, block_size)
        self._buf = model.init_paged_cache(num_blocks, block_size,
                                           num_rows=num_slots)
        self._tables = np.full((num_slots, max_blocks_per_req), -1, np.int32)
        self._tables_dev: Optional[torch.Tensor] = None
        self._free_rows: List[int] = list(range(num_slots - 1, -1, -1))
        self._owner: List[Optional[object]] = [None] * num_slots
        self._last_owner: List[Optional[object]] = [None] * num_slots
        self._nblocks = np.zeros((num_slots,), np.int32)
        self._len = np.zeros((num_slots,), np.int32)

    # -- pool / row accounting ---------------------------------------------
    @property
    def num_free(self) -> int:
        """Free request rows (block availability is the second gate)."""
        return len(self._free_rows)

    @property
    def num_live(self) -> int:
        return self.num_slots - len(self._free_rows)

    @property
    def num_free_blocks(self) -> int:
        return self.pool.num_free

    @property
    def live_slots(self) -> List[int]:
        return [s for s in range(self.num_slots) if self._owner[s] is not None]

    def owner(self, slot: int):
        return self._owner[slot]

    def length(self, slot: int) -> int:
        return int(self._len[slot])

    @property
    def lengths(self) -> np.ndarray:
        return self._len.copy()

    def blocks_for(self, ntokens: int) -> int:
        return self.pool.blocks_needed(ntokens)

    def blocks_of(self, slot: int) -> List[int]:
        """The block ids leased to ``slot``, in table order."""
        if self._owner[slot] is None:
            raise SlotError(f"blocks_of free row {slot}")
        return self._tables[slot, :int(self._nblocks[slot])].tolist()

    def _check_table_cap(self, ntokens: int) -> int:
        nb = self.blocks_for(ntokens)
        if nb > self.max_blocks_per_req:
            raise SlotError(
                f"request of {ntokens} tokens needs {nb} blocks > "
                f"max_blocks_per_req={self.max_blocks_per_req}")
        return nb

    def can_admit(self, ntokens: int, hit=None) -> bool:
        """One free row + enough free blocks for ``ntokens`` tokens. With
        a :class:`~repro_torch.serve.prefix_cache.PrefixHit` only the miss
        tail needs fresh blocks, but the hit's parked blocks stop being
        evictable once leased, so they come off the (free + evictable)
        headroom."""
        nb = self._check_table_cap(ntokens)
        if not self._free_rows:
            return False
        if hit is None:
            return nb <= self.pool.num_free
        return nb - len(hit.blocks) <= self.pool.num_free - hit.n_parked

    # -- lease lifecycle ---------------------------------------------------
    def _take_row(self, owner: object) -> None:
        if owner is None:
            raise SlotError("row owner must be non-None")
        if not self._free_rows:
            raise SlotError("request rows exhausted (admission must gate "
                            "on num_free)")

    def _install_row(self, owner: object, blocks: List[int]) -> int:
        slot = self._free_rows.pop()
        self._owner[slot] = owner
        self._last_owner[slot] = owner
        self._tables[slot, :] = -1
        self._tables[slot, :len(blocks)] = np.asarray(blocks, np.int32)
        self._tables_dev = None
        self._nblocks[slot] = len(blocks)
        self._len[slot] = 0
        return slot

    def alloc(self, owner: object, ntokens: int) -> int:
        """Claim a request row and lease the blocks ``ntokens`` tokens
        will occupy. Raises on row/block exhaustion."""
        self._take_row(owner)
        nb = self._check_table_cap(ntokens)
        blocks = self.pool.alloc(nb, owner)   # raises before row is taken
        return self._install_row(owner, blocks)

    def alloc_prefix(self, owner: object, ntokens: int, hit, cache) -> int:
        """Claim a row backed partly by cached prefix blocks: the hit's
        blocks are leased at refcount + 1 through ``cache.lease`` (the
        CoW source as a temporary reference) and only the miss tail is
        allocated fresh. Leasing first means a reclaim triggered by the
        fresh allocation can never evict a block this request hit."""
        self._take_row(owner)
        nb = self._check_table_cap(ntokens)
        shared = list(hit.blocks)
        cache.lease(hit, owner)
        try:
            fresh = self.pool.alloc(nb - len(shared), owner)
        except SlotError:
            # unwind the shared leases; admission should have gated
            if hit.cow_src is not None:
                self.pool.free([hit.cow_src])
            self.pool.free(shared)
            raise
        return self._install_row(owner, shared + fresh)

    def free(self, slot: int) -> None:
        if self._owner[slot] is None:
            raise SlotError(
                f"double free of request row {slot} "
                f"(last owner {self._last_owner[slot]!r})")
        nb = int(self._nblocks[slot])
        self.pool.free(self._tables[slot, :nb].tolist())
        self._tables[slot, :] = -1
        self._tables_dev = None
        self._nblocks[slot] = 0
        self._owner[slot] = None
        self._len[slot] = 0
        self._free_rows.append(slot)

    def advance(self, slot: int, n: int = 1) -> None:
        """Account ``n`` more resident tokens in ``slot``. The lease
        already covers them; overrunning it is a bug."""
        if self._owner[slot] is None:
            raise SlotError(f"advance on free row {slot}")
        new = int(self._len[slot]) + int(n)
        if new > int(self._nblocks[slot]) * self.block_size:
            raise SlotError(
                f"row {slot} (owner {self._owner[slot]!r}) overran its "
                f"lease: {new} tokens > {int(self._nblocks[slot])} blocks "
                f"x {self.block_size}")
        self._len[slot] = new

    # -- tables / buffers --------------------------------------------------
    def table_rows(self, slots) -> np.ndarray:
        """(len(slots), max_blocks_per_req) int32 copies for a chunk
        dispatch; out-of-range row indices yield all ``-1`` rows."""
        out = np.full((len(slots), self.max_blocks_per_req), -1, np.int32)
        for i, s in enumerate(slots):
            if 0 <= s < self.num_slots:
                out[i] = self._tables[s]
        return out

    def tables_device(self) -> torch.Tensor:
        """The full (num_slots, max_blocks_per_req) int32 table on the
        model's device — the decode dispatch's indirection input. Cached:
        tables change only at alloc/free/reset, so a decode step with no
        admission or finish pays no host-to-device copy."""
        if self._tables_dev is None:
            self._tables_dev = torch.as_tensor(self._tables).to(
                self.model.device)
        return self._tables_dev

    @property
    def buffers(self):
        """The pooled cache (k/v: (L, P, bs, Gs, hd); conv/ssm or
        cross_k/cross_v: (L, num_slots, ...)), written in place by the
        model's steps."""
        return self._buf

    def swap_buffers(self, new_buf) -> None:
        """The reference's install of a step's donated output; here a
        check that ``new_buf`` is the pool itself
        (:func:`~repro_torch.serve.kv_cache.check_same_buffers`)."""
        check_same_buffers(self._buf, new_buf)

    # -- accounting --------------------------------------------------------
    @property
    def capacity_tokens(self) -> int:
        return self.pool.num_blocks * self.block_size

    @property
    def resident_capacity_tokens(self) -> int:
        """Token capacity currently leased by live requests."""
        return int(self._nblocks.sum()) * self.block_size

    @property
    def kv_bytes(self) -> int:
        """Device bytes of every leaf, the carried state included."""
        return int(sum(t.numel() * t.element_size()
                       for t in self._buf.values()))

    def reset(self, *, strict: bool = False) -> None:
        """Return every row and block to the free pools. Rows still
        occupied are lease leaks and are named (warn, or raise under
        ``strict=True``)."""
        leaked = [(s, self._owner[s]) for s in range(self.num_slots)
                  if self._owner[s] is not None]
        if leaked:
            msg = (f"reset with {len(leaked)} live request row(s): "
                   + ", ".join(f"row {s} (owner {o!r})" for s, o in leaked))
            if strict:
                raise LeaseLeakError(msg)
            warnings.warn(msg, LeaseLeakWarning, stacklevel=2)
            # the row check already named this reset's leak
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", LeaseLeakWarning)
                self.pool.reset()
        else:
            self.pool.reset(strict=strict)
        self._tables[:] = -1
        self._tables_dev = None
        self._free_rows = list(range(self.num_slots - 1, -1, -1))
        self._owner = [None] * self.num_slots
        self._nblocks[:] = 0
        self._len[:] = 0

    def reset_rows(self, *, strict: bool = False) -> None:
        """Free every request row (and its lease) but keep the rest of
        the pool: the prefix cache's parked index and the device
        buffers. The warm-cache reset. Occupied rows are leaks, named as
        :meth:`reset` names them, then freed through the ordinary path,
        so shared blocks fall back to the cache (parked)."""
        leaked = [(s, self._owner[s]) for s in range(self.num_slots)
                  if self._owner[s] is not None]
        if leaked:
            msg = (f"reset with {len(leaked)} live request row(s): "
                   + ", ".join(f"row {s} (owner {o!r})" for s, o in leaked))
            if strict:
                raise LeaseLeakError(msg)
            warnings.warn(msg, LeaseLeakWarning, stacklevel=2)
            for s, _ in leaked:
                self.free(s)
        self._tables_dev = None
