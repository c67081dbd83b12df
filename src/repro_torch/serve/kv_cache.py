"""Slot-pool KV cache for continuous batching, and the lease errors of the
serving pools (the reference's ``serve/kv_cache.py``).

The decode state of every in-flight request lives in one cache of
fixed-capacity *slots*, one row per request: the model's slot cache
(``model.init_cache(num_slots, cache_len)``: k/v ``(L, num_slots, W + 1,
Gs, hd)``, pos ``(num_slots, W + 1)``, and for the SSM and hybrid
families the carried state conv/ssm ``(L, num_slots, ...)``, for the
encoder-decoder the cross K/V ``(L, num_slots, encoder_seq, Hkv, hd)``;
an attention-free cache holds the state alone). Requests are admitted by
allocating a slot and depositing their prefilled cache into it (or by
blanking it and streaming the prompt in chunk by chunk); they retire by
freeing the slot, whose rows the next occupant overwrites.

* **Fixed pool, O(1) alloc/free.** Slots are the bounded resource the
  scheduler's cell queue admits against.
* **Per-slot independent state.** Each slot carries its own KV rows and
  position row, so decode over the pool is one batched step over every
  slot with per-slot positions.
* **In place.** Inserts, blanking and the model's steps write the pool's
  tensors in place; PyTorch has no buffer donation to stand in for.

Host-side length bookkeeping is ``np.int32``, the dtype of the device
positions.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch


class SlotError(RuntimeError):
    """Pool misuse (double free, exhaustion, lease overrun)."""


class LeaseLeakError(SlotError):
    """Live leases found where a clean pool was required (``strict=True``
    reset). The message names every leaked owner."""


class LeaseLeakWarning(UserWarning):
    """Live leases found at reset (non-strict): the pool is wiped anyway,
    but the leak — requests that never reached ``free`` — is named so it
    can't pass silently."""


def check_same_buffers(buf: Dict[str, torch.Tensor], new_buf) -> None:
    """``swap_buffers``'s check: the reference installs a step's donated
    output pool; the port's steps write the pool in place, so what comes
    back must be the pool's own tensors (a copy would be a lost write)."""
    if new_buf is buf:
        return
    if not (isinstance(new_buf, dict) and new_buf.keys() == buf.keys()
            and all(new_buf[k] is t for k, t in buf.items())):
        raise SlotError("swap_buffers: the buffers handed back are not the "
                        "pool's own tensors (the port's steps write the "
                        "pool in place; nothing is swapped)")


#: the slot axis of each cache leaf (k/v and the carried state, recurrent
#: or cross-attention, are layer-major)
_SLOT_AXIS = {"k": 1, "v": 1, "pos": 0, "conv": 1, "ssm": 1, "cross_k": 1,
              "cross_v": 1}


class SlotKVCache:
    """Fixed pool of per-request decode-state slots."""

    def __init__(self, model, cache_len: int, num_slots: int):
        if num_slots < 1:
            raise SlotError("need at least one slot")
        self.cache_len = int(cache_len)
        self.num_slots = int(num_slots)
        self._buf = model.init_cache(num_slots, cache_len)
        self._device = next(iter(self._buf.values())).device
        self._free: List[int] = list(range(num_slots - 1, -1, -1))
        self._owner: List[Optional[object]] = [None] * num_slots
        self._last_owner: List[Optional[object]] = [None] * num_slots
        # tokens resident per slot (prompt + generated)
        self._len = np.zeros((num_slots,), np.int32)

    # -- fixed-shape row views (chunked prefill) ---------------------------
    def rows_at(self, slots) -> Dict[str, torch.Tensor]:
        """A copy of the cache rows of ``slots`` (a host sequence): a slot
        cache of ``len(slots)`` rows. Out-of-range indices clamp, as the
        reference's gather does (their rows are never written back)."""
        idx = torch.as_tensor(np.clip(np.asarray(slots, np.int64), 0,
                                      self.num_slots - 1),
                              device=self._device)
        return {k: b.index_select(_SLOT_AXIS[k], idx)
                for k, b in self._buf.items()}

    def rows_into(self, rows: Dict[str, torch.Tensor], slots) -> None:
        """Scatter rows back at ``slots``: the inverse of :meth:`rows_at`.
        Out-of-range indices write nothing (the reference's drop mode),
        decided on the host, so the scatter never syncs."""
        slots = np.asarray(slots, np.int64)
        keep = np.flatnonzero((slots >= 0) & (slots < self.num_slots))
        if keep.size == 0:
            return
        dst = torch.as_tensor(slots[keep], device=self._device)
        src = torch.as_tensor(keep, device=self._device)
        for k, b in self._buf.items():
            ax = _SLOT_AXIS[k]
            b.index_copy_(ax, dst, rows[k].index_select(ax, src).to(b.dtype))

    # -- pool management ---------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_live(self) -> int:
        return self.num_slots - len(self._free)

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

    def alloc(self, owner: object) -> int:
        """Claim a free slot for ``owner``. Raises on exhaustion — admission
        control (the scheduler's cell queue) must gate on ``num_free``."""
        if owner is None:
            raise SlotError("slot owner must be non-None")
        if not self._free:
            raise SlotError("slot pool exhausted (admission must gate on "
                            "num_free)")
        slot = self._free.pop()
        self._owner[slot] = owner
        self._last_owner[slot] = owner
        self._len[slot] = 0
        return slot

    def free(self, slot: int) -> None:
        if self._owner[slot] is None:
            raise SlotError(f"double free of slot {slot} "
                            f"(last owner {self._last_owner[slot]!r})")
        self._owner[slot] = None
        self._len[slot] = 0
        self._free.append(slot)

    # -- buffer access -----------------------------------------------------
    @property
    def buffers(self) -> Dict[str, torch.Tensor]:
        """The pool's cache (k/v: (L, num_slots, W+1, Gs, hd), pos:
        (num_slots, W+1); conv/ssm: (L, num_slots, ...)), written in place
        by the model's steps."""
        return self._buf

    def swap_buffers(self, new_buf) -> None:
        """The reference's install of a step's donated output; here a
        check that ``new_buf`` is the pool itself
        (:func:`check_same_buffers`)."""
        check_same_buffers(self._buf, new_buf)

    @property
    def kv_bytes(self) -> int:
        """Device bytes of every leaf, the scratch column and the position
        rows included."""
        return int(sum(t.numel() * t.element_size()
                       for t in self._buf.values()))

    def insert(self, slot: int, request_cache: Dict[str, Any],
               length: int) -> None:
        """Deposit a prefilled one-row cache (``model.prefill`` of one
        prompt) into ``slot``, in place."""
        if self._owner[slot] is None:
            raise SlotError(f"insert into free slot {slot}")
        for k, b in self._buf.items():
            one = request_cache[k].select(_SLOT_AXIS[k], 0)
            b.select(_SLOT_AXIS[k], slot).copy_(one)
        self._len[slot] = int(length)

    def advance(self, slot: int, n: int = 1) -> None:
        """Account ``n`` more resident tokens in ``slot``."""
        if self._owner[slot] is None:
            raise SlotError(f"advance on free slot {slot}")
        self._len[slot] += n

    # -- chunked prefill (incremental deposit) -----------------------------
    def reset_slot(self, slot: int) -> None:
        """Blank a live slot before streaming a prompt into it chunk by
        chunk: positions to -1, k/v and the carried state to zeros. A
        chunked deposit *appends* entries, so the previous occupant's must
        not alias as valid history."""
        if self._owner[slot] is None:
            raise SlotError(f"reset of free slot {slot}")
        for k, b in self._buf.items():
            b.select(_SLOT_AXIS[k], slot).fill_(-1 if k == "pos" else 0)
        self._len[slot] = 0

    def take_rows(self, slots) -> Dict[str, torch.Tensor]:
        """A copy of the cache rows of ``slots`` (:meth:`rows_at`)."""
        return self.rows_at(slots)

    def insert_at(self, slots, rows: Dict[str, torch.Tensor],
                  lengths=None) -> None:
        """Deposit cache rows back into their ``slots`` (:meth:`rows_into`:
        out-of-range slots write nothing). ``lengths`` (same order as
        ``slots``) sets the resident-token count of each in-range slot;
        chunk streaming instead accounts entries with :meth:`advance`."""
        slots = np.asarray(slots)
        self.rows_into(rows, slots)
        if lengths is not None:
            for s, n in zip(slots.tolist(), np.asarray(lengths).tolist()):
                if 0 <= s < self.num_slots:
                    if self._owner[s] is None:
                        raise SlotError(f"insert_at into free slot {s}")
                    self._len[s] = int(n)

    def reset(self, *, strict: bool = False) -> None:
        """Return every slot to the free pool and zero the accounting
        (buffer contents are reclaimed lazily: the next occupant either
        overwrites its slot wholesale or ``reset_slot``s it first).

        A reset over live slots is a lease leak; the leaked owners are
        named: warn (:class:`LeaseLeakWarning`) by default, raise
        (:class:`LeaseLeakError`) under ``strict=True``."""
        leaked = [(s, self._owner[s]) for s in range(self.num_slots)
                  if self._owner[s] is not None]
        if leaked:
            msg = (f"reset with {len(leaked)} live slot lease(s): "
                   + ", ".join(f"slot {s} (owner {o!r})" for s, o in leaked))
            if strict:
                raise LeaseLeakError(msg)
            warnings.warn(msg, LeaseLeakWarning, stacklevel=2)
        self._free = list(range(self.num_slots - 1, -1, -1))
        self._owner = [None] * self.num_slots
        self._len[:] = 0
