"""KV-block migration transport: the request-based, block-by-block
handoff of a finished prefill's KV between two paged pools (the port of
the reference's ``serve/fabric/transport.py``).

The fabric's p2p hop, under the rendezvous discipline end to end:

* the decode rank leases its destination blocks first
  (``ContinuousEngine.begin_import``, the posted receive), so the lease
  is handed off and the prefill is not recomputed;
* the prompt's KV then crosses **one block per message**: each message
  copies one source block into one destination block of every ``(L, P,
  bs, Gs, hd)`` leaf, a plain indexed tensor copy in place on the calling
  thread's current stream (the reference's is an XLA slice update; no
  Pallas kernel carries it, so none is ported here). The destination
  block is threaded through the ``kv-migrate`` ``CommStream`` with
  ``ordered`` and rides a :class:`~repro_torch.core.comm.Request` that
  carries the protocol model's request overhead for a one-block message;
  on the card the request records a CUDA event after the copy, so it
  needs no read-back probe. ``waitall`` is the completion point before
  the decode rank may touch the migrated rows, on the error path too;
* the whole migration is priced by
  :func:`repro_torch.core.protocol.kv_migration_latency` (one rendezvous
  handshake + a protocol-selected message per block).

The copy runs on the current stream, after the prefill rank's last chunk
was issued on the same stream: it reads the source blocks only once that
chunk has written them. The pool is written in place, so the install is
``swap_buffers`` of the pool itself (its identity check).

Telemetry: the pure block transfer is a ``kv_transfer`` span (it nests
inside the router's ``hop:migration``). Under the runtime sanitizer a
migration reports its begin and, once every block was issued and
waited, its end (``on_migrate_begin`` / ``on_migrate_end``).
"""

from __future__ import annotations

import time
from typing import List

from repro_torch.analysis.sanitizer import active as _san_active
from repro_torch.core import protocol
from repro_torch.core.comm import Request, waitall
from repro_torch.obs.trace import active as _tr_active


class KVBlockTransport:
    """Block-by-block KV migration between two ``PagedKVCache`` pools."""

    def __init__(self, comm, stream_name: str = "kv-migrate"):
        self.comm = comm
        self.stream = comm.stream(stream_name)
        # accounting for the fabric's kv_migration rows
        self.n_migrations = 0
        self.n_blocks_moved = 0
        self.bytes_moved = 0
        self.modeled_cost_s = 0.0

    @staticmethod
    def block_nbytes(kv) -> int:
        """Bytes one pool block carries across all layers and both of k
        and v: the per-message payload protocol selection sees."""
        return int(sum(t.numel() * t.element_size() // t.shape[1]
                       for t in kv.buffers.values()))

    @staticmethod
    def _copy_impl(dst_buf, src_buf, src_block: int, dst_block: int):
        """One block message: source block ``src_block`` of every leaf
        into destination block ``dst_block``, in place. Returns the
        destination block views."""
        out = []
        for name, d in dst_buf.items():
            view = d[:, dst_block]
            view.copy_(src_buf[name][:, src_block])
            out.append(view)
        return out

    def migrate(self, src_kv, dst_kv, src_blocks: List[int],
                dst_blocks: List[int]) -> float:
        """Stream ``src_blocks`` of ``src_kv`` into ``dst_blocks`` of
        ``dst_kv`` (1:1, table order), one Request per block, and wait
        them all. Returns the modeled migration latency (seconds); the
        side effect is ``dst_kv``'s pool holding the prompt's KV."""
        if len(src_blocks) != len(dst_blocks):
            raise ValueError(
                f"block lists disagree: {len(src_blocks)} source vs "
                f"{len(dst_blocks)} destination")
        if src_kv.block_size != dst_kv.block_size:
            raise ValueError(
                f"pools disagree on block_size: {src_kv.block_size} vs "
                f"{dst_kv.block_size} (1:1 block migration needs equal "
                "token geometry)")
        nb = self.block_nbytes(src_kv)
        proto = protocol.select_protocol(nb, interthread=True)
        requests: List[Request] = []
        san = _san_active()
        if san is not None:
            san.on_migrate_begin(self, len(src_blocks))
        tr = _tr_active()
        t_xfer = time.perf_counter() if tr is not None else 0.0
        try:
            for sb, db in zip(src_blocks, dst_blocks):
                block = self._copy_impl(dst_kv.buffers, src_kv.buffers,
                                        int(sb), int(db))
                # the written block joins the migrate stream's order and
                # rides the Request whose wait() is its completion point
                block = self.stream.ordered(block)
                requests.append(Request(
                    self.comm, f"kv_block[{proto}]", block,
                    stream=self.stream,
                    model_overhead_s=protocol.request_overhead(nb, proto)))
        finally:
            # completion sits on the error path too: every block message
            # already issued is waited before the install either way
            try:
                waitall(requests)
                if san is not None and len(requests) == len(src_blocks):
                    san.on_migrate_end(self)
            finally:
                dst_kv.swap_buffers(dst_kv.buffers)
        moved = len(src_blocks)
        # the per-block message price already holds each block's request
        # object: Request.model_overhead_s is the per-message view of the
        # same cost, not an add-on
        cost = protocol.kv_migration_latency(moved * nb, nb)
        if tr is not None:
            tr.complete("kv_transfer", t_xfer, time.perf_counter(),
                        cat="fabric", blocks=moved)
        self.n_migrations += 1
        self.n_blocks_moved += moved
        self.bytes_moved += moved * nb
        self.modeled_cost_s += cost
        return cost

    def stats(self) -> dict:
        """Aggregate migration accounting for the fabric's stats."""
        return {
            "n_migrations": float(self.n_migrations),
            "blocks_moved": float(self.n_blocks_moved),
            "bytes_moved": float(self.bytes_moved),
            "kv_migration_modeled_s": self.modeled_cost_s,
            "kv_migration_us_per_block":
                (1e6 * self.modeled_cost_s / self.n_blocks_moved
                 if self.n_blocks_moved else 0.0),
        }

    def reset(self) -> None:
        self.n_migrations = 0
        self.n_blocks_moved = 0
        self.bytes_moved = 0
        self.modeled_cost_s = 0.0
