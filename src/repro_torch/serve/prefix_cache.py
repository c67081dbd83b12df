"""Radix-tree prefix cache over the paged KV block pool — the port of the
reference's ``serve/prefix_cache.py``, host-side Python as there.

Identical prompt prefixes across requests denote identical KV blocks;
:class:`BlockPool` carries per-block reference counts for this, and this
module is the index that turns them into a prefix cache:

* **Trie keyed by token content.** Each node owns one pool block and is
  keyed by the full ``block_size``-token chunk it caches, so a path from
  the root spells a prompt prefix at block granularity. Lookup walks
  full-block matches, then matches the longest common prefix against
  the deepest node's children: a *partial* hit names a copy-on-write
  source block.
* **The cache holds a lease.** Every indexed block carries one
  reference owned by the cache, so "refcount 0 iff on the free list"
  survives: a block whose requests have all finished is *parked* (its
  last reference is the cache's), not freed. Parked blocks form an LRU.
* **Deferred reclamation.** ``BlockPool.alloc`` finding the free list
  short asks the cache to ``reclaim``: eviction walks the LRU oldest
  first and drops whole parked subtrees; a parked node above a live
  descendant is pinned and skipped.
* **Copy-on-write.** A partial hit leases the divergent source block
  with a temporary reference, the engine clones it on the device into a
  fresh private block (``model.clone_paged_block``), and the temporary
  reference is dropped.

The hit path is priced by ``protocol.prefix_hit_latency``: a lease
handoff (handshake, a table surcharge per block, a block copy per CoW
clone), not a recompute.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.serve.kv_cache import SlotError


@dataclass
class PrefixHit:
    """Result of one trie lookup: the shareable prefix of a prompt.

    ``blocks`` are full-block hits in prefix order; ``cow_src`` (if any)
    is a cached block whose first ``cow_tokens`` tokens match the
    prompt's next chunk — shareable only by cloning. ``n_parked`` counts
    hit blocks currently parked (they leave the pool's free list alone
    but stop being evictable once leased — admission math needs both).
    """
    blocks: List[int] = field(default_factory=list)
    tokens: int = 0
    cow_src: Optional[int] = None
    cow_tokens: int = 0
    n_parked: int = 0

    @property
    def total_tokens(self) -> int:
        return self.tokens + self.cow_tokens


class _Node:
    """One cached block: keyed by its token chunk, linked into the trie."""

    __slots__ = ("key", "block", "parent", "children")

    def __init__(self, key: Optional[Tuple[int, ...]], block: int,
                 parent: Optional["_Node"]):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], _Node] = {}


def _lcp(a: Tuple[int, ...], b: Tuple[int, ...]) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class PrefixCache:
    """Block-granular radix index + LRU reclaimer over a ``BlockPool``.

    Attaching (done in ``__init__``) registers the cache as the pool's
    reclaimer: the pool counts parked-and-evictable blocks as free for
    admission and calls back into :meth:`reclaim` when ``alloc`` finds
    the free list short.
    """

    def __init__(self, pool):
        self.pool = pool
        self.block_size = int(pool.block_size)
        self._root = _Node(None, -1, None)
        self._nodes: Dict[int, _Node] = {}        # block id -> node
        self._parked: "OrderedDict[int, None]" = OrderedDict()  # LRU
        # counters (reset_stats() clears; content survives)
        self.n_lookups = 0
        self.n_hits = 0
        self.n_insertions = 0
        self.n_evictions = 0
        pool.attach_reclaimer(self)

    def __repr__(self) -> str:      # the owner name in pool diagnostics
        return "prefix-cache"

    # -- index accounting --------------------------------------------------
    @property
    def num_cached(self) -> int:
        return len(self._nodes)

    @property
    def num_parked(self) -> int:
        return len(self._parked)

    # -- lookup / lease ----------------------------------------------------
    def lookup(self, tokens, limit: Optional[int] = None) -> PrefixHit:
        """Longest cached prefix of ``tokens[:limit]``.

        Full-block trie walk first, then a radix partial match (longest
        common prefix against the deepest node's children) for the CoW
        tail. Callers clamp ``limit`` below the prompt length so at
        least one token always re-prefills (the final chunk's logits
        seed decode).
        """
        toks = [int(t) for t in tokens]
        limit = len(toks) if limit is None else min(int(limit), len(toks))
        bs = self.block_size
        self.n_lookups += 1
        node, blocks, i = self._root, [], 0
        while i + bs <= limit:
            child = node.children.get(tuple(toks[i:i + bs]))
            if child is None:
                break
            blocks.append(child.block)
            node = child
            i += bs
        cow_src, cow_tokens = None, 0
        rem = tuple(toks[i:limit])
        if rem:
            for key, child in node.children.items():
                n = _lcp(key, rem)
                if n > cow_tokens:
                    cow_tokens, cow_src = n, child.block
        parked = sum(1 for b in blocks if b in self._parked)
        if cow_src is not None and cow_src in self._parked:
            parked += 1
        hit = PrefixHit(blocks=blocks, tokens=len(blocks) * bs,
                        cow_src=cow_src, cow_tokens=cow_tokens,
                        n_parked=parked)
        if hit.total_tokens:
            self.n_hits += 1
        return hit

    def lease(self, hit: PrefixHit, owner: object) -> None:
        """Reference every hit block for ``owner`` (the CoW source gets a
        temporary reference — dropped via :meth:`release_cow` once the
        clone lands). Leased blocks are unparked first, so a reclaim
        triggered by the same admission's fresh-block ``alloc`` can
        never evict them."""
        for b in hit.blocks:
            self.pool.ref(b, owner=owner)
            self._parked.pop(b, None)
        if hit.cow_src is not None:
            self.pool.ref(hit.cow_src, owner=owner)
            self._parked.pop(hit.cow_src, None)

    def release_cow(self, block: int) -> None:
        """Drop the temporary CoW-source reference (the clone is on
        device; the request no longer reads the shared block)."""
        self.pool.free([block])

    # -- insert ------------------------------------------------------------
    def insert(self, tokens, blocks) -> int:
        """Index a finished prefill's full prompt blocks. Walks existing
        nodes (a concurrent duplicate keeps the first copy; the loser's
        private block simply stays unindexed) and references each newly
        indexed block on behalf of the cache. Returns blocks added."""
        toks = [int(t) for t in tokens]
        bs = self.block_size
        n_full = min(len(toks) // bs, len(blocks))
        node, added = self._root, 0
        for j in range(n_full):
            key = tuple(toks[j * bs:(j + 1) * bs])
            child = node.children.get(key)
            if child is None:
                b = int(blocks[j])
                if b in self._nodes:      # already indexed elsewhere
                    break
                child = _Node(key, b, node)
                node.children[key] = child
                self._nodes[b] = child
                self.pool.ref(b, owner=self)
                added += 1
                self.n_insertions += 1
            node = child
        return added

    # -- reclaimer protocol (BlockPool callbacks) --------------------------
    def on_sole_ref(self, block: int) -> None:
        """Pool callback: ``block``'s refcount dropped to 1. If the
        survivor is the cache's own reference (iff the block is
        indexed), the block parks at the LRU's fresh end."""
        if block in self._nodes:
            self._parked[block] = None
            self._parked.move_to_end(block)

    def evictable(self) -> int:
        """Parked blocks reclaim() could actually free right now: a
        parked node pinned by a live descendant (a later request's
        private suffix inserted beneath it) is not evictable — dropping
        it would orphan the live path."""
        return sum(1 for b in self._parked
                   if not self._has_live_descendant(self._nodes[b]))

    def reclaim(self, need: int) -> int:
        """Evict parked subtrees, LRU-oldest first, until ``need`` blocks
        returned to the free list (or nothing evictable remains)."""
        freed = 0
        for b in list(self._parked):
            if freed >= need:
                break
            node = self._nodes.get(b)
            if node is None or b not in self._parked:
                continue              # went down with an earlier subtree
            if self._has_live_descendant(node):
                continue
            freed += self._evict_subtree(node)
        return freed

    def _has_live_descendant(self, node: _Node) -> bool:
        for c in node.children.values():
            if c.block not in self._parked or self._has_live_descendant(c):
                return True
        return False

    def _evict_subtree(self, node: _Node) -> int:
        """Drop ``node`` and everything beneath it (all parked — the
        caller proved no live descendant), children first so the trie
        never holds an edge to a freed block."""
        count = 0
        for c in list(node.children.values()):
            count += self._evict_subtree(c)
        if node.parent is not None:
            node.parent.children.pop(node.key, None)
        self._nodes.pop(node.block, None)
        self._parked.pop(node.block, None)
        self.pool.free([node.block])      # cache ref 1 -> 0: free list
        self.n_evictions += 1
        return count + 1

    def on_pool_reset(self) -> None:
        """Pool callback at ``BlockPool.reset``: every lease (including
        the cache's) was wiped underneath us — drop the index without
        re-freeing anything."""
        self._root = _Node(None, -1, None)
        self._nodes.clear()
        self._parked.clear()

    # -- lifecycle ---------------------------------------------------------
    def clear(self) -> None:
        """Release every cached reference and empty the index (the
        engine's cold ``reset``). Blocks still shared with live requests
        survive at their remaining refcount; cache-only blocks return to
        the free list."""
        blocks = list(self._nodes)
        self._root = _Node(None, -1, None)
        self._nodes.clear()
        self._parked.clear()
        for b in blocks:
            self.pool.free([b])

    def reset_stats(self) -> None:
        self.n_lookups = self.n_hits = 0
        self.n_insertions = self.n_evictions = 0

    def stats(self) -> Dict[str, float]:
        return {
            "prefix_cached_blocks": float(self.num_cached),
            "prefix_parked_blocks": float(self.num_parked),
            "prefix_trie_lookups": float(self.n_lookups),
            "prefix_trie_hits": float(self.n_hits),
            "prefix_insertions": float(self.n_insertions),
            "prefix_evictions": float(self.n_evictions),
        }

    def check(self) -> None:
        """Structural invariants (test hook): every indexed block holds a
        cache reference; every parked block is indexed."""
        for b, node in self._nodes.items():
            if self.pool.refcount(b) < 1:
                raise SlotError(f"cached block {b} has no live lease")
            if node.children is None:
                raise SlotError(f"cached block {b} detached")
        for b in self._parked:
            if b not in self._nodes:
                raise SlotError(f"parked block {b} not indexed")
