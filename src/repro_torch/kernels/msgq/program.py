"""Round programs: a collective's sequence of message rounds, run by the
msgq kernels in one launch (``ops.msgq_program``) or round by round by
the plain version (``ref.msgq_program_ref``).

A :class:`Round` holds its (src, dst) pairs in stacked ranks, one
*combine* and, optionally, one segment a pair: a source and a
destination element offset and a length. Every round reads the values
that stood before it. What a rank's slab ``x`` becomes, with ``r`` the
slab it receives (zeros where it receives nothing):

* ``copy``: ``r`` (one message round: ``lax.ppermute``);
* ``add``: ``x + r``;
* ``max``: ``torch.maximum(x, r)``;
* ``replace``: ``r`` where the rank is a dst, else ``x`` (a bcast step);
* ``mask``: ``x`` where the rank is a dst of a self pair ``(r, r)``,
  else zeros (``reduce_bcast``'s masking step).

A round with segments (``add`` or ``replace`` only: the ring allreduce)
moves chunks: a slab is cut into chunks of the segments' length, every
rank receives one chunk from one sender and sends one, and the round
combines the chunk received into the dst's chunk of the segment's index
as the ring did round by round: ``gather``, the message round, then
``scatter_add`` / ``scatter`` over the (R, chunks, length) view (on the
card an atomic add an element). Every other element keeps its value.

:meth:`Program.device_plan` lays a program out for the kernels: full-slab
rounds ping-pong between two buffers, ending in the output; segment
rounds update in place, which is safe only where no segment a round
reads is one it writes (checked).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

COMBINES = ("copy", "add", "max", "replace", "mask")
#: the kernels' op codes (``csrc/msgq.cu``: ``Op``); ``mask`` runs as a
#: copy whose only pairs are the kept ranks' self pairs; a segment round's
#: add runs as ``ACCUMULATE``: atomic adds in place, as ``scatter_add``
OP_CODE = {"copy": 0, "add": 1, "max": 2, "replace": 3, "mask": 0}
ACCUMULATE = 4
#: buffers of a device plan: the input, the output, the scratch
X, OUT, SCRATCH = 0, 1, 2
#: int64 words of a round's header and of an entry in the device table
HEADER, ENTRY = 8, 4

Pair = Tuple[int, int]
Segment = Tuple[int, int, int]


@dataclass(frozen=True)
class Round:
    pairs: Tuple[Pair, ...]
    combine: str = "copy"
    #: per pair (src_off, dst_off, length) in elements, or None: whole
    #: slabs
    segments: Optional[Tuple[Segment, ...]] = None

    def __post_init__(self):
        pairs = tuple((int(s), int(d)) for s, d in self.pairs)
        object.__setattr__(self, "pairs", pairs)
        if self.combine not in COMBINES:
            raise ValueError(f"unknown combine {self.combine!r}; known "
                             f"combines: {COMBINES}")
        dsts = [d for _, d in pairs]
        if self.combine == "mask" and any(s != d for s, d in pairs):
            raise ValueError(f"a mask round names kept ranks as self "
                             f"pairs: {pairs}")
        if self.segments is None:
            if len(set(dsts)) != len(dsts):
                raise ValueError(f"a rank receives twice in one round: "
                                 f"{pairs}")
            return
        segs = tuple(tuple(int(v) for v in s) for s in self.segments)
        object.__setattr__(self, "segments", segs)
        if self.combine not in ("add", "replace"):
            raise ValueError("a round with segments combines by add or "
                             f"replace, not {self.combine!r}")
        if len(segs) != len(pairs) or not pairs:
            raise ValueError("a round with segments needs one segment a "
                             "pair")
        if len({n for _, _, n in segs}) != 1:
            raise ValueError(f"the segments of a round differ in length: "
                             f"{segs}")
        n = segs[0][2]
        if n < 1 or any(so % n or do % n for so, do, _ in segs):
            raise ValueError(f"segments are whole chunks of their length: "
                             f"{segs}")
        srcs = [s for s, _ in pairs]
        if len(set(srcs)) != len(srcs):
            raise ValueError(f"a rank sends twice in one round: {pairs}")

    @property
    def length(self) -> Optional[int]:
        return self.segments[0][2] if self.segments else None


class Program:
    """An immutable sequence of rounds, with the device tables the kernels
    read cached on it (:meth:`memo`)."""

    def __init__(self, rounds: Sequence[Round]):
        self.rounds: Tuple[Round, ...] = tuple(rounds)
        self._checked: set = set()
        self._memo: Dict = {}

    def __len__(self) -> int:
        return len(self.rounds)

    def check(self, R: int, numel: int) -> None:
        """Raise unless every rank is in 0..R-1 and, in a round with
        segments, every rank receives once, the chunks tile a slab of
        ``numel`` elements, and no rank sends the chunk it receives
        (once per (R, numel))."""
        if (R, numel) in self._checked:
            return
        for rnd in self.rounds:
            for s, d in rnd.pairs:
                if not (0 <= s < R and 0 <= d < R):
                    raise ValueError(f"pair {(s, d)} names a rank outside "
                                     f"0..{R - 1}")
            if rnd.segments is None:
                continue
            n = rnd.length
            writes = {d: do for (_, d), (_, do, _) in
                      zip(rnd.pairs, rnd.segments)}
            if sorted(writes) != list(range(R)):
                raise ValueError(f"a round with segments names every rank "
                                 f"once as dst: {rnd.pairs}")
            if numel % n:
                raise ValueError(f"chunks of {n} do not tile a slab of "
                                 f"{numel} elements")
            for (s, d), (so, do, _) in zip(rnd.pairs, rnd.segments):
                if min(so, do) < 0 or max(so, do) + n > numel:
                    raise ValueError(f"segment {(so, do, n)} outside a "
                                     f"slab of {numel} elements")
                if so == writes[s]:
                    raise ValueError(f"rank {s} sends the chunk at {so} it "
                                     f"receives in the same round")
        self._checked.add((R, numel))

    def memo(self, key, make):
        """``make()``, made once per ``key`` and kept on the program (the
        wrapper keeps its device tables here)."""
        if key not in self._memo:
            self._memo[key] = make()
        return self._memo[key]

    def device_plan(self, R: int, numel: int, item: int) -> "Plan":
        """The program as the kernels read it (see :class:`Plan`). A
        full-slab round has one entry for every rank (src -1: it receives
        zeros); a program that opens with a segment round first copies
        the input to the output; a segment add may take two rounds
        (:meth:`_accumulate`)."""
        m = numel * item
        # (op, entries, bytes a segment, False: full slab, True: in place,
        # "stage" / "from scratch": a staged accumulate's two halves)
        rounds: list = []
        if self.rounds and self.rounds[0].segments is not None:
            rounds.append((OP_CODE["copy"],
                           [(r, r, 0, 0) for r in range(R)], m, False))
        for rnd in self.rounds:
            if rnd.segments is None:
                src = {d: s for s, d in rnd.pairs}
                entries = [(src.get(d, -1), d, 0, 0) for d in range(R)]
                rounds.append((OP_CODE[rnd.combine], entries, m, False))
            elif rnd.combine == "replace":
                entries = [(s, d, so * item, do * item) for (s, d),
                           (so, do, _) in zip(rnd.pairs, rnd.segments)]
                rounds.append((OP_CODE["replace"], entries,
                               rnd.length * item, True))
            else:
                rounds += self._accumulate(rnd, m, item)
        # full-slab rounds alternate between the output and the scratch,
        # starting where an even count of them ends in the output
        flips = sum(mode is False for *_, mode in rounds)
        cur, nxt = X, (OUT if flips % 2 else SCRATCH)
        header, body, shapes = [], [], []
        align = 16
        for op, entries, nbytes, mode in rounds:
            if mode is False:             # full slab: the next buffer
                src_buf, dst_buf = cur, nxt
                cur, nxt = nxt, (SCRATCH if nxt == OUT else OUT)
            elif mode == "stage":         # segments into the scratch
                if cur == SCRATCH:
                    raise ValueError("a staged segment add after an odd "
                                     "number of full-slab rounds")
                src_buf, dst_buf = cur, SCRATCH
            elif mode == "from scratch":
                src_buf, dst_buf = SCRATCH, cur
            else:                         # in place
                src_buf = dst_buf = cur
            header += [op, len(entries), HEADER * len(rounds) + len(body),
                       nbytes, src_buf, dst_buf, 0, 0]
            shapes += [len(entries), nbytes]
            for e in entries:
                body.extend(e)
                for v in e[2:]:
                    while v % align:
                        align //= 2
            while nbytes % align:
                align //= 2
        return Plan(header + body, len(rounds), shapes,
                    SCRATCH in header[5::HEADER], align)

    @staticmethod
    def _accumulate(rnd: Round, m: int, item: int) -> list:
        """A segment add as the kernels run it: atomic adds in place. For
        2-byte types they are paired atomics on 4-byte words (as
        ``scatter_add`` does them), which add +0.0 to the word's other
        element; where a segment does not fill whole words, that element
        may be one the round sends, so the messages are first staged in
        the scratch buffer (at the receivers' offsets) and added from
        there in a second round."""
        n = rnd.length * item
        entries = [(s, d, so * item, do * item) for (s, d), (so, do, _)
                   in zip(rnd.pairs, rnd.segments)]
        aligned = all(v % 4 == 0 for v in (m, n) + tuple(
            e[3] for e in entries))
        if item != 2 or aligned:
            return [(ACCUMULATE, entries, n, True)]
        staged = [(d, d, do, do) for _, d, _, do in entries]
        return [(OP_CODE["copy"], entries, n, "stage"),
                (ACCUMULATE, staged, n, "from scratch")]


@dataclass(frozen=True)
class Plan:
    """A program laid out for the kernels (``csrc/msgq.cu``)."""
    #: int64 words: a header of ``HEADER`` words a round (op, entries,
    #: first entry's word, bytes a segment, input buffer, output buffer,
    #: two unused), then ``ENTRY`` words an entry (src or -1, dst, src
    #: and dst byte offsets); buffers are ``X``, ``OUT``, ``SCRATCH``
    words: List[int]
    rounds: int
    #: (entries, bytes a segment) of each round, flattened: the host
    #: sizes the grid from them
    shapes: List[int]
    #: whether any round writes the scratch buffer
    scratch: bool
    #: the largest power of two (up to 16) dividing every byte offset and
    #: segment length
    align: int
