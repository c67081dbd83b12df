"""Unified communicator API: one ``Comm`` interface over the N×M rank
space — the port of ``src/repro/core/comm.py``.

The root communicator is a :class:`ThreadComm` built from mesh axes: the
paper's MPIX threadcomm, fusing the process domain (slow axes) with the
thread domain (fast axes) into one process-major rank space. Every
derived communicator shares the same method surface::

    root = threadcomm_init(mesh, process_axes, thread_axes)
    with root.start():
        tcomm = root.thread_comm()        # fast-domain sub-comm family
        pcomm = root.process_comm()       # slow-domain sub-comm family
        sub   = root.split(color, key)    # MPI_Comm_split over unified ranks
        dup   = root.dup()                # same group, fresh context
        y = root.run(lambda v: sub.allreduce(v), x)
        req = pcomm.iallreduce(v)         # nonblocking -> Request

All ranks run on one device, as one rank-stacked program (``core/
compat.py``): inside ``root.run`` every per-rank value has a leading rank
dimension and every message round between ranks is one launch of a
``kernels/msgq`` copy; a folded collective (``core/collectives.py``) runs
all its rounds in one. ``split`` returns an axis-aligned :class:`AxisComm`
(native reductions over mesh axes) whenever the colour classes coincide
with a mesh sub-grid, and a generic :class:`GroupComm` (merged ring
rounds over the unified rank space) otherwise.

Streams follow MPIX stream semantics (arXiv:2208.13707). On the card a
:class:`CommStream` owns a CUDA stream: work issued inside
``with comm.stream(name)`` is enqueued on it, so requests on one stream
run in issue order and independent streams may overlap; a
``Request.wait()`` makes the caller's stream wait for the request and
then completes it on the host. On the CPU a stream is a name and program
order is its order.

Lifetime rules extend the paper's §2 activation-window semantics: derived
comms, groups, attributes AND requests die at ``finish`` — using any of
them afterwards raises :class:`ThreadCommError`.

Telemetry (``REPRO_TRACE=1``, :mod:`repro_torch.obs`): ``Request.wait``
reports its wait to the tracer (a ``wait:<op>`` span, and blocked time
charged to the serialization-stall detector while the thread has
runnable work), and a ``with comm.stream(name)`` region is a
``stream:<name>`` span. Off, each site is one global read and a ``None``
check.

Runtime sanitizer (``REPRO_SANITIZE=1``,
:mod:`repro_torch.analysis.sanitizer`): a request's issue and completion
(``wait``, or the ``test`` that turns it done), a stream region's entry
and ``finish`` report to it. Off, each site is one global read and a
``None`` check.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from itertools import combinations
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.analysis.sanitizer import active as _san_active
from repro_torch.core import collectives as coll
from repro_torch.core import p2p as p2p_mod
from repro_torch.core import protocol
from repro_torch.core.compat import P, axis_index, rank_view, shard_map
from repro_torch.obs.trace import active as _tr_active


class ThreadCommError(RuntimeError):
    """Misuse of the communicator lifecycle / activation-window rules."""


CommError = ThreadCommError  # preferred alias for new code


def _tensors(value) -> List[torch.Tensor]:
    """The tensors of a value (a tensor or nested tuples, lists and dict
    values)."""
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (tuple, list)):
        return [t for v in value for t in _tensors(v)]
    return []


# ---------------------------------------------------------------------------
# Requests (nonblocking operations)
# ---------------------------------------------------------------------------

class Request:
    """Handle for a nonblocking operation: its result plus, on the card, a
    CUDA event recorded after the operation on the stream that ran it.
    ``wait()`` returns the result; ``test()`` polls completion without
    blocking. Like every threadcomm-derived object, a request is only
    valid inside the activation window that issued it (paper §2).

    ``model_overhead_s`` carries the protocol model's request-object cost
    (0 for the eager-fast path that skips request allocation — §3.2).
    """

    __slots__ = ("comm", "op", "_value", "_epoch", "_done", "stream",
                 "model_overhead_s", "_event")

    def __init__(self, comm: "Comm", op: str, value,
                 stream: Optional["CommStream"] = None,
                 model_overhead_s: float = 0.0):
        self.comm = comm
        self.op = op
        self._value = value
        self._epoch = comm._root._epoch
        self._done = False
        self.stream = stream
        self.model_overhead_s = model_overhead_s
        self._event = None
        if comm._root._cuda:
            self._event = torch.cuda.Event()
            self._event.record()
        san = _san_active()
        if san is not None:
            san.on_request(self)

    def _check_window(self):
        self.comm._root._check_not_freed()
        if self._epoch != self.comm._root._epoch:
            raise ThreadCommError(
                f"request({self.op}) outlived its activation window "
                "(derived objects die at finish)")

    def wait(self):
        """Complete the operation and return its result: the caller's
        stream waits for it, then the host does (host-level completion,
        where a device fault of the operation surfaces)."""
        self._check_window()
        self._done = True
        self._leave_stream()
        san = _san_active()
        if san is not None:
            san.on_request_complete(self)
        tr = _tr_active()
        # the completion point is where accidental serialization bites:
        # under a trace the block is timed for the stall detector
        t0 = time.perf_counter() if tr is not None else 0.0
        if self._event is not None:
            torch.cuda.current_stream().wait_event(self._event)
            self._event.synchronize()
        if tr is not None:
            tr.on_wait(self.op, t0, time.perf_counter())
        return self._value

    def _leave_stream(self):
        # a completed request lets go of its stream: the stream keeps its
        # requests (``synchronize``), and the link back would be a
        # reference cycle that holds the result until the cyclic
        # collector runs
        self.stream = None

    def test(self) -> Tuple[bool, Optional[object]]:
        """(done, result_or_None) without blocking."""
        self._check_window()
        if not self._done and (self._event is None or self._event.query()):
            self._done = True
            self._leave_stream()
            san = _san_active()
            if san is not None:   # only the call that turns it done
                san.on_request_complete(self)
        return (True, self._value) if self._done else (False, None)


def waitall(requests: Sequence[Request]) -> List[object]:
    """MPI_Waitall: complete every request, preserving order."""
    return [r.wait() for r in requests]


def testall(requests: Sequence[Request]) -> bool:
    """MPI_Testall: True iff every request has completed."""
    return all(r.test()[0] for r in requests)


class CommStream:
    """A named execution stream bound to a comm (the MPIX stream analogue).

    On the card it owns a CUDA stream. Entering it makes that stream wait
    for the issuing stream and makes it current, so every request issued
    inside runs on it in issue order, independent of other streams::

        with comm.stream("grad") as s:
            req = pcomm.iallreduce(shard)   # ordered on "grad"
        ... other work overlaps here ...
        shard = req.wait()

    Inputs consumed on the stream and results handed back to the issuing
    stream are marked with ``record_stream``, so the caching allocator
    never reuses their memory while a copy is still in flight.
    """

    def __init__(self, comm: "Comm", name: str):
        self.comm = comm
        self.name = name
        self._requests: List[Request] = []
        dev = comm._root.mesh.device
        self._cuda = torch.cuda.Stream(device=dev) if comm._root._cuda \
            else None
        self._outer = None
        self._ctx = None
        self._obs_span = None

    def __enter__(self) -> "CommStream":
        self.comm._root._check_active()
        san = _san_active()
        if san is not None:       # program order flows into the stream
            san.on_stream_enter(self)
        tr = _tr_active()
        if tr is not None:        # stream-region span, closed in __exit__
            self._obs_span = tr.span(f"stream:{self.name}", cat="comm")
        if self._cuda is not None:
            self._outer = torch.cuda.current_stream(self._cuda.device)
            self._cuda.wait_stream(self._outer)
            self._ctx = torch.cuda.stream(self._cuda)
            self._ctx.__enter__()
        self.comm._root._stream_stack.append(self)
        return self

    def __exit__(self, *exc):
        stack = self.comm._root._stream_stack
        if stack and stack[-1] is self:
            stack.pop()
        if self._ctx is not None:
            ctx, self._ctx = self._ctx, None
            ctx.__exit__(*exc)
        sp = self._obs_span
        if sp is not None:
            self._obs_span = None
            sp.end()
        return False

    # ---- ordering (called by Comm.icollective / Comm.isend) ----
    def _gate(self, x):
        if self._cuda is not None:
            for t in _tensors(x):
                t.record_stream(self._cuda)
        return x

    def _record(self, req: Request):
        if self._cuda is not None:
            for t in _tensors(req._value):
                t.record_stream(self._outer)
        self._requests.append(req)

    def synchronize(self) -> List[object]:
        """Complete every request issued on this stream (in order)."""
        out = waitall(self._requests)
        self._requests = []
        return out

    def ordered(self, value):
        """Thread a value through this stream's order: the stream waits
        for the work that produced it on the issuing stream, so whatever
        runs on the stream next sees it complete. Ordering *within* the
        stream, none against other streams."""
        self.comm._root._check_active()
        if self._cuda is not None:
            self._cuda.wait_stream(
                torch.cuda.current_stream(self._cuda.device))
            self._gate(value)
        return value


# ---------------------------------------------------------------------------
# Derived-object handle (rank subsets) — kept from the MPIX group API
# ---------------------------------------------------------------------------

@dataclass
class Group:
    """A subset of unified ranks derived from an active comm. Valid only
    within the activation window that created it (paper §2)."""
    comm: "Comm"
    ranks: Tuple[int, ...]
    _epoch: int = 0

    def _check(self):
        self.comm._root._check_active()
        if self._epoch != self.comm._root._epoch:
            raise ThreadCommError(
                "group outlived its threadcomm activation window "
                "(derived objects die at MPIX_Threadcomm_finish)")

    @property
    def size(self) -> int:
        self._check()
        return len(self.ranks)

    def translate(self, rank: int) -> int:
        self._check()
        return self.ranks[rank]


# ---------------------------------------------------------------------------
# The unified Comm interface
# ---------------------------------------------------------------------------

class Comm:
    """Common surface of every communicator (root and derived).

    Collectives/p2p are methods taking rank-stacked values (call them
    inside ``ThreadComm.run``); ``i``-prefixed variants return
    :class:`Request`. Subclasses provide ``size``, ``families()``
    (host-side unified-rank lists) and the blocking implementations.
    """

    _root: "ThreadComm"

    # -- lifecycle ---------------------------------------------------------
    def _check(self):
        self._root._check_active()
        if self._birth_epoch != self._root._epoch:
            raise ThreadCommError(
                "communicator outlived its parent's activation window "
                "(derived comms die at finish)")

    @property
    def _birth_epoch(self) -> int:
        return self._epoch_at_birth

    # -- identity ----------------------------------------------------------
    @property
    def size(self) -> int:  # pragma: no cover - overridden
        raise NotImplementedError

    def families(self) -> List[List[int]]:
        """Host-side: the concurrent sub-comm instances this object stands
        for, each as a list of unified ranks ordered by local rank. The
        root comm is a single family spanning every rank."""
        raise NotImplementedError

    def translate(self, local_rank: int, family: int = 0) -> int:
        """Local rank -> unified (root) rank, MPI_Group_translate_ranks."""
        self._check()
        return self.families()[family][local_rank]

    def local_rank(self) -> torch.Tensor:
        """int64 (R,): each rank's local rank (inside ``run``)."""
        raise NotImplementedError

    # -- derivation --------------------------------------------------------
    def dup(self) -> "Comm":
        """Same group(s), fresh communication context (MPI_Comm_dup). The
        dup is still a derived object: it dies at the parent's finish."""
        self._check()
        return self._clone()

    def _clone(self) -> "Comm":  # pragma: no cover - overridden
        raise NotImplementedError

    def split(self, color: Sequence[int], key: Optional[Sequence[int]] = None
              ) -> "Comm":
        """MPI_Comm_split over each family: local ranks with equal
        ``color[local_rank]`` form a sub-comm, ordered by
        ``(key[local_rank], local_rank)``. color < 0 == MPI_UNDEFINED (the
        rank joins no sub-comm and passes collectives through untouched).

        Returns an :class:`AxisComm` when the classes tile an axis-aligned
        mesh sub-grid in natural order (the fast path), else a
        :class:`GroupComm`.
        """
        self._check()
        color = list(color)
        if len(color) != self.size:
            raise ThreadCommError(
                f"split color has {len(color)} entries for a size-"
                f"{self.size} comm")
        if key is not None and len(key) != self.size:
            raise ThreadCommError("split key length must equal comm size")
        groups: Dict[Tuple[int, int], List[Tuple[int, int, int]]] = {}
        for fam_idx, fam in enumerate(self.families()):
            for lr, ur in enumerate(fam):
                c = color[lr]
                if c < 0:
                    continue
                k = key[lr] if key is not None else lr
                groups.setdefault((fam_idx, c), []).append((k, lr, ur))
        ordered = [tuple(ur for _, _, ur in sorted(v))
                   for _, v in sorted(groups.items())]
        natural = key is None or all(
            list(g) == sorted(g) for g in ordered)
        if natural:
            axes = self._root._axis_aligned(ordered)
            if axes is not None:
                return AxisComm(self._root, axes)
        return GroupComm(self._root, ordered)

    def stream(self, name: str) -> CommStream:
        """A named execution stream bound to this comm (MPIX stream)."""
        self._check()
        return CommStream(self, name)

    def _current_stream(self) -> Optional[CommStream]:
        stack = self._root._stream_stack
        return stack[-1] if stack else None

    # -- blocking collectives (subclass responsibility) --------------------
    def allreduce(self, x, schedule: str = "psum", wire_dtype=None):
        raise NotImplementedError

    def reduce(self, x, root: int = 0, schedule: str = "binomial"):
        raise NotImplementedError

    def bcast(self, x, root: int = 0):
        raise NotImplementedError

    def barrier(self, token, mode: str = "msg"):
        raise NotImplementedError

    def allgather(self, x, tiled: bool = True):
        raise NotImplementedError

    def reduce_scatter(self, x):
        raise NotImplementedError

    def alltoall(self, x):
        raise NotImplementedError

    def send_recv(self, x, pairs, *, force_protocol: Optional[str] = None):
        raise NotImplementedError

    # -- nonblocking layer -------------------------------------------------
    def icollective(self, op: str, x, *args, **kw) -> Request:
        """Issue collective ``op`` nonblocking: returns a :class:`Request`
        carrying the result, ordered on the current stream."""
        self._check()
        stream = self._current_stream()
        if stream is not None:
            x = stream._gate(x)
        value = getattr(self, op)(x, *args, **kw)
        req = Request(self, op, value, stream=stream)
        if stream is not None:
            stream._record(req)
        return req

    def iallreduce(self, x, schedule: str = "psum", wire_dtype=None) -> Request:
        return self.icollective("allreduce", x, schedule, wire_dtype)

    def ireduce(self, x, root: int = 0, schedule: str = "binomial") -> Request:
        return self.icollective("reduce", x, root, schedule)

    def ibcast(self, x, root: int = 0) -> Request:
        return self.icollective("bcast", x, root)

    def ibarrier(self, token, mode: str = "msg") -> Request:
        return self.icollective("barrier", token, mode)

    def iallgather(self, x, tiled: bool = True) -> Request:
        return self.icollective("allgather", x, tiled)

    def ireduce_scatter(self, x) -> Request:
        return self.icollective("reduce_scatter", x)

    def _is_interthread(self) -> bool:
        """True when every message on this comm stays inside one process
        (the fast shared domain) — drives protocol selection and the
        request-skip fast path, which are interthread-only (§3.2)."""
        return all(len({self._root.process_of(r) for r in fam}) <= 1
                   for fam in self.families())

    def isend(self, x, pairs, *, force_protocol: Optional[str] = None
              ) -> Request:
        """Nonblocking rank-addressed message round. Under the static SPMD
        schedule send and receive are one fused round, so the request's
        value is the RECEIVED buffer. The request carries the protocol
        model's request-object overhead — zero on the eager-fast path,
        which skips request allocation (paper §3.2; interthread comms
        only — slow-domain messages always pay the request)."""
        self._check()
        stream = self._current_stream()
        if stream is not None:
            x = stream._gate(x)
        nbytes = coll.rank_nbytes(x)
        proto = force_protocol or protocol.select_protocol(
            nbytes, interthread=self._is_interthread())
        value = self.send_recv(x, pairs, force_protocol=proto)
        req = Request(self, f"sendrecv[{proto}]", value, stream=stream,
                      model_overhead_s=protocol.request_overhead(
                          nbytes, proto))
        if stream is not None:
            stream._record(req)
        return req

    irecv = isend  # SPMD: the matching receive of the same fused round


# ---------------------------------------------------------------------------
# AxisComm: comms whose families tile mesh axes (fast, native lowering)
# ---------------------------------------------------------------------------

class AxisComm(Comm):
    """A family of sub-communicators spanning ``axes`` of the root mesh —
    one instance per coordinate of the complement axes, all operating
    concurrently (exactly MPI_Comm_split with color = complement coords).
    Collectives run the native / schedule-explicit implementations of
    :mod:`repro_torch.core.collectives` over the axis names."""

    def __init__(self, root: "ThreadComm", axes: Tuple[str, ...]):
        self._root = root
        self.axes = tuple(axes)
        self._epoch_at_birth = root._epoch
        sizes = root._axis_sizes
        self._size = math.prod(sizes[a] for a in self.axes) if self.axes else 1

    @property
    def size(self) -> int:
        return self._size

    def _clone(self) -> "AxisComm":
        return AxisComm(self._root, self.axes)

    def families(self) -> List[List[int]]:
        root = self._root
        comp = [a for a in root.unified_axes if a not in self.axes]
        fams: Dict[Tuple[int, ...], List[Tuple[int, int]]] = {}
        for ur in range(root.size):
            coords = root.coords_of(ur)
            fkey = tuple(coords[a] for a in comp)
            lr = 0
            for a in self.axes:
                lr = lr * root._axis_sizes[a] + coords[a]
            fams.setdefault(fkey, []).append((lr, ur))
        return [[ur for _, ur in sorted(v)] for _, v in sorted(fams.items())]

    def local_rank(self) -> torch.Tensor:
        return axis_index(self.axes)

    # -- collectives -------------------------------------------------------
    def allreduce(self, x, schedule: str = "psum", wire_dtype=None):
        self._check()
        if not self.axes:
            return x
        return coll.allreduce(x, self.axes, schedule=schedule,
                              wire_dtype=wire_dtype)

    def reduce(self, x, root: int = 0, schedule: str = "binomial"):
        self._check()
        if not self.axes:
            return x
        return coll.reduce(x, self.axes, root=root, schedule=schedule)

    def bcast(self, x, root: int = 0):
        self._check()
        if not self.axes:
            return x
        return coll.bcast(x, self.axes, root=root)

    def barrier(self, token, mode: str = "msg"):
        self._check()
        if not self.axes:
            return token
        return coll.barrier(token, self.axes, mode=mode)

    def allgather(self, x, tiled: bool = True):
        self._check()
        if not self.axes:
            return x
        return coll.allgather(x, self.axes, tiled=tiled)

    def reduce_scatter(self, x):
        self._check()
        if not self.axes:
            return x
        return coll.reduce_scatter(x, self.axes)

    def alltoall(self, x):
        self._check()
        if not self.axes:
            return x
        return coll.alltoall(x, self.axes)

    def send_recv(self, x, pairs, *, force_protocol: Optional[str] = None):
        """One message round addressed by LOCAL ranks; applies to every
        family concurrently. Protocol selection (eager padding vs 1-copy)
        follows core.p2p, using this comm's domain (interthread vs
        interprocess) for the thresholds."""
        self._check()
        proto = force_protocol or protocol.select_protocol(
            coll.rank_nbytes(x), interthread=self._is_interthread())
        recv, _ = p2p_mod.send_recv(x, self.axes, list(pairs),
                                    force_protocol=proto)
        return recv


# ---------------------------------------------------------------------------
# GroupComm: arbitrary rank classes (merged ring schedules)
# ---------------------------------------------------------------------------

class GroupComm(Comm):
    """Sub-comms over arbitrary unified-rank classes. Collectives run as
    ring schedules over the FULL unified axes, with each class's ring
    merged into shared message rounds (classes are disjoint, so their
    pairs compose). Ranks in no class pass through untouched.

    Generic and correct for any partition; prefer an axis-aligned
    :class:`AxisComm` (what ``split`` returns when it can).
    """

    def __init__(self, root: "ThreadComm", groups: Sequence[Sequence[int]]):
        self._root = root
        self._epoch_at_birth = root._epoch
        self.groups: Tuple[Tuple[int, ...], ...] = tuple(
            tuple(g) for g in groups)
        seen = set()
        for g in self.groups:
            for r in g:
                if r in seen:
                    raise ThreadCommError(
                        f"rank {r} appears in two split classes")
                seen.add(r)
        sizes = {len(g) for g in self.groups}
        self._uniform = len(sizes) == 1
        self._max_k = max(sizes) if sizes else 1
        # each unified rank's position in its class and the class size
        pos = np.zeros(root.size, np.int64)
        ksz = np.ones(root.size, np.int64)
        for g in self.groups:
            for i, r in enumerate(g):
                pos[r], ksz[r] = i, len(g)
        self._pos = torch.as_tensor(pos, device=root.mesh.device)
        self._ksz = torch.as_tensor(ksz, device=root.mesh.device)

    @property
    def size(self) -> int:
        if not self._uniform:
            raise ThreadCommError(
                "size is per-class on a non-uniform split; use .groups")
        return self._max_k

    def _clone(self) -> "GroupComm":
        return GroupComm(self._root, self.groups)

    def families(self) -> List[List[int]]:
        return [list(g) for g in self.groups]

    def local_rank(self) -> torch.Tensor:
        return self._pos[self._root.device_rank()]

    # -- merged ring rounds ------------------------------------------------
    def _ring_pairs(self, t: int) -> List[Tuple[int, int]]:
        """Pairs of round ``t`` (0-based): every class still propagating
        (k - 1 rounds for a class of size k) rotates by one."""
        pairs = []
        for g in self.groups:
            k = len(g)
            if t < k - 1:
                pairs.extend((g[i], g[(i + 1) % k]) for i in range(k))
        return pairs

    def _ring_accumulate(self, x, combine: Callable):
        axes = self._root.unified_axes
        carry, acc = x, x
        for t in range(self._max_k - 1):
            pairs = self._ring_pairs(t)
            if not pairs:
                break
            carry = coll.ppermute(carry, axes, pairs)
            acc = combine(acc, carry)
        return acc

    # -- collectives -------------------------------------------------------
    def allreduce(self, x, schedule: str = "ring", wire_dtype=None):
        self._check()
        if wire_dtype is not None:
            wire = coll._dtype(wire_dtype)
            axes = self._root.unified_axes
            carry, acc = x, x
            for t in range(self._max_k - 1):
                carry = coll.ppermute(carry.to(wire), axes,
                                      self._ring_pairs(t)).to(x.dtype)
                acc = acc + carry
            return acc
        return self._ring_accumulate(x, lambda a, c: a + c)

    def reduce(self, x, root: int = 0, schedule: str = "ring"):
        """Sum-reduce; every class rank holds the class total (the ring
        accumulate is symmetric, so non-root 'garbage' equals the sum)."""
        self._check()
        return self._ring_accumulate(x, lambda a, c: a + c)

    def barrier(self, token, mode: str = "msg"):
        self._check()
        token = torch.as_tensor(token).to(torch.float32)
        return self._ring_accumulate(token, torch.maximum)

    def bcast(self, x, root: int = 0):
        """Broadcast each class's ``root``-th member (by local rank) to the
        class: the value propagates one hop per round; non-members keep x."""
        self._check()
        axes = self._root.unified_axes
        ur = self._root.device_rank()
        dist = torch.remainder(self._pos[ur] - root, self._ksz[ur])
        v = x
        for t in range(1, self._max_k):
            pairs = self._ring_pairs(t - 1)
            if not pairs:
                break
            recv = coll.ppermute(v, axes, pairs)
            v = torch.where(rank_view(dist == t, v), recv, v)
        return v

    def allgather(self, x, tiled: bool = True):
        """Gather over each class; requires uniform class size (every
        rank's output shape must agree). ``tiled=True`` (the interface
        default, matching AxisComm) concatenates along the local dim 0;
        ``tiled=False`` stacks a new (k, ...) dim."""
        self._check()
        if not self._uniform:
            raise ThreadCommError("allgather needs uniform split classes")
        k = self._max_k
        axes = self._root.unified_axes
        R = x.shape[0]
        pos = self.local_rank()
        ranks = torch.arange(R, device=x.device)
        out = x.new_zeros((R, k) + tuple(x.shape[1:]))
        out[ranks, pos] = x
        carry = x
        for t in range(1, k):
            carry = coll.ppermute(carry, axes, self._ring_pairs(0))
            out[ranks, torch.remainder(pos - t, k)] = carry
        if tiled:
            out = out.reshape((R, k * x.shape[1]) + tuple(x.shape[2:]))
        return out

    def reduce_scatter(self, x):
        self._check()
        if not self._uniform:
            raise ThreadCommError("reduce_scatter needs uniform classes")
        k = self._max_k
        R = x.shape[0]
        flat = self.allreduce(x).reshape(R, -1)
        if flat.shape[1] % k:
            raise ThreadCommError(
                f"reduce_scatter payload ({flat.shape[1]}) must be "
                f"divisible by the class size {k}")
        shard = flat.reshape(R, k, -1)
        return shard[torch.arange(R, device=x.device), self.local_rank()]

    def alltoall(self, x):
        raise NotImplementedError(
            "alltoall on arbitrary split classes; use an axis-aligned split")

    def send_recv(self, x, pairs, *, force_protocol: Optional[str] = None):
        """Message round addressed by LOCAL class ranks (same pairs applied
        in every class)."""
        self._check()
        unified = []
        for src, dst in pairs:
            for g in self.groups:
                unified.append((g[src % len(g)], g[dst % len(g)]))
        proto = force_protocol or protocol.select_protocol(
            coll.rank_nbytes(x), interthread=self._is_interthread())
        recv, _ = p2p_mod.send_recv(x, self._root.unified_axes, unified,
                                    force_protocol=proto)
        return recv


# ---------------------------------------------------------------------------
# Root communicator: the threadcomm
# ---------------------------------------------------------------------------

class _ActivationWindow:
    """Returned by ``ThreadComm.start()``. Activation is EAGER (start() is
    MPIX_Threadcomm_start); use as a context manager for the canonical
    start/finish pair, or call ``finish()`` explicitly for service-style
    long-lived activations."""

    def __init__(self, comm: "ThreadComm"):
        self._comm = comm

    def __enter__(self) -> "ThreadComm":
        return self._comm

    def __exit__(self, *exc):
        self.finish()
        return False

    def finish(self):
        self._comm.finish()


class ThreadComm(Comm):
    """Root communicator over ``process_axes`` × ``thread_axes``: the
    paper's unified N×M rank space with process-major ordering, carrying
    the MPIX lifecycle (init → start → ... → finish → free) that bounds the
    lifetime of every derived object. ``mesh`` is a
    :class:`repro_torch.core.compat.Mesh`: its ranks share its device."""

    def __init__(self, mesh, process_axes: Sequence[str],
                 thread_axes: Sequence[str]):
        names = mesh.axis_names
        for ax in (*process_axes, *thread_axes):
            if ax not in names:
                raise ThreadCommError(f"axis {ax!r} not in mesh {names}")
        if set(process_axes) & set(thread_axes):
            raise ThreadCommError("process and thread axes must be disjoint")
        self.mesh = mesh
        self.process_axes = tuple(process_axes)
        self.thread_axes = tuple(thread_axes)
        self._root = self
        self._active = False
        self._freed = False
        self._epoch = 0
        self._attrs: Dict = {}
        self._stream_stack: List[CommStream] = []
        self._cuda = mesh.device.type == "cuda"
        sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
        self.num_processes = math.prod(
            sizes[a] for a in self.process_axes) if self.process_axes else 1
        self.threads_per_process = math.prod(
            sizes[a] for a in self.thread_axes) if self.thread_axes else 1
        self._size = self.num_processes * self.threads_per_process
        self._axis_sizes = sizes

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def _check_not_freed(self):
        if self._freed:
            raise ThreadCommError("threadcomm already freed")

    def _check_active(self):
        self._check_not_freed()
        if not self._active:
            raise ThreadCommError(
                "threadcomm is inactive: call start() (MPIX_Threadcomm_start)"
                " before communicating")

    def _check(self):  # the root's own window never goes stale
        self._check_active()

    def start(self) -> _ActivationWindow:
        """Activate the communicator (MPIX_Threadcomm_start). Eager: the
        window opens at the call. ``with tc.start():`` closes it at exit
        (MPIX_Threadcomm_finish); bare ``tc.start()`` + ``tc.finish()`` is
        the service-mode spelling for long-lived activations."""
        self._check_not_freed()
        if self._active:
            raise ThreadCommError("threadcomm already active (nested start)")
        self._active = True
        return _ActivationWindow(self)

    def finish(self):
        """Close the activation window: derived comms, groups, attributes
        and outstanding requests all become invalid (paper §2)."""
        self._check_not_freed()
        if not self._active:
            raise ThreadCommError("finish without a matching start")
        san = _san_active()
        if san is not None:       # pending requests die with the window
            san.on_finish(self)
        self._active = False
        self._attrs.clear()        # attribute lifetime = activation window
        self._stream_stack.clear()
        self._epoch += 1

    def free(self):
        self._check_not_freed()
        if self._active:
            raise ThreadCommError("cannot free an active threadcomm "
                                  "(call finish first)")
        self._freed = True

    # ------------------------------------------------------------------
    # rank arithmetic (host side)
    # ------------------------------------------------------------------
    @property
    def size(self) -> int:
        return self._size

    @property
    def unified_axes(self) -> Tuple[str, ...]:
        return self.process_axes + self.thread_axes

    def rank_of(self, coords: dict) -> int:
        """Unified rank for mesh coordinates — process-major (paper §2)."""
        r = 0
        for ax in self.unified_axes:
            r = r * self._axis_sizes[ax] + coords[ax]
        return r

    def coords_of(self, rank: int) -> dict:
        out = {}
        for ax in reversed(self.unified_axes):
            out[ax] = rank % self._axis_sizes[ax]
            rank //= self._axis_sizes[ax]
        return out

    def process_of(self, rank: int) -> int:
        return rank // self.threads_per_process

    def thread_of(self, rank: int) -> int:
        return rank % self.threads_per_process

    def families(self) -> List[List[int]]:
        return [list(range(self.size))]

    def local_rank(self) -> torch.Tensor:
        return self.device_rank()

    def group(self, ranks: Sequence[int]) -> Group:
        self._check_active()
        return Group(self, tuple(ranks), _epoch=self._epoch)

    # attributes (paper: lifetime bounded by the activation window)
    def set_attr(self, key, value):
        self._check_active()
        self._attrs[key] = value

    def get_attr(self, key):
        self._check_active()
        return self._attrs.get(key)

    # ------------------------------------------------------------------
    # derivation
    # ------------------------------------------------------------------
    def _clone(self) -> "AxisComm":
        return AxisComm(self, self.unified_axes)

    def process_comm(self) -> AxisComm:
        """Slow-domain family: one sub-comm of the N processes per thread
        index (ranks differing only in process coords)."""
        self._check_active()
        return AxisComm(self, self.process_axes)

    def thread_comm(self) -> AxisComm:
        """Fast-domain family: one sub-comm of the M threads per process
        (the shared-memory domain)."""
        self._check_active()
        return AxisComm(self, self.thread_axes)

    def _axis_aligned(self, groups: Sequence[Sequence[int]]
                      ) -> Optional[Tuple[str, ...]]:
        """If ``groups`` exactly tile some axes-subset sub-grid in row-major
        local order, return those axes (split fast path)."""
        all_ranks = sorted(r for g in groups for r in g)
        if all_ranks != list(range(self.size)):
            return None
        want = {tuple(g) for g in groups}
        axes_list = list(self.unified_axes)
        for k in range(len(axes_list), -1, -1):
            for axes in combinations(axes_list, k):
                fams = AxisComm(self, axes).families()
                if {tuple(f) for f in fams} == want:
                    return axes
        return None

    # ------------------------------------------------------------------
    # per-rank unified rank (call inside run)
    # ------------------------------------------------------------------
    def device_rank(self) -> torch.Tensor:
        """int64 (R,): each stacked rank's unified rank."""
        return axis_index(self.unified_axes)

    # ------------------------------------------------------------------
    # SPMD launcher
    # ------------------------------------------------------------------
    def run(self, fn: Callable, *args, in_specs=None, out_specs=None):
        """Run ``fn`` once over the rank-stacked shards of ``args``
        (``compat.shard_map``). Default specs split the leading dim over
        all unified axes (SPMD over ranks)."""
        self._check_active()
        in_specs = in_specs if in_specs is not None else P(self.unified_axes)
        out_specs = out_specs if out_specs is not None else P(self.unified_axes)
        return shard_map(fn, mesh=self.mesh, in_specs=in_specs,
                         out_specs=out_specs)(*args)

    # ------------------------------------------------------------------
    # collectives over the unified rank space
    # ------------------------------------------------------------------
    def allreduce(self, x, schedule: str = "psum", wire_dtype=None):
        self._check_active()
        if schedule == "hierarchical":
            return self._hierarchical_allreduce(x, wire_dtype=wire_dtype)
        if schedule == "hierarchical_tree":
            return self._hierarchical_tree_allreduce(x)
        return coll.allreduce(x, self.unified_axes, schedule=schedule,
                              wire_dtype=wire_dtype)

    def _hierarchical_allreduce(self, x, wire_dtype=None):
        """The paper's two-level schedule as a sub-comm composition:
        thread_comm.reduce_scatter → process_comm.allreduce (1/M bytes on
        the slow domain) → thread_comm.allgather."""
        tcomm, pcomm = self.thread_comm(), self.process_comm()
        if tcomm.size == 1:
            return pcomm.allreduce(x, wire_dtype=wire_dtype)
        R = x.shape[0]
        flat = x.reshape(R, -1)
        numel = flat.shape[1]
        pad = (-numel) % tcomm.size
        if pad:
            flat = F.pad(flat, (0, pad))
        shard = tcomm.reduce_scatter(flat)
        if pcomm.size > 1:
            shard = pcomm.allreduce(shard, wire_dtype=wire_dtype)
        full = tcomm.allgather(shard, tiled=True)
        return full[:, :numel].reshape(x.shape).to(x.dtype)

    def _hierarchical_tree_allreduce(self, x):
        """Latency-oriented composition over derived comms (small payloads):
        thread_comm.reduce → process_comm.allreduce → thread_comm.bcast."""
        tcomm, pcomm = self.thread_comm(), self.process_comm()
        y = tcomm.reduce(x, root=0, schedule="binomial") if tcomm.size > 1 else x
        if pcomm.size > 1:
            y = pcomm.allreduce(y)
        return tcomm.bcast(y, root=0) if tcomm.size > 1 else y

    def barrier(self, token, mode: str = "msg"):
        self._check_active()
        return coll.barrier(token, self.unified_axes, mode=mode)

    def reduce(self, x, root: int = 0, schedule: str = "binomial"):
        self._check_active()
        return coll.reduce(x, self.unified_axes, root=root, schedule=schedule)

    def bcast(self, x, root: int = 0):
        self._check_active()
        return coll.bcast(x, self.unified_axes, root=root)

    def allgather(self, x, tiled: bool = True):
        self._check_active()
        return coll.allgather(x, self.unified_axes, tiled=tiled)

    def reduce_scatter(self, x):
        self._check_active()
        return coll.reduce_scatter(x, self.unified_axes)

    def alltoall(self, x):
        self._check_active()
        return coll.alltoall(x, self.unified_axes)

    def send_recv(self, x, pairs, *, force_protocol: Optional[str] = None):
        self._check_active()
        if force_protocol is None:
            return coll.sendrecv(x, self.unified_axes, pairs)
        recv, _ = p2p_mod.send_recv(x, self.unified_axes, list(pairs),
                                    force_protocol=force_protocol)
        return recv


def threadcomm_init(mesh, process_axes: Sequence[str] = (),
                    thread_axes: Optional[Sequence[str]] = None,
                    num_threads: Optional[int] = None) -> ThreadComm:
    """MPIX_Threadcomm_init analogue. ``num_threads``, when given, must match
    the thread-axes product (the paper's creation-parameter check)."""
    if thread_axes is None:
        thread_axes = tuple(a for a in mesh.axis_names
                            if a not in tuple(process_axes))
    tc = ThreadComm(mesh, process_axes, thread_axes)
    if num_threads is not None and num_threads != tc.threads_per_process:
        raise ThreadCommError(
            f"num_threads={num_threads} does not match the parallel region "
            f"width {tc.threads_per_process}")
    return tc
