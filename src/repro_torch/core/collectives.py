"""Executable collectives over a unified rank space, built from message
rounds (:func:`ppermute`) and the schedules of :mod:`repro_torch.core.
schedules` — the port of ``src/repro/core/collectives.py``.

Every function runs inside a rank-stacked region (``core/compat.py``:
``shard_map`` or ``ThreadComm.run``) and takes per-rank values stacked
along dim 0: ``x`` is ``(R, *local)``, a per-rank scalar is ``(R,)``.
``axes`` is one mesh-axis name or a tuple; a tuple spans the flattened
(row-major, process-major) rank space of those axes, exactly the
threadcomm construction. Ranks that agree on every other mesh axis form
one family, and a collective acts in every family at once.

Two implementations exist for most ops, as in the reference:
  * schedule-explicit: message rounds of a ``kernels/msgq`` copy (eager
    through a shared-memory cell, or 1-copy, picked by the per-rank
    message size as ``protocol.select_protocol`` picks it) — the paper's
    point-to-point-based algorithms (§4.2). ``barrier(mode="msg")``,
    ``reduce``, ``bcast`` and the recursive-doubling, ring and
    reduce_bcast allreduces fold their rounds into one round program
    (``kernels/msgq/program.py``), built once per (schedule, root,
    family layout, ranks, elements, dtype) and run by ONE launch on the
    card (its plain version on the CPU); the reference runs one
    ``lax.ppermute`` a round, with the same results. A lone round
    (``ppermute``) and the ``wire_dtype`` allreduce stay one launch a
    round;
  * native (``psum`` and friends): plain reductions and reshapes over the
    stacked rank dim, the counterpart of XLA's fused collectives.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core import protocol
from repro_torch.core import schedules as sch
from repro_torch.core.compat import axis_index, current_region
from repro_torch.kernels.msgq import ops as msgq
from repro_torch.kernels.msgq.program import Program, Round

Axes = Union[str, Tuple[str, ...]]


def axis_size(axes: Axes) -> int:
    """Total size of (possibly tuple) mapped axes."""
    return current_region().axis_size(axes)


def unified_rank(axes: Axes) -> torch.Tensor:
    """int64 (R,): each rank's flattened row-major index over ``axes``."""
    return axis_index(axes)


def rank_nbytes(x: torch.Tensor) -> int:
    """Bytes of one rank's message (the slab of a stacked value)."""
    return x[0].numel() * x.element_size()


def _dtype(d) -> torch.dtype:
    return getattr(torch, d) if isinstance(d, str) else d


# ---------------------------------------------------------------------------
# The message round and the native reductions
# ---------------------------------------------------------------------------

def ppermute(x: torch.Tensor, axes: Axes, pairs: Sequence[Tuple[int, int]],
             proto: Optional[str] = None) -> torch.Tensor:
    """One message round: each (src, dst) pair of LOCAL ranks delivers
    src's slab to dst in every family; ranks named as no dst receive
    zeros (as ``lax.ppermute``). The whole round is one msgq launch, with
    ``proto`` (default: chosen by the per-rank size). Returns a fresh
    tensor, never ``x``."""
    region = current_region()
    if x.dim() == 0 or x.shape[0] != region.size:
        raise ValueError(f"ppermute of a {tuple(x.shape)} value, not a "
                         f"per-rank (R={region.size}, ...) one")
    if msgq.slab_stride(x) is None:
        x = x.contiguous()
    proto = (protocol.validate_protocol(proto) if proto
             else protocol.select_protocol(rank_nbytes(x)))
    cell_elems = max(1, protocol.DEFAULT_CELL_SIZE // x.element_size())
    return msgq.msgq_round(x, region.pairs(axes, pairs), proto=proto,
                           cell_elems=cell_elems)


def _fold(x: torch.Tensor, axes: Axes, schedule: str, build,
          root: int = 0, msg_elems: Optional[int] = None) -> torch.Tensor:
    """Run the round program ``build(region, n)`` of a schedule on x in
    one msgq launch (the plain version on the CPU); the program is made
    once per (schedule, root, axes, elements, dtype) of the region, whose
    mesh fixes the family layout and the ranks. ``msg_elems``: the
    elements of one message (default: the whole slab), which pick the
    protocol as ``ppermute`` picks it."""
    region = current_region()
    if x.dim() == 0 or x.shape[0] != region.size:
        raise ValueError(f"a collective of a {tuple(x.shape)} value, not a "
                         f"per-rank (R={region.size}, ...) one")
    n = region.axis_size(axes)
    numel = x[0].numel()
    program = region.memo(
        ("program", schedule, root, axes, numel, x.dtype),
        lambda: Program(build(region, n)))
    if not program.rounds:
        return x
    item = x.element_size()
    proto = protocol.select_protocol(
        (numel if msg_elems is None else msg_elems) * item)
    return msgq.msgq_program(x, program, proto=proto, cell_elems=max(
        1, protocol.DEFAULT_CELL_SIZE // item))


def _rounds(region, axes: Axes, schedule, combine: str) -> list:
    return [Round(region.pairs(axes, rnd), combine) for rnd in schedule]


def psum(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    region = current_region()
    g = region.grouped(x, axes)
    return region.per_family(g.sum(1, dtype=x.dtype), axes)


def pmax(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    region = current_region()
    return region.per_family(region.grouped(x, axes).amax(1), axes)


def all_gather(x: torch.Tensor, axes: Axes, tiled: bool = False
               ) -> torch.Tensor:
    """Each rank gets its family's slabs by local rank: stacked (R, k,
    *local) or, ``tiled``, concatenated along the local dim 0."""
    region = current_region()
    g = region.grouped(x, axes)                       # (F, k, *local)
    if tiled:
        if x.dim() < 2:
            raise ValueError("a tiled all_gather needs local rank >= 1")
        g = g.reshape((g.shape[0], g.shape[1] * g.shape[2])
                      + tuple(g.shape[3:]))
    return region.per_family(g, axes)


def psum_scatter(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    """Sum over the family, local rank r keeping chunk r of local dim 0."""
    region = current_region()
    k = region.axis_size(axes)
    if x.dim() < 2 or x.shape[1] % k:
        raise ValueError(f"psum_scatter of local shape {tuple(x.shape[1:])}"
                         f" over {k} ranks")
    # the family sums, each rank then taking its chunk of its family's:
    # never a full (R, ...) copy of the sum
    g = region.grouped(x, axes)                       # (F, k, *local)
    total = g.sum(1, dtype=x.dtype)
    chunks = total.reshape((total.shape[0], k, x.shape[1] // k)
                           + tuple(x.shape[2:]))
    _, fam = region.family(axes)
    fam = region.on_device(("family_index", tuple(region.order), axes),
                           lambda: fam)
    return chunks[fam, region.axis_index(axes)]


def all_to_all(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    """Local rank r's chunk j goes to local rank j, which concatenates
    the chunks it receives by source rank (split and concat on dim 0)."""
    region = current_region()
    k = region.axis_size(axes)
    if x.dim() < 2 or x.shape[1] % k:
        raise ValueError(f"all_to_all of local shape {tuple(x.shape[1:])}"
                         f" over {k} ranks")
    g = region.grouped(x, axes)                       # (F, src, l0, ...)
    F_, c = g.shape[0], x.shape[1] // k
    g = g.reshape((F_, k, k, c) + tuple(x.shape[2:])).transpose(1, 2)
    return region.ungrouped(
        g.reshape((F_, k, k * c) + tuple(x.shape[2:])), axes)


# ---------------------------------------------------------------------------
# Barrier
# ---------------------------------------------------------------------------

def barrier(token, axes: Axes, mode: str = "msg") -> torch.Tensor:
    """The returned (R,) token depends on every rank's input token.

    mode="msg":    dissemination algorithm, lg N message rounds — the
                   paper's point-to-point MPI_Barrier (Fig. 4).
    mode="atomic": one fused max — the shared-atomics reimplementation.
    """
    token = torch.as_tensor(token).to(torch.float32)
    if mode == "atomic":
        return pmax(token, axes)
    return _fold(token, axes, "dissemination", lambda region, n: _rounds(
        region, axes, sch.dissemination_rounds(n), "max"))


# ---------------------------------------------------------------------------
# Reduce / Bcast (binomial trees)
# ---------------------------------------------------------------------------

def reduce(x, axes: Axes, root: int = 0, schedule: str = "binomial"):
    """Sum-reduce to ``root``. Non-root ranks return partial garbage (like
    MPI_Reduce's undefined recv buffers). schedule='psum' is the fused
    analogue (valid everywhere)."""
    if schedule == "psum":
        return psum(x, axes)
    # each round: x + received (non-receivers add zeros)
    return _fold(x, axes, "binomial_reduce", lambda region, n: _rounds(
        region, axes, sch.binomial_reduce_rounds(n, root), "add"), root)


def bcast(x, axes: Axes, root: int = 0):
    """Binomial broadcast from ``root`` over the unified rank space."""
    # each round: a dst takes what it received, every other rank keeps x
    return _fold(x, axes, "binomial_bcast", lambda region, n: _rounds(
        region, axes, sch.binomial_bcast_rounds(n, root), "replace"), root)


def _reduce_bcast_rounds(region, axes: Axes, n: int) -> list:
    """Binomial reduce to local rank 0, the non-root partials masked to
    zeros, binomial bcast from local rank 0."""
    if n == 1:
        return []
    members, _ = region.family(axes)
    roots = [(int(f[0]), int(f[0])) for f in members]
    return (_rounds(region, axes, sch.binomial_reduce_rounds(n, 0), "add")
            + [Round(roots, "mask")]
            + _rounds(region, axes, sch.binomial_bcast_rounds(n, 0),
                      "replace"))


# ---------------------------------------------------------------------------
# Allreduce
# ---------------------------------------------------------------------------

def allreduce(x, axes: Axes, schedule: str = "psum", wire_dtype=None):
    """``wire_dtype`` compresses the on-wire representation (e.g. bfloat16
    halves the bytes of an f32 gradient reduce) while accumulating in the
    input dtype, on the point-to-point recursive-doubling schedule (a
    ring of n - 1 rounds when n is not a power of two)."""
    if wire_dtype is not None:
        wire = _dtype(wire_dtype)
        n = axis_size(axes)
        if n <= 1:
            return x
        if n & (n - 1) == 0:
            for rnd in sch.recursive_doubling_rounds(n):
                x = x + ppermute(x.to(wire), axes, rnd).to(x.dtype)
            return x
        ring = sch.ring_rounds(n)[0]
        carry = x
        for _ in range(n - 1):
            carry = ppermute(carry.to(wire), axes, ring).to(x.dtype)
            x = x + carry
        return x
    if schedule == "psum":
        return psum(x, axes)
    if schedule == "recursive_doubling":
        return _fold(x, axes, schedule, lambda region, n: _rounds(
            region, axes, sch.recursive_doubling_rounds(n), "add"))
    if schedule == "ring":
        return _ring_allreduce(x, axes)
    if schedule == "reduce_bcast":
        return _fold(x, axes, schedule, lambda region, n:
                     _reduce_bcast_rounds(region, axes, n))
    raise ValueError(f"unknown allreduce schedule {schedule!r}")


def _ring_rounds(region, axes: Axes, n: int, c: int) -> list:
    """The ring's 2(n - 1) rounds over chunks of c elements: in round t
    of the reduce-scatter local rank r sends chunk (r - t) mod n, which
    its successor adds into its own chunk of that index; in round t of
    the allgather it sends chunk (r - t + 1) mod n, which its successor
    writes over its own."""
    members, _ = region.family(axes)
    ring = sch.ring_rounds(n)[0]

    def step(shift: int, combine: str) -> Round:
        pairs, segs = [], []
        for f in members:
            for s, d in ring:
                k = (s - shift) % n * c
                pairs.append((int(f[s]), int(f[d])))
                segs.append((k, k, c))
        return Round(pairs, combine, segs)

    return ([step(t, "add") for t in range(n - 1)]
            + [step(t - 1, "replace") for t in range(n - 1)])


def _ring_allreduce(x, axes: Axes):
    """Bandwidth-optimal ring: reduce-scatter + allgather, 2(n-1) rounds
    of one chunk a rank. Each rank sends and receives a DIFFERENT chunk
    index in a round: the rounds carry each pair's segment."""
    n = axis_size(axes)
    R = x.shape[0]
    flat = x.reshape(R, -1)
    numel = flat.shape[1]
    pad = (-numel) % n
    if pad:
        flat = F.pad(flat, (0, pad))
    c = flat.shape[1] // n
    out = _fold(flat, axes, "ring", lambda region, n_: _ring_rounds(
        region, axes, n_, c), msg_elems=c)
    return out[:, :numel].reshape(x.shape)


# ---------------------------------------------------------------------------
# Allgather / ReduceScatter / AllToAll (native, tuple-axes capable)
# ---------------------------------------------------------------------------

def allgather(x, axes: Axes, tiled: bool = True):
    return all_gather(x, axes, tiled=tiled)


def reduce_scatter(x, axes: Axes):
    return psum_scatter(x, axes)


def alltoall(x, axes: Axes):
    return all_to_all(x, axes)


# ---------------------------------------------------------------------------
# Hierarchical (threadcomm-aware) allreduce — the paper's technique
# ---------------------------------------------------------------------------

def hierarchical_allreduce(x, *, process_axes: Tuple[str, ...],
                           thread_axes: Tuple[str, ...]):
    """Two-level allreduce: reduce-scatter over the fast intra-process
    domain, allreduce the 1/M shard over the slow inter-process domain,
    allgather back. Inter-process traffic drops M× vs flat."""
    if not thread_axes:
        return psum(x, process_axes)
    R = x.shape[0]
    flat = x.reshape(R, -1)
    numel = flat.shape[1]
    pad = (-numel) % axis_size(thread_axes)
    if pad:
        flat = F.pad(flat, (0, pad))
    shard = psum_scatter(flat, thread_axes)
    if process_axes:
        shard = psum(shard, process_axes)
    full = all_gather(shard, thread_axes, tiled=True)
    return full[:, :numel].reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# Point-to-point (a message round over unified ranks)
# ---------------------------------------------------------------------------

def sendrecv(x, axes: Axes, pairs: Sequence[Tuple[int, int]]):
    """Explicit message round over unified ranks: each (src, dst) delivers
    src's slab to dst; ranks not named as dst receive zeros."""
    return ppermute(x, axes, list(pairs))
