"""Public wrapper for the msgq message copies: protocol dispatch,
padding, round programs, and launch counters.

Follows the reference wrapper (``src/repro/kernels/msgq/ops.py``):
``msgq_copy`` picks eager (a staged copy through a bounded cell, 2
copies) or 1-copy (direct) by message size with the paper's interthread
threshold, and pads as the reference pads. ``msgq_round`` moves a whole
message round between the ranks of a rank-stacked region
(``core/compat.py``): it is what ``core.collectives.ppermute`` calls for
a single message round. ``msgq_program`` runs a collective's sequence of
rounds (``program.py``) in ONE launch. ``copy_accounting`` reports the
bytes each protocol moves.

Tensors on the CPU take the plain version (``ref.py``); tensors on the
card launch the hand-written CUDA kernels (``csrc/msgq.cu``), or raise.
There is no fallback from one to the other. The module counts what it
ran, in plain integers bumped through ``kernels/_build.count``:
``eager_launches`` and ``one_copy_launches`` (one per kernel launch, a
whole program included) and ``ref_calls`` (one per plain-version call: a
round, or a whole program). :func:`reset_counters` zeroes them.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import protocol
from repro_torch.kernels import _build
from repro_torch.kernels.msgq.program import Program
from repro_torch.kernels.msgq.ref import msgq_program_ref, msgq_round_ref

eager_launches = 0
one_copy_launches = 0
ref_calls = 0
#: the path of the last launch: "bulk" (16-byte access: bulk copies
#: through shared-memory cells), "vector" (narrower: threads copy through
#: one cell) or "direct" (the 1-copy kernel's direct copy)
last_path = ""

#: pairs a single round carries (the kernel's by-value pair table)
MAX_PAIRS = 256
#: the largest eager cell (a CTA's ring holds two cells a slot)
MAX_CELL_BYTES = 48 * 1024
#: what the kernels' add and max combine (``csrc/msgq.cu``: ``by_dtype``);
#: copy, replace and mask move bytes of any dtype
DTYPE_CODE = {torch.float32: 1, torch.bfloat16: 2, torch.float16: 3,
              torch.float64: 4, torch.int32: 5, torch.int64: 6}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def reset_counters() -> None:
    global eager_launches, one_copy_launches, ref_calls
    with _build.count_lock:
        eager_launches = one_copy_launches = ref_calls = 0


def count(name: str) -> None:
    """Add one to the counter ``name`` (``eager_launches``,
    ``one_copy_launches`` or ``ref_calls``) under the port's count lock."""
    _build.count(globals(), name)


def counters() -> dict:
    return {"eager_launches": eager_launches,
            "one_copy_launches": one_copy_launches, "ref_calls": ref_calls}


def _lib():
    lib = _build.library("msgq")
    if lib.msgq_eager.argtypes is None:
        # x, out, scratch, x_stride, m, R, pairs, npairs, table, shapes,
        # rounds, [cell,] vec, dtype, stream
        common = [_P, _P, _P, _LL, _LL, _I, _P, _I, _P, _P, _I]
        lib.msgq_eager.argtypes = common + [_I, _I, _I, _P]
        lib.msgq_eager.restype = _I
        lib.msgq_one_copy.argtypes = common + [_I, _I, _P]
        lib.msgq_one_copy.restype = _I
    return lib


def is_eager(proto: str) -> bool:
    """Eager-class protocols stage through a cell; the rest copy once."""
    return protocol.validate_protocol(proto) in ("eager_fast", "eager")


def slab_stride(x: torch.Tensor) -> Optional[int]:
    """Bytes between consecutive ranks' slabs of x (R, ...), or None when
    a slab is not one contiguous run of bytes."""
    expected = 1
    for size, stride in zip(reversed(x.shape[1:]), reversed(x.stride()[1:])):
        if size != 1 and stride != expected:
            return None
        expected *= size
    return x.stride(0) * x.element_size()


def _width(*values: int) -> int:
    """The widest access (16, 8, 4, 2 or 1 bytes) dividing every value."""
    w = 16
    for v in values:
        while v % w:
            w //= 2
    return w


def _check_pairs(pairs: Sequence[Tuple[int, int]], R: int
                 ) -> List[Tuple[int, int]]:
    pairs = [(int(s), int(d)) for s, d in pairs]
    dsts = [d for _, d in pairs]
    if len(set(dsts)) != len(dsts):
        raise ValueError(f"a rank receives twice in one round: {pairs}")
    for s, d in pairs:
        if not (0 <= s < R and 0 <= d < R):
            raise ValueError(f"pair {(s, d)} names a rank outside 0..{R - 1}")
    return pairs


def _device_plan(program: Program, R: int, numel: int, item: int, device):
    """The program's table on the card and its host-side shapes, made
    once (one copy to the card, at the first call)."""
    def make():
        plan = program.device_plan(R, numel, item)
        table = torch.tensor(plan.words, dtype=torch.int64).to(device)
        shapes = (ctypes.c_longlong * len(plan.shapes))(*plan.shapes)
        arith = any(r.combine in ("add", "max") for r in program.rounds)
        return plan, table, shapes, arith
    return program.memo((str(device), R, numel, item), make)


def launch(x: torch.Tensor, pairs: Optional[List[Tuple[int, int]]] = None,
           *, proto: str, cell_elems: int,
           program: Optional[Program] = None) -> torch.Tensor:
    """Launch one round (``pairs``) or a whole ``program`` on the card: x
    (R, ...) with each rank's slab one contiguous run of bytes (any
    stride between slabs). Returns a fresh contiguous (R, ...) tensor."""
    global last_path
    stride = slab_stride(x)
    if stride is None:
        raise ValueError("each rank's slab must be one contiguous run of "
                         "bytes")
    R = x.shape[0]
    numel = x[0].numel() if R else 0
    item = x.element_size()
    m = numel * item
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if R == 0:
        return out
    eager = is_eager(proto)
    cell = cell_elems * item
    if eager and not 0 < cell <= MAX_CELL_BYTES:
        raise ValueError(f"an eager cell of {cell} bytes is outside "
                         f"1..{MAX_CELL_BYTES}")
    scratch = table = shapes = flat = None
    nrounds, dtype, align = 1, 0, 16
    if program is None:
        received = {d for _, d in pairs}
        rows = pairs + [(-1, d) for d in range(R) if d not in received]
        if len(rows) > MAX_PAIRS:
            raise ValueError(f"a round of {len(rows)} ranks exceeds the "
                             f"kernel's {MAX_PAIRS}")
        flat = (ctypes.c_int * (2 * len(rows)))(*(v for p in rows for v in p))
        npairs = len(rows)
    else:
        plan, table, shapes, arith = _device_plan(program, R, numel, item,
                                                  x.device)
        if arith:
            if x.dtype not in DTYPE_CODE:
                raise ValueError(f"the msgq kernels add and max "
                                 f"{sorted(map(str, DTYPE_CODE))}, not "
                                 f"{x.dtype}")
            dtype = DTYPE_CODE[x.dtype]
        if plan.scratch:
            scratch = torch.empty_like(out)
        nrounds, align, npairs = plan.rounds, plan.align, 0
    vec = _width(x.data_ptr(), out.data_ptr(),
                 scratch.data_ptr() if scratch is not None else 0, stride,
                 m, cell if eager else 0, align)
    lib = _lib()
    args = (x.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None, stride, m,
            R, flat, npairs, table.data_ptr() if table is not None else None,
            shapes, nrounds)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if eager:
            err = lib.msgq_eager(*args, cell, vec, dtype, stream)
        else:
            err = lib.msgq_one_copy(*args, vec, dtype, stream)
    _build.check(lib, err, "msgq_eager" if eager else "msgq_one_copy")
    last_path = ("direct" if not eager else "bulk" if vec == 16
                 else "vector")
    count("eager_launches" if eager else "one_copy_launches")
    return out


def msgq_round(x: torch.Tensor, pairs: Sequence[Tuple[int, int]], *,
               proto: str, cell_elems: int = 1024) -> torch.Tensor:
    """One message round: x (R, ...) holds one slab per rank; every (src,
    dst) pair delivers src's slab to dst, through the eager kernel (cells
    of ``cell_elems`` elements) or the 1-copy kernel by ``proto``. Returns
    a fresh (R, ...) tensor, zero at every rank named as no dst."""
    pairs = _check_pairs(pairs, x.shape[0])
    protocol.validate_protocol(proto)
    if x.device.type == "cpu":
        count("ref_calls")
        return msgq_round_ref(x, pairs)
    if x.device.type == "cuda":
        return launch(x, pairs, proto=proto, cell_elems=cell_elems)
    raise ValueError(f"msgq runs on cuda or cpu, not {x.device}")


def msgq_program(x: torch.Tensor, program: Program, *, proto: str,
                 cell_elems: int = 1024) -> torch.Tensor:
    """Run a round program (``program.py``) on x (R, ...): on the card in
    ONE launch of the eager kernel (cells of ``cell_elems`` elements) or
    the 1-copy kernel by ``proto``; on the CPU its plain version, round by
    round. Returns a fresh contiguous (R, ...) tensor."""
    protocol.validate_protocol(proto)
    if x.dim() == 0:
        raise ValueError("a program runs on per-rank slabs (R, ...)")
    R = x.shape[0]
    program.check(R, x[0].numel() if R else 0)
    if x.device.type == "cpu":
        count("ref_calls")
        return msgq_program_ref(x, program)
    if x.device.type == "cuda":
        if slab_stride(x) is None:
            x = x.contiguous()
        return launch(x, proto=proto, cell_elems=cell_elems,
                      program=program)
    raise ValueError(f"msgq runs on cuda or cpu, not {x.device}")


def _pad_to(flat: torch.Tensor, m: int):
    pad = (-flat.numel()) % m
    return (F.pad(flat, (0, pad)) if pad else flat), pad


def msgq_copy(msg: torch.Tensor, *, force_protocol: Optional[str] = None,
              cell_elems: int = 1024):
    """Copy a message (any shape) through the selected protocol. Returns
    (copy, protocol)."""
    flat = msg.reshape(-1)
    nbytes = flat.numel() * flat.element_size()
    proto = (protocol.validate_protocol(force_protocol) if force_protocol
             else protocol.select_protocol(
                 nbytes, cell=cell_elems * flat.element_size()))
    if is_eager(proto):
        padded, pad = _pad_to(flat, cell_elems)
    else:
        block = min(65536, max(256, 1 << (flat.numel() - 1).bit_length()))
        padded, pad = _pad_to(flat, block)
    out = msgq_round(padded[None], [(0, 0)], proto=proto,
                     cell_elems=cell_elems)[0]
    if pad:
        out = out[:flat.numel()]
    return out.reshape(msg.shape), proto


def copy_accounting(nbytes: int, proto: str,
                    cell_bytes: int = 4096) -> Dict[str, float]:
    """Bytes moved / copy issues per protocol (the Fig. 3 story)."""
    ncells = -(-nbytes // cell_bytes)
    if proto in ("eager_fast", "eager"):
        return {"bytes_moved": 2.0 * nbytes, "dma_issues": 2 * ncells,
                "staging_bytes": min(nbytes, cell_bytes)}
    return {"bytes_moved": float(nbytes), "dma_issues": ncells,
            "staging_bytes": 0.0}
