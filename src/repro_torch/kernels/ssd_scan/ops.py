"""Public wrapper for the SSD chunk scan: dispatch, checks and launch
counters.

Keeps the reference wrapper's signature
(``src/repro/kernels/ssd_scan/ops.py``): x ``(B, H, S, p)``, dt ``(B, H,
S)`` after softplus, A ``(H,)``, Bm/Cm ``(B, S, n)`` (ngroups = 1), an
optional ``initial_state`` ``(B, H, p, n)``; returns y ``(B, H, S, p)`` in
x's dtype and, with ``return_state``, the final state ``(B, H, p, n)``
float32. Two departures, both the model path's: the chunk grid is
``chunk`` anchored at position 0 and never shrunk to ``S`` (the Pallas
wrapper takes ``l = min(chunk, S)`` and asserts ``S % l == 0``), and a
ragged ``S`` is allowed (the tail is masked as exact no-ops, as
``mamba.ssd_chunked`` pads it with ``dt = 0``). On that grid a scan split
at chunk boundaries and resumed from the returned state gives the
one-call result bit for bit on the card.

Operands may be strided views: the models hold ``(B, S, H, p)`` and
``(B, S, H)``, and pass ``transpose(1, 2)`` views, which the kernel
reads in place; y is allocated in the ``(B, S, H, p)`` layout and
returned as its ``(B, H, S, p)`` view.

Tensors on the CPU take the plain version (``ref.ssd_chunked_scan``);
tensors on the card launch the hand-written CUDA kernel
(``csrc/ssd_scan.cu``), or raise. On the card a call is one launch, over
CTAs that each take a slice of p's columns of one (b, h); the library
picks the slice width from the shapes and the card's SM count
(:func:`plan`), and the result does not depend on it, bit for bit. There is no fallback from one to the
other. The module counts what it ran, in plain integers: ``ssd_launches``
(one per kernel launch) and ``ref_calls`` (one per plain-version call).
:func:`reset_counters` zeroes them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_scan

ssd_launches = 0
ref_calls = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_I, _P = ctypes.c_int, ctypes.c_void_p


def reset_counters() -> None:
    global ssd_launches, ref_calls
    with _build.count_lock:
        ssd_launches = ref_calls = 0


def count(name: str) -> None:
    """Add one to the counter ``name`` (``ssd_launches`` or
    ``ref_calls``) under the port's count lock."""
    _build.count(globals(), name)


def counters() -> dict:
    return {"ssd_launches": ssd_launches, "ref_calls": ref_calls}


def _lib():
    lib = _build.library("ssd_scan")
    if lib.ssd_scan.argtypes is None:
        lib.ssd_scan.argtypes = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _P]
        lib.ssd_scan.restype = _I
        lib.ssd_smem_bytes.argtypes = [_I, _I, _I]
        lib.ssd_smem_bytes.restype = ctypes.c_longlong
        lib.ssd_plan.argtypes = [_I, _I, _I, _I, _I, _P]
        lib.ssd_plan.restype = None
    return lib


class Plan(NamedTuple):
    """One launch's shape: each CTA takes ``cols`` columns of p of one
    (b, h); ``ctas`` CTAs in all, each with ``smem_bytes`` of shared
    memory."""
    cols: int
    ctas: int
    smem_bytes: int


def plan(B: int, H: int, p: int, n: int, chunk: int) -> Plan:
    """The launch's shape at these widths on the current card, as the
    library picks it: the widest column slice (64, 32 or 16) that still
    gives at least one CTA per SM. Needs the built library."""
    out = (ctypes.c_longlong * 3)()
    _lib().ssd_plan(B, H, p, n, chunk, out)
    return Plan(*(int(v) for v in out))


def smem_bytes(p: int, n: int, chunk: int) -> int:
    """Shared memory one CTA takes (bytes) at the widest column slice p
    can take, as the kernel's library sizes it: the l x l score matrix
    is formed by row blocks in the buffer of their C rows, so mamba2's
    widths fit in a Hopper CTA. A launch that needs more than a CTA may
    have (or l or n above 128) fails with the library's error. Needs the
    built library."""
    return int(_lib().ssd_smem_bytes(p, n, chunk))


def _check_inputs(x, dt, A, Bm, Cm, s0, chunk):
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm),
                    ("initial_state", s0)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the scan takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    if Bm.dtype not in _DTYPES or Cm.dtype != Bm.dtype:
        raise TypeError("Bm and Cm must share one dtype, float32 or "
                        "bfloat16")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError("dt and A must be float32")
    if x.dim() != 4 or dt.dim() != 3 or Bm.dim() != 3 or Bm.shape != Cm.shape:
        raise ValueError(f"x must be (B, H, S, p), dt (B, H, S) and Bm, Cm "
                         f"(B, S, n), got {tuple(x.shape)} / "
                         f"{tuple(dt.shape)} / {tuple(Bm.shape)} / "
                         f"{tuple(Cm.shape)}")
    B, H, S, p = x.shape
    n = Bm.shape[-1]
    if tuple(dt.shape) != (B, H, S) or tuple(A.shape) != (H,) \
            or tuple(Bm.shape[:2]) != (B, S):
        raise ValueError(f"x {tuple(x.shape)} does not fit dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)} or Bm "
                         f"{tuple(Bm.shape)}")
    if s0 is not None and tuple(s0.shape) != (B, H, p, n):
        raise ValueError(f"initial_state must be {(B, H, p, n)}, got "
                         f"{tuple(s0.shape)}")
    if x.stride(3) != 1 or Bm.stride(2) != 1 or Cm.stride(2) != 1:
        raise ValueError("x, Bm and Cm need a contiguous last dimension")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")


def launch(x, dt, A, Bm, Cm, initial_state=None, *, chunk: int = 128):
    """Launch the kernel on the card. Shapes as in :func:`ssd_scan`, any
    strides with a contiguous last dimension (dt and A float32). Returns
    (y (B, H, S, p) in x's dtype — a view of a (B, S, H, p) tensor —,
    final state (B, H, p, n) float32)."""
    _check_inputs(x, dt, A, Bm, Cm, initial_state, chunk)
    B, H, S, p = x.shape
    n = Bm.shape[-1]
    A = A.contiguous()
    s0 = (None if initial_state is None
          else initial_state.to(torch.float32).contiguous())
    y = torch.empty((B, S, H, p), dtype=x.dtype,
                    device=x.device).transpose(1, 2)
    final = torch.empty((B, H, p, n), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 13)(
        *x.stride()[:3], *dt.stride(), Bm.stride(0), Bm.stride(1),
        Cm.stride(0), Cm.stride(1), *y.stride()[:3])
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan(
            _DTYPES[x.dtype], _DTYPES[Bm.dtype], x.data_ptr(), dt.data_ptr(),
            A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            None if s0 is None else s0.data_ptr(), y.data_ptr(),
            final.data_ptr(), strides, B, H, S, p, n, int(chunk), stream)
    _build.check(lib, err, "ssd_scan")
    count("ssd_launches")
    return y, final


def ssd_scan(x, dt, A, Bm, Cm, initial_state=None, *, chunk: int = 128,
             return_state: bool = False):
    """x: (B,H,S,p); dt: (B,H,S) (post-softplus); A: (H,) negative; Bm,
    Cm: (B,S,n). Returns y (B,H,S,p) in x's dtype, and with
    ``return_state`` the final state (B,H,p,n) float32. ``initial_state``
    (B,H,p,n) seeds the carried state (zeros when None)."""
    if x.device.type == "cpu":
        count("ref_calls")
        return ssd_chunked_scan(x, dt, A, Bm, Cm, initial_state, chunk=chunk,
                                return_state=return_state)
    if x.device.type != "cuda":
        raise ValueError(f"the SSD scan runs on cuda or cpu, not "
                         f"{x.device}")
    y, final = launch(x, dt, A, Bm, Cm, initial_state, chunk=chunk)
    return (y, final) if return_state else y
