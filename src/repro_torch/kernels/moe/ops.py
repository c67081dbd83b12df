"""Public wrapper for the top-k expert kernels of the dropless MoE layer:
checks, dispatch and launch counters.

``moe_experts(x, idx, gates, w_gate, w_up, w_down)`` takes the router's
output for x ``(T, d)`` (expert ids ``(T, K)``, renormalised float32
gates ``(T, K)``) and the stacked expert weights ``(E, d, f)``, ``(E, d,
f)``, ``(E, f, d)``, read in place, and returns ``(T, d)`` in x's dtype:
each token's sum over its K experts of ``gate * (silu(x . w_gate[e]) *
(x . w_up[e])) . w_down[e]``. Only the (token, slot) assignments that
picked an expert run its products. This equals the reference's dense
sum in which every other expert carries a zero gate: a zero-gated expert
adds exactly 0 there.

Tensors on the CPU take the plain version (``ref.moe_experts_ref``);
tensors on the card launch the hand-written CUDA kernels
(``csrc/moe.cu``: dispatch tables, row gather, the grouped gate/up and
down products, the combine; five launches, no host sync), or raise.
There is no fallback from one to the other. On ``meta`` (the dry run)
a call runs the same products' shapes, as one product over the T * K
assignment rows each, which is what a trace on meta counts.

The module counts what it ran, in plain integers: ``moe_launches`` (one
per call on the card: the five launches of one layer's experts) and
``ref_calls`` (one per plain-version call). :func:`reset_counters`
zeroes them.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.moe.ref import (dispatch_ref, moe_experts_ref,
                                         tile_rows_bound)

moe_launches = 0
ref_calls = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: rows of a grouped product's row tile, by dtype (``wg::BM`` and
#: ``simt::BM`` in the CUDA source)
TILE_ROWS = {torch.float32: 64, torch.bfloat16: 128}
MAX_EXPERTS = 256

_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p


def reset_counters() -> None:
    global moe_launches, ref_calls
    with _build.count_lock:
        moe_launches = ref_calls = 0


def count(name: str) -> None:
    """Add one to the counter ``name`` (``moe_launches`` or
    ``ref_calls``) under the port's count lock."""
    _build.count(globals(), name)


def counters() -> dict:
    return {"moe_launches": moe_launches, "ref_calls": ref_calls}


def _lib():
    lib = _build.library("moe")
    if lib.moe_forward.argtypes is None:
        lib.moe_forward.argtypes = [_I, _P, _P, _L, _P, _P, _P, _P, _I, _I,
                                    _I, _I, _I, _I, _I, _P, _L, _P, _P]
        lib.moe_forward.restype = _I
        lib.moe_scratch_bytes.argtypes = [_I] * 7
        lib.moe_scratch_bytes.restype = _L
        lib.moe_dispatch.argtypes = [_P, _L, _I, _I, _I, _I, _I, _P, _P]
        lib.moe_dispatch.restype = _I
    return lib


@functools.lru_cache(maxsize=64)
def _scratch_bytes(dtype: int, T: int, K: int, E: int, d: int, f: int,
                   R: int) -> int:
    return int(_lib().moe_scratch_bytes(dtype, T, K, E, d, f, R))


def _check_inputs(x, idx, gates, w_gate, w_up, w_down):
    dev = x.device
    for name, t in (("idx", idx), ("gates", gates), ("w_gate", w_gate),
                    ("w_up", w_up), ("w_down", w_down)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    dt = x.dtype
    if dt not in _DTYPES:
        raise TypeError(f"the expert kernels take float32 or bfloat16, got "
                        f"{dt}")
    if w_gate.dtype != dt or w_up.dtype != dt or w_down.dtype != dt:
        raise TypeError("the expert weights must be in x's dtype")
    if idx.dtype != torch.int64 or gates.dtype != torch.float32:
        raise TypeError("idx must be int64 and gates float32")
    xs, ks, es = x.shape, idx.shape, w_gate.shape
    if len(xs) != 2 or len(ks) != 2 or ks != gates.shape or ks[0] != xs[0] \
            or len(es) != 3 or xs[1] != es[1] or w_up.shape != es \
            or w_down.shape != (es[0], es[2], es[1]):
        raise ValueError(f"x must be (T, d), idx and gates (T, K), the "
                         f"weights (E, d, f), (E, d, f), (E, f, d); got "
                         f"{tuple(xs)}, {tuple(ks)}, {tuple(gates.shape)}, "
                         f"{tuple(es)}, {tuple(w_up.shape)}, "
                         f"{tuple(w_down.shape)}")
    if not 1 <= es[0] <= MAX_EXPERTS:
        raise ValueError(f"{es[0]} experts: the kernels take 1 to "
                         f"{MAX_EXPERTS}")


def _check_card(x, idx, w_gate, w_up, w_down):
    _, d, f = w_gate.shape
    if d % 8 or f % 8:
        raise ValueError(f"d_model {d} and d_ff {f} must be multiples of 8")
    if idx.stride(1) != 1:
        raise ValueError("idx needs a contiguous last dimension")
    if not (w_gate.is_contiguous() and w_up.is_contiguous()
            and w_down.is_contiguous()):
        raise ValueError("the expert weights must be contiguous")
    if x.shape[0] * idx.shape[1] >= 2 ** 31:
        raise ValueError("T * K must stay below 2**31")


def _on_device(index: int, fn, *args):
    """``fn(*args)`` with the card ``index`` current (a context switch
    only when another card is)."""
    if index == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(index):
        return fn(*args)


def dispatch(idx, num_experts: int, bm: int):
    """The dispatch tables of ``idx`` (T, K) int64 expert ids with row
    tiles of ``bm`` rows: (offsets (E + 1), perm (T * K), tiles (R, 2)),
    int32, as :func:`ref.dispatch_ref` defines them. On the card: the
    dispatch kernel alone."""
    if idx.device.type == "cpu":
        return dispatch_ref(idx, num_experts, bm)
    if idx.device.type != "cuda":
        raise ValueError(f"the dispatch runs on cuda or cpu, not "
                         f"{idx.device}")
    if idx.dtype != torch.int64 or idx.dim() != 2 or idx.stride(1) != 1:
        raise ValueError("idx must be (T, K) int64 with a contiguous last "
                         "dimension")
    T, K = idx.shape
    n, E = T * K, num_experts
    R = tile_rows_bound(n, E, bm)
    ints = torch.empty(E + 1 + n + 2 * R, dtype=torch.int32,
                       device=idx.device)
    lib, dev = _lib(), idx.get_device()
    err = _on_device(dev, lib.moe_dispatch, idx.data_ptr(), idx.stride(0), T,
                     K, E, bm, R, ints.data_ptr(),
                     torch._C._cuda_getCurrentRawStream(dev))
    _build.check(lib, err, "moe_dispatch")
    return (ints[:E + 1], ints[E + 1:E + 1 + n],
            ints[E + 1 + n:].view(-1, 2))


def launch(x, idx, gates, w_gate, w_up, w_down):
    """Launch the expert kernels on the card: x (T, d), idx (T, K) int64
    (a contiguous last dimension), gates (T, K) float32, the weights
    contiguous in x's dtype. Returns (T, d) in x's dtype."""
    _check_inputs(x, idx, gates, w_gate, w_up, w_down)
    _check_card(x, idx, w_gate, w_up, w_down)
    T, K = idx.shape
    E, d, f = w_gate.shape
    out = torch.empty((T, d), dtype=x.dtype, device=x.device)
    if T == 0:
        return out
    x, gates = x.contiguous(), gates.contiguous()
    dt, n, bm = _DTYPES[x.dtype], T * K, TILE_ROWS[x.dtype]
    R = tile_rows_bound(n, E, bm)
    nbytes = _scratch_bytes(dt, T, K, E, d, f, R)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    lib, dev = _lib(), x.get_device()
    err = _on_device(
        dev, lib.moe_forward, dt, x.data_ptr(), idx.data_ptr(),
        idx.stride(0), gates.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
        w_down.data_ptr(), T, K, E, d, f, bm, R, scratch.data_ptr(), nbytes,
        out.data_ptr(), torch._C._cuda_getCurrentRawStream(dev))
    _build.check(lib, err, "moe_forward")
    count("moe_launches")
    return out


def _meta_experts(x, idx, w_gate, w_up, w_down):
    """The dry run's stand-in on ``meta``: the gather, the two grouped
    products as one product over the T * K assignment rows each, the
    float32 rows and the combine, with the kernels' shapes."""
    T, K = idx.shape
    xs = x.repeat_interleave(K, dim=0)                           # (T*K, d)
    h = F.silu(xs @ w_gate[0]) * (xs @ w_up[0])
    y = (h @ w_down[0]).float()
    return y.view(T, K, -1).sum(dim=1).to(x.dtype)


def moe_experts(x, idx, gates, w_gate, w_up, w_down):
    """x (T, d), idx (T, K) expert ids, gates (T, K) float32, w_gate /
    w_up (E, d, f), w_down (E, f, d) -> (T, d) in x's dtype: each token
    through its K experts only, combined under its gates."""
    if x.device.type == "cpu":
        _check_inputs(x, idx, gates, w_gate, w_up, w_down)
        count("ref_calls")
        return moe_experts_ref(x, idx, gates, w_gate, w_up, w_down)
    if x.device.type == "cuda":
        return launch(x, idx, gates, w_gate, w_up, w_down)
    if x.device.type == "meta":
        return _meta_experts(x, idx, w_gate, w_up, w_down)
    raise ValueError(f"the expert kernels run on cuda or cpu, not "
                     f"{x.device}")
