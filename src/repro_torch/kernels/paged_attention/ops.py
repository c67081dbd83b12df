"""Public wrapper for paged attention: layout adapter, dispatch, and
launch counters.

Follows the reference wrapper's contract
(``src/repro/kernels/paged_attention/ops.py``): q ``(B, H, hd)`` or
``(B, 1, H, hd)`` goes to the decode kernel (``paged_decode``); q
``(B, K, H, hd)`` with ``K > 1`` goes to the multi-query kernel
(``paged_mq``), query ``j`` of row ``b`` at position
``lengths[b] - K + j``. Tensors on the CPU take the plain version
(``ref.py``); tensors on the card launch the hand-written CUDA kernel,
or raise. There is no fallback from one to the other.

The module counts what it ran, in plain integers: ``decode_launches``
and ``mq_launches`` (one per kernel launch) and ``ref_calls`` (one per
plain-version call). :func:`reset_counters` zeroes them.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

decode_launches = 0
mq_launches = 0
ref_calls = 0

#: (query, head) rows one multi-query CTA serves: enough to share each
#: staged K/V tile widely, few enough to keep ~100 KB of shared memory
_MQ_ROWS = 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_I, _P, _F = ctypes.c_int, ctypes.c_void_p, ctypes.c_float


def reset_counters() -> None:
    global decode_launches, mq_launches, ref_calls
    decode_launches = mq_launches = ref_calls = 0


def counters() -> dict:
    return {"decode_launches": decode_launches, "mq_launches": mq_launches,
            "ref_calls": ref_calls}


def _lib():
    lib = _build.library("paged_attention")
    if lib.paged_decode.argtypes is None:
        lib.paged_decode.argtypes = [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                     _I, _I, _I, _I, _F, _F, _P]
        lib.paged_decode.restype = _I
        lib.paged_mq.argtypes = [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _I, _F, _F, _P]
        lib.paged_mq.restype = _I
    return lib


def _check_inputs(q, k_pages, v_pages, block_tables, lengths):
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged attention kernels take float32 or bfloat16, "
                        f"got {q.dtype}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("q, k_pages and v_pages must share one dtype")
    if k_pages.shape != v_pages.shape or k_pages.dim() != 4:
        raise ValueError(f"pages must both be (P, bs, Hkv, hd), got "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("k_pages and v_pages must be contiguous")
    H, hd = q.shape[-2], q.shape[-1]
    _, _, Hkv, hd_kv = k_pages.shape
    if hd_kv != hd or H % Hkv:
        raise ValueError(f"q heads/dim ({H}, {hd}) do not fit pages "
                         f"(Hkv={Hkv}, hd={hd_kv})")
    if hd % 8:
        raise ValueError(f"head_dim {hd} must be a multiple of 8 (16-byte "
                         "vector loads)")
    if block_tables.dim() != 2 or block_tables.shape[0] != q.shape[0] \
            or lengths.shape != (q.shape[0],):
        raise ValueError("block_tables must be (B, NB) and lengths (B,)")


def launch(q, k_pages, v_pages, block_tables, lengths, window=0,
           softcap=0.0):
    """Launch the kernel for q's rank on the card: (B, H, hd) ->
    ``paged_decode``; (B, K, H, hd) -> ``paged_mq`` for any K, K = 1
    included (unlike :func:`paged_attention`, which sends a K = 1 block to
    the decode kernel). Returns the output, same shape as q."""
    global decode_launches, mq_launches
    _check_inputs(q, k_pages, v_pages, block_tables, lengths)
    q = q.contiguous()
    tables = block_tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    _, bs, Hkv, hd = k_pages.shape
    NB = tables.shape[1]
    scale = 1.0 / math.sqrt(hd)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    dt = _DTYPES[q.dtype]
    lib = _lib()
    ptrs = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            tables.data_ptr(), lens.data_ptr(), out.data_ptr())
    with torch.cuda.device(q.device):
        if q.dim() == 3:
            B, H, _ = q.shape
            err = lib.paged_decode(dt, *ptrs, B, H, Hkv, hd, bs, NB,
                                   int(window), float(softcap), scale, stream)
            _build.check(lib, err, "paged_decode")
            decode_launches += 1
        else:
            B, K, H, _ = q.shape
            qt = max(1, min(K, _MQ_ROWS // (H // Hkv)))
            err = lib.paged_mq(dt, *ptrs, B, K, H, Hkv, hd, bs, NB, qt,
                               int(window), float(softcap), scale, stream)
            _build.check(lib, err, "paged_mq")
            mq_launches += 1
    return out


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                    window: int = 0, softcap: float = 0.0):
    """q: (B, H, hd), (B, 1, H, hd), or (B, K, H, hd) with K > 1;
    k_pages, v_pages: (P, bs, Hkv, hd); block_tables: (B, NB) int
    (-1 = absent); lengths: (B,) int -> same shape as q."""
    global ref_calls
    squeezed = q.dim() == 4 and q.shape[1] == 1
    if squeezed:
        q = q[:, 0]
    if q.device.type == "cpu":
        ref_calls += 1
        out = paged_attention_ref(q, k_pages, v_pages, block_tables, lengths,
                                  window=window, softcap=softcap)
    elif q.device.type == "cuda":
        out = launch(q, k_pages, v_pages, block_tables, lengths, window,
                     softcap)
    else:
        raise ValueError(f"paged attention runs on cuda or cpu, not "
                         f"{q.device}")
    return out[:, None] if squeezed else out
