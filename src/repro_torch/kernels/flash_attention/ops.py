"""Public wrapper for flash attention: layout adapter, dispatch, and
launch counters.

Follows the reference wrapper's contract
(``src/repro/kernels/flash_attention/ops.py``): models hand in q
``(B, Sq, H, hd)`` and k, v ``(B, Sk, Hkv, hd)``; the kernel works on
``(B, H, S, hd)``. Here the layout change is a strided view, not a copy:
the kernel takes (batch, head, position) strides. Tensors on the CPU take
the plain version (``ref.py``); tensors on the card launch the
hand-written CUDA kernel, or raise. There is no fallback from one to the
other. On the card a call is one launch over (row tiles, Hkv, B): a
CTA's ``ROWS_PER_CTA`` rows are (query, head) pairs of one kv group, so
one staged K/V tile serves every query head of the group
(``ref.flash_attention_tiled_ref`` follows the same arithmetic on the
CPU). When those work items cannot fill the card, each item's key
stages are split across CTAs (:func:`splits_for`, from the shapes and
the SM count alone) and a second small launch merges the splits in
fixed order.

The module counts what it ran, in plain integers: ``flash_launches`` (one
per kernel launch) and ``ref_calls`` (one per plain-version call).
:func:`reset_counters` zeroes them.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

flash_launches = 0
ref_calls = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is instantiated for (its accumulator is ``hd /
#: 8`` mma tiles a warp)
HEAD_DIMS = (64, 128, 256)
#: (query, head) rows of a CTA and keys of a K/V ring stage (``kRows``
#: and ``kTile`` in the CUDA source)
ROWS_PER_CTA = 64
TILE_KEYS = 32
#: a split takes at least this many key stages, and a launch is split
#: until it has about ``SPLIT_CTAS_PER_SM`` CTAs an SM
MIN_SPLIT_STAGES = 2
SPLIT_CTAS_PER_SM = 4

_I, _P, _F = ctypes.c_int, ctypes.c_void_p, ctypes.c_float


def reset_counters() -> None:
    global flash_launches, ref_calls
    with _build.count_lock:
        flash_launches = ref_calls = 0


def count(name: str) -> None:
    """Add one to the counter ``name`` (``flash_launches`` or
    ``ref_calls``) under the port's count lock."""
    _build.count(globals(), name)


def counters() -> dict:
    return {"flash_launches": flash_launches, "ref_calls": ref_calls}


def _lib():
    lib = _build.library("flash_attention")
    if lib.flash_attention.argtypes is None:
        lib.flash_attention.argtypes = [_I, _P, _P, _P, _P, _P, _I, _I, _I,
                                        _I, _I, _I, _I, _I, _I, _F, _I, _P,
                                        _P, _P]
        lib.flash_attention.restype = _I
    return lib


def _check_inputs(q, k, v):
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"the flash kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, H, Sq, hd) and k, v (B, Hkv, Sk, "
                         f"hd), got {tuple(q.shape)} / {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[1]:
        raise ValueError(f"q (B={B}, H={H}, hd={hd}) does not fit k/v "
                         f"{tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not one of {HEAD_DIMS}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} needs a contiguous head dimension, "
                             "16-byte aligned rows and strides")


def splits_for(B: int, H: int, Hkv: int, Sq: int, Sk: int, *, causal: bool,
               q_offset: int, sms: int) -> int:
    """CTAs each work item's key stages are split across: 1 when the
    items (row tiles x Hkv x B) fill the ``sms`` SMs; else enough for
    about ``SPLIT_CTAS_PER_SM`` CTAs an SM, with ``MIN_SPLIT_STAGES``
    stages a split or more (of the longest item: ``Sk`` keys, or up to
    the last query's position when causal)."""
    items = -(-Sq * (H // Hkv) // ROWS_PER_CTA) * Hkv * B
    if items >= sms:
        return 1
    keys = max(0, min(Sk, q_offset + Sq)) if causal else Sk
    stages = -(-keys // TILE_KEYS)
    return max(1, min(-(-SPLIT_CTAS_PER_SM * sms // items),
                      stages // MIN_SPLIT_STAGES))


_sms = {}


def sm_count(device) -> int:
    """The card's SM count (read once a device)."""
    idx = torch.device(device).index or 0
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sms[idx]


def launch(q, k, v, *, causal: bool = True, window: int = 0,
           q_offset: int = 0, splits=None):
    """Launch the kernel on the card: q (B, H, Sq, hd), k, v (B, Hkv, Sk,
    hd), each with any (batch, head, position) strides. Returns (B, H, Sq,
    hd): a view of an output stored as (B, Sq, H, hd), the model's
    layout. ``splits`` overrides :func:`splits_for`."""
    _check_inputs(q, k, v)
    B, H, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if splits is None:
        splits = splits_for(B, H, Hkv, Sq, Sk, causal=causal,
                            q_offset=q_offset, sms=sm_count(q.device))
    acc = ml = None
    if splits > 1:
        acc = torch.empty((splits, B, H, Sq, hd), dtype=torch.float32,
                          device=q.device)
        ml = torch.empty((splits, B, H, Sq, 2), dtype=torch.float32,
                         device=q.device)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out)
                                         for s in t.stride()[:3]))
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), strides, B, H, Hkv, Sq, Sk, hd, int(causal),
            int(window), int(q_offset), 1.0 / math.sqrt(hd), int(splits),
            0 if acc is None else acc.data_ptr(),
            0 if ml is None else ml.data_ptr(), stream)
    _build.check(lib, err, "flash_attention")
    count("flash_launches")
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0):
    """q: (B, Sq, H, hd); k, v: (B, Sk, Hkv, hd) -> (B, Sq, H, hd). Query
    ``i`` sits at position ``q_offset + i``; ``window`` > 0 adds the
    sliding-window mask."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if q.device.type == "cpu":
        count("ref_calls")
        out = flash_attention_ref(qt, kt, vt, causal=causal, window=window,
                                  q_offset=q_offset)
    elif q.device.type == "cuda":
        out = launch(qt, kt, vt, causal=causal, window=window,
                     q_offset=q_offset)
    else:
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    return out.transpose(1, 2)
