"""Public wrapper for paged attention: layout adapter, launch plan,
dispatch, and launch counters.

Follows the reference wrapper's contract
(``src/repro/kernels/paged_attention/ops.py``): q ``(B, H, hd)`` or
``(B, 1, H, hd)`` goes to the decode kernel (``paged_decode``); q
``(B, K, H, hd)`` with ``K > 1`` goes to the multi-query kernel
(``paged_mq``), query ``j`` of row ``b`` at position
``lengths[b] - K + j``. Tensors on the CPU take the plain version
(``ref.py``); tensors on the card launch the hand-written CUDA kernel,
or raise. There is no fallback from one to the other.

On the card a call is one launch of the attention kernel, over a grid
that :func:`plan` picks from shapes alone (the table is split so that
about four CTAs run on each SM), and, when the table is split, one launch
of the combine kernel that merges the splits' float32 partials.

The module counts what it ran, in plain integers: ``decode_launches``
and ``mq_launches`` (one per wrapper call that launched on the card),
``mq_launches_by_k`` (the same ``paged_mq`` launches by their query
width K) and ``ref_calls`` (one per plain-version call).
:func:`reset_counters` zeroes them. Each count is bumped under the
port's count lock (``_build.count_lock``): the serving fabric's rank
threads launch at once.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

decode_launches = 0
mq_launches = 0
mq_launches_by_k: dict = {}
ref_calls = 0

#: tokens of K (and of V) one shared-memory ring stage holds (``kTile``
#: in the CUDA source); a page size must divide it
TILE_TOKENS = 32
#: head dims the kernels are instantiated for: 64 (hymba, whisper), 128
#: (yi, qwen, internvl, olmoe, dbrx) and 256 (gemma)
HEAD_DIMS = (64, 128, 256)
#: CTAs the split aims at: four per SM of the H100's 132 (chip_smoke.py
#: phase 3 times the path shapes at two, four and eight per SM; PERF.md)
TARGET_CTAS = 4 * 132
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_I, _P, _F = ctypes.c_int, ctypes.c_void_p, ctypes.c_float


class Plan(NamedTuple):
    """One launch's grid: ``warps`` warps of 16 (query, head) rows a CTA,
    ``row_tiles`` CTAs over a kv group's ``K * H / Hkv`` rows, and the
    table cut into ``splits`` ranges of ``eps`` entries; the grid is
    ``(row_tiles * splits, Hkv, B)``."""
    warps: int
    row_tiles: int
    splits: int
    eps: int

    @property
    def grid(self):
        return self.row_tiles * self.splits

    def split_range(self, s: int, nb: int):
        """Table entries ``[lo, hi)`` of split ``s`` (before the device
        intersects them with what the tile's queries can see)."""
        return s * self.eps, min(nb, (s + 1) * self.eps)


def plan(B: int, K: int, H: int, Hkv: int, bs: int, NB: int, *,
         target_ctas: int = TARGET_CTAS) -> Plan:
    """The launch plan, from shapes only: it never reads ``lengths`` or
    the tables, so choosing it needs no device-to-host copy. A kv group
    with at most 16 rows (decode, and a K = 1 block, which therefore run
    the same code) takes one warp, otherwise four. The table splits into
    whole ring stages, as many as bring the grid to about
    ``target_ctas``, and never more than there are stages."""
    rows = K * (H // Hkv)
    warps = 1 if rows <= 16 else 4
    row_tiles = -(-rows // (16 * warps))
    per_stage = TILE_TOKENS // bs
    stages = -(-NB // per_stage)
    splits = max(1, min(stages, -(-target_ctas // (B * Hkv * row_tiles))))
    per_split = -(-stages // splits)
    splits = -(-stages // per_split)
    return Plan(warps, row_tiles, splits, per_split * per_stage)


def reset_counters() -> None:
    global decode_launches, mq_launches, ref_calls
    with _build.count_lock:
        decode_launches = mq_launches = ref_calls = 0
        mq_launches_by_k.clear()


def count(name: str, K: Optional[int] = None) -> None:
    """Add one to the counter ``name`` (``decode_launches``,
    ``mq_launches`` or ``ref_calls``) under the port's count lock; a
    ``paged_mq`` launch also counts under its query width ``K``."""
    with _build.count_lock:
        globals()[name] += 1
        if K is not None:
            mq_launches_by_k[K] = mq_launches_by_k.get(K, 0) + 1


def counters() -> dict:
    return {"decode_launches": decode_launches, "mq_launches": mq_launches,
            "ref_calls": ref_calls}


def _lib():
    lib = _build.library("paged_attention")
    if lib.paged_decode.argtypes is None:
        lib.paged_decode.argtypes = [_I] + [_P] * 8 + [_I] * 11 + [_F, _F,
                                                                   _P]
        lib.paged_decode.restype = _I
        lib.paged_mq.argtypes = [_I] + [_P] * 8 + [_I] * 12 + [_F, _F, _P]
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
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd}: the paged kernels are built for "
                         f"head dims {HEAD_DIMS}")
    bs = k_pages.shape[1]
    if TILE_TOKENS % bs:
        raise ValueError(f"page size {bs}: the paged kernels take page sizes "
                         f"that divide their {TILE_TOKENS}-token stage")
    if block_tables.dim() != 2 or block_tables.shape[0] != q.shape[0] \
            or lengths.shape != (q.shape[0],):
        raise ValueError("block_tables must be (B, NB) and lengths (B,)")


def launch(q, k_pages, v_pages, block_tables, lengths, window=0,
           softcap=0.0, *, target_ctas: int = TARGET_CTAS):
    """Launch the kernel for q's rank on the card: (B, H, hd) ->
    ``paged_decode``; (B, K, H, hd) -> ``paged_mq`` for any K, K = 1
    included (unlike :func:`paged_attention`, which sends a K = 1 block to
    the decode kernel). ``target_ctas`` goes to :func:`plan`. Returns the
    output, same shape as q."""
    _check_inputs(q, k_pages, v_pages, block_tables, lengths)
    q = q.contiguous()
    tables = block_tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    _, bs, Hkv, hd = k_pages.shape
    NB = tables.shape[1]
    mq = q.dim() == 4
    B, K, H = (q.shape[0], q.shape[1], q.shape[2]) if mq else \
        (q.shape[0], 1, q.shape[1])
    pl = plan(B, K, H, Hkv, bs, NB, target_ctas=target_ctas)
    acc = ml = None
    if pl.splits > 1:
        acc = torch.empty((pl.splits, B, K, H, hd), dtype=torch.float32,
                          device=q.device)
        ml = torch.empty((pl.splits, B, K, H, 2), dtype=torch.float32,
                         device=q.device)
    ptrs = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
            0 if acc is None else acc.data_ptr(),
            0 if ml is None else ml.data_ptr())
    shape = (Hkv, hd, bs, NB, pl.warps, pl.row_tiles, pl.splits, pl.eps,
             int(window), float(softcap), 1.0 / math.sqrt(hd))
    dt = _DTYPES[q.dtype]
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if mq:
            err = lib.paged_mq(dt, *ptrs, B, K, H, *shape, stream)
            _build.check(lib, err, "paged_mq")
            count("mq_launches", K)
        else:
            err = lib.paged_decode(dt, *ptrs, B, H, *shape, stream)
            _build.check(lib, err, "paged_decode")
            count("decode_launches")
    return out


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                    window: int = 0, softcap: float = 0.0):
    """q: (B, H, hd), (B, 1, H, hd), or (B, K, H, hd) with K > 1;
    k_pages, v_pages: (P, bs, Hkv, hd); block_tables: (B, NB) int
    (-1 = absent); lengths: (B,) int -> same shape as q."""
    squeezed = q.dim() == 4 and q.shape[1] == 1
    if squeezed:
        q = q[:, 0]
    if q.device.type == "cpu":
        count("ref_calls")
        out = paged_attention_ref(q, k_pages, v_pages, block_tables, lengths,
                                  window=window, softcap=softcap)
    elif q.device.type == "cuda":
        out = launch(q, k_pages, v_pages, block_tables, lengths, window,
                     softcap)
    else:
        raise ValueError(f"paged attention runs on cuda or cpu, not "
                         f"{q.device}")
    return out[:, None] if squeezed else out
