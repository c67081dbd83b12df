"""Plain PyTorch flash attention: the twin of the reference oracle
``src/repro/kernels/flash_attention/ref.py``.

Dense softmax over the whole score matrix, in float32. The CPU tests run
it through ``ops.flash_attention``; ``chip_smoke.py`` holds the CUDA
kernel against it on the card. Nothing on the main path calls it when a
card is present.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0):
    """q: (B, H, Sq, hd); k, v: (B, Hkv, Sk, hd) with H % Hkv == 0. Query
    ``i`` sits at position ``q_offset + i``, key ``j`` at ``j``. Returns
    (B, H, Sq, hd) in q's dtype."""
    B, H, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if Hkv != H:
        k = torch.repeat_interleave(k, H // Hkv, dim=1)
        v = torch.repeat_interleave(v, H // Hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    dev = q.device
    q_pos = q_offset + torch.arange(Sq, device=dev)[:, None]
    k_pos = torch.arange(Sk, device=dev)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        ok = ok & (k_pos <= q_pos)
    if window > 0:
        ok = ok & (k_pos > q_pos - window)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
