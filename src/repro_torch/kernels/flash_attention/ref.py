"""Plain PyTorch flash attention.

* :func:`flash_attention_ref` — the twin of the reference oracle
  ``src/repro/kernels/flash_attention/ref.py``: dense softmax over the
  whole score matrix, in float32. The CPU tests run it through
  ``ops.flash_attention``; ``chip_smoke.py`` holds the CUDA kernel
  against it on the card. Nothing on the main path calls it when a card
  is present.
* :func:`flash_attention_tiled_ref` — the CUDA kernel's arithmetic step
  by step (its CTAs' rows, the key stages each walks, the online softmax
  with p rounded before p.v), so the CPU tests can hold the kernel's
  design against the reference.
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


def visible_keys(Sq: int, Sk: int, R: int, f0: int, f1: int, *,
                 causal: bool = True, window: int = 0, q_offset: int = 0):
    """Keys ``[k_begin, k_end)`` that (query, head) rows ``f0 .. f1 - 1``
    of a kv group (row ``f`` is query ``f // R``) can see: up to the last
    row's position, from the first row's window start. Mirrors the CUDA
    kernel's per-CTA range."""
    qlo = q_offset + f0 // R
    qhi = q_offset + (min(f1, Sq * R) - 1) // R
    k_end = min(Sk, qhi + 1) if causal else Sk
    k_begin = max(0, qlo - window + 1) if window > 0 else 0
    return k_begin, k_end


def flash_attention_tiled_ref(q, k, v, *, causal: bool = True,
                              window: int = 0, q_offset: int = 0,
                              rows_per_cta: int = 64, tile_keys: int = 32,
                              splits: int = 1):
    """The CUDA kernel's arithmetic in float32: one CTA per (row tile,
    kv group g, batch row b), its rows the (query, head) pairs ``rr = (j -
    j0) * R + h_local`` of group g (``R = H / Hkv``); each CTA walks the
    stages of ``tile_keys`` keys that hold its :func:`visible_keys`, with
    keys past Sk zero and every row masked by its own query position; the
    online softmax rounds p to q's dtype before p.v and sums l over the
    unrounded p. With ``splits`` > 1 a CTA's stages are cut into that many
    runs of ``ceil(n / splits)`` stages, each run's unnormalised partial
    kept, and the partials merged in split order (a run that saw no key
    adds nothing). Rows that see no key come out as zeros (where
    :func:`flash_attention_ref` gives the mean of the values). Same
    arguments and result as :func:`flash_attention_ref`."""
    B, H, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    R, M = H // Hkv, rows_per_cta
    rows = Sq * R
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    out = torch.zeros((B, H, Sq, hd), device=dev)
    for b in range(B):
        for g in range(Hkv):
            for f0 in range(0, rows, M):
                f = torch.arange(f0, min(f0 + M, rows))
                j, h = f // R, g * R + f % R
                qpos = (q_offset + j)[:, None].to(dev)
                qr = q[b, h, j].float()
                k_begin, k_end = visible_keys(Sq, Sk, R, f0, f0 + M,
                                              causal=causal, window=window,
                                              q_offset=q_offset)
                stages = (list(range(k_begin // tile_keys * tile_keys,
                                     k_end, tile_keys))
                          if k_end > k_begin else [])
                per = -(-len(stages) // splits)
                parts = []
                for s in range(splits):
                    mm = torch.full((len(f),), NEG_INF, device=dev)
                    ll = torch.zeros(len(f), device=dev)
                    oo = torch.zeros((len(f), hd), device=dev)
                    for k0 in stages[s * per:(s + 1) * per]:
                        pos = torch.arange(k0, k0 + tile_keys, device=dev)
                        kt = torch.zeros((tile_keys, hd), device=dev)
                        vt = torch.zeros((tile_keys, hd), device=dev)
                        n = min(tile_keys, Sk - k0)
                        kt[:n] = k[b, g, k0:k0 + n].float()
                        vt[:n] = v[b, g, k0:k0 + n].float()
                        x = qr @ kt.T * scale
                        see = (pos < Sk)[None].expand_as(x)
                        if causal:
                            see = see & (pos[None] <= qpos)
                        if window > 0:
                            see = see & (pos[None] > qpos - window)
                        x = torch.where(see, x, torch.full_like(x, NEG_INF))
                        m_new = torch.maximum(mm, x.amax(-1))
                        corr = torch.exp(mm - m_new)
                        p = torch.where(see, torch.exp(x - m_new[:, None]),
                                        torch.zeros_like(x))
                        ll = ll * corr + p.sum(-1)
                        oo = oo * corr[:, None] + p.to(q.dtype).float() @ vt
                        mm = m_new
                    parts.append((mm, ll, oo))
                if splits == 1:
                    mm, ll, oo = parts[0]
                    out[b, h, j] = oo / ll.clamp(min=1e-30)[:, None]
                    continue
                mx = torch.full((len(f),), NEG_INF, device=dev)
                for mm, ll, _ in parts:
                    mx = torch.where(ll > 0, torch.maximum(mx, mm), mx)
                den = torch.zeros(len(f), device=dev)
                acc = torch.zeros((len(f), hd), device=dev)
                for mm, ll, oo in parts:
                    wgt = torch.where(ll > 0, torch.exp(mm - mx),
                                      torch.zeros_like(mm))
                    den = den + wgt * ll
                    acc = acc + wgt[:, None] * oo
                inv = torch.where(den > 0, 1.0 / den.clamp(min=1e-30),
                                  torch.zeros_like(den))
                out[b, h, j] = acc * inv[:, None]
    return out.to(q.dtype)
