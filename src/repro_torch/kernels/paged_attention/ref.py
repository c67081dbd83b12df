"""Plain PyTorch paged attention: the twin of the reference oracle
``src/repro/kernels/paged_attention/ref.py``.

Dense gather-then-softmax over the block table, in float32. The CPU
tests run it through ``ops.paged_attention``; ``chip_smoke.py`` holds
the CUDA kernels against it on the card. Nothing on the main path calls
it when a card is present.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def paged_attention_ref(q, k_pages, v_pages, block_tables, lengths, *,
                        window: int = 0, softcap: float = 0.0):
    """Attention through per-request block tables.

    q: (B, H, hd) — one query per request, the token at absolute position
    ``lengths[b] - 1`` (its own k/v already resident in the pages) — or
    (B, K, H, hd) — a q-block of K queries, query ``j`` at absolute
    position ``lengths[b] - K + j`` with causality inside the block.
    k_pages, v_pages: (P, bs, Hkv, hd), the global KV block pool; table
    entry ``i`` of a request holds its tokens ``[i*bs, (i+1)*bs)``.
    block_tables: (B, NB) int, ``-1`` marks absent entries.
    lengths: (B,) int. Returns the same rank and dtype as q.
    """
    multi = q.dim() == 4
    if not multi:
        q = q[:, None]
    B, K, H, hd = q.shape
    P, bs, Hkv, _ = k_pages.shape
    NB = block_tables.shape[1]
    tables = block_tables.long()
    flat = tables.clamp(min=0).reshape(-1)
    kg = k_pages[flat].reshape(B, NB * bs, Hkv, hd).float()
    vg = v_pages[flat].reshape(B, NB * bs, Hkv, hd).float()
    if Hkv != H:
        kg = torch.repeat_interleave(kg, H // Hkv, dim=2)
        vg = torch.repeat_interleave(vg, H // Hkv, dim=2)

    s = torch.einsum("bqhd,bthd->bqht", q.float(), kg) / math.sqrt(hd)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    dev = q.device
    tok = torch.arange(NB * bs, device=dev)[None, None, :]     # abs position
    qpos = (lengths.long()[:, None] - K
            + torch.arange(K, device=dev)[None, :])[:, :, None]
    ok = tok <= qpos                                            # causal
    ok = ok & torch.repeat_interleave(tables >= 0, bs, dim=1)[:, None, :]
    if window > 0:
        ok = ok & (tok > qpos - window)
    s = torch.where(ok[:, :, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("bqht,bthd->bqhd", p, vg).to(q.dtype)
    return out if multi else out[:, 0]
