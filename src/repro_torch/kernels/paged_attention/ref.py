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


def visible_entries(length: int, K: int, R: int, f0: int, f1: int, bs: int,
                    NB: int, window: int = 0):
    """Table entries ``[i_begin, i_end)`` that (query, head) rows
    ``f0 .. f1 - 1`` of a kv group (row ``f`` is query ``f // R``) can
    see: up to the last row's position, from the first row's window
    start. Mirrors the CUDA kernels' per-CTA range; a parked length (far
    negative) gives ``i_end = 0``."""
    qlo = length - K + f0 // R
    qhi = length - K + (f1 - 1) // R
    i_end = min(NB, qhi // bs + 1) if qhi >= 0 else 0
    i_begin = 0
    if window > 0 and qlo - window + 1 > 0:
        i_begin = (qlo - window + 1) // bs
    return i_begin, i_end


def paged_attention_split_ref(q, k_pages, v_pages, block_tables, lengths, *,
                              plan, tile_tokens: int, window: int = 0,
                              softcap: float = 0.0):
    """The CUDA kernels' arithmetic, step by step, in float32: for each
    CTA of ``plan`` (an ``ops.Plan``: row tile, split, kv group, request)
    the online softmax over ring stages of ``tile_tokens`` tokens, absent
    and out-of-range entries masked, p rounded to q's dtype before p.v;
    then the partials merged in split order, with partials of l = 0
    adding nothing. Rows that see no token come out as zeros (where
    :func:`paged_attention_ref` gives the mean of the table's values).
    Same arguments and result as :func:`paged_attention_ref`."""
    multi = q.dim() == 4
    if not multi:
        q = q[:, None]
    B, K, H, hd = q.shape
    _, bs, Hkv, _ = k_pages.shape
    NB = block_tables.shape[1]
    R, M = H // Hkv, 16 * plan.warps
    rows, per_stage = K * R, tile_tokens // bs
    scale = 1.0 / math.sqrt(hd)
    kf, vf = k_pages.float(), v_pages.float()
    tables = block_tables.long().cpu()
    lens = lengths.long().cpu()
    acc = torch.zeros((plan.splits, B, K, H, hd), device=q.device)
    m = torch.full((plan.splits, B, K, H), NEG_INF, device=q.device)
    l = torch.zeros((plan.splits, B, K, H), device=q.device)
    for b in range(B):
        length = int(lens[b])
        for g in range(Hkv):
            for rt in range(plan.row_tiles):
                f = torch.arange(rt * M, min(rt * M + M, rows))
                j, h = f // R, g * R + f % R
                qpos = (length - K + j)[:, None].to(q.device)
                qr = q[b, j, h].float()
                i_begin, i_end = visible_entries(length, K, R, int(f[0]),
                                                 int(f[-1]) + 1, bs, NB,
                                                 window)
                for s in range(plan.splits):
                    lo, hi = plan.split_range(s, NB)
                    e_lo, e_hi = max(i_begin, lo), min(i_end, hi)
                    mm = torch.full((len(f),), NEG_INF, device=q.device)
                    ll = torch.zeros(len(f), device=q.device)
                    oo = torch.zeros((len(f), hd), device=q.device)
                    for e0 in range(e_lo, e_hi, per_stage):
                        ent = e0 + torch.arange(tile_tokens) // bs
                        blk = torch.where(
                            ent < e_hi, tables[b][ent.clamp(max=NB - 1)], -1)
                        t = torch.arange(tile_tokens) % bs
                        present = (blk >= 0).to(q.device)
                        blk, t = blk.clamp(min=0).to(q.device), t.to(q.device)
                        zero = torch.zeros((), device=q.device)
                        kt = torch.where(present[:, None], kf[blk, t, g], zero)
                        vt = torch.where(present[:, None], vf[blk, t, g], zero)
                        x = qr @ kt.T * scale
                        if softcap > 0:
                            x = softcap * torch.tanh(x / softcap)
                        pos = (e0 * bs
                               + torch.arange(tile_tokens))[None].to(q.device)
                        see = present[None] & (pos <= qpos)
                        if window > 0:
                            see = see & (pos > qpos - window)
                        x = torch.where(see, x, torch.full_like(x, NEG_INF))
                        m_new = torch.maximum(mm, x.amax(-1))
                        corr = torch.exp(mm - m_new)
                        p = torch.where(see, torch.exp(x - m_new[:, None]),
                                        torch.zeros_like(x))
                        ll = ll * corr + p.sum(-1)
                        oo = oo * corr[:, None] + p.to(q.dtype).float() @ vt
                        mm = m_new
                    acc[s, b, j, h] = oo
                    m[s, b, j, h] = torch.where(ll > 0, mm,
                                                torch.full_like(mm, NEG_INF))
                    l[s, b, j, h] = ll
    top = torch.where(l > 0, m, torch.full_like(m, NEG_INF)).amax(0)
    den = torch.zeros_like(top)
    out = torch.zeros((B, K, H, hd), device=q.device)
    for s in range(plan.splits):
        w = torch.where(l[s] > 0, torch.exp(m[s] - top), torch.zeros_like(top))
        den = den + w * l[s]
        out = out + w[..., None] * acc[s]
    out = torch.where(den[..., None] > 0, out / den.clamp(min=1e-30)[..., None],
                      torch.zeros_like(out)).to(q.dtype)
    return out if multi else out[:, 0]
