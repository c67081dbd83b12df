"""Plain reference of the OLMoE family (arXiv:2409.02060), and the
parameters the benchmark draws for it.

A decoder of ``num_layers`` pre-norm blocks: RMSNorm, attention with
RoPE and q/k RMS norms, a residual add, RMSNorm, a mixture of experts
(a float32 softmax router over ``num_experts``, the ``top_k`` picked,
SwiGLU experts combined under the picked probabilities), a residual
add; a final RMSNorm and an untied LM head. Plain float32 ``torch``,
one layer at a time, no cache and no kernel: every position attends
over the whole prefix it has.

Two departures from the published model, both the served program's and
stated in the configuration file (``departures``): the q/k norms are
per head over ``head_dim`` (OLMoE normalises the whole projection), and
the picked probabilities are renormalised to sum to 1 (OLMoE's
``norm_topk_prob`` is false).

``precision="fp8"`` is the control: every matrix product takes its
weight and its input rounded to float8 e4m3, each under one scale (its
absolute maximum), the rest as above.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.common import Mat, around_one, generator, normal, rms


def make_params(c: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The parameters in the layout the served program takes, drawn on
    ``device`` from ``seed`` in one call a kind of leaf (all layers'
    stacked). Scales: fan-in for every projection, unit-ish norms, the
    LM head at 3/sqrt(d) so logits spread over a few units."""
    L, d, h, hkv, hd = (c["num_layers"], c["d_model"], c["num_heads"],
                        c["num_kv_heads"], c["head_dim"])
    e, f = c["num_experts"], c["d_ff"]
    vp = -(-c["vocab_size"] // 128) * 128
    g = generator(seed, device)
    kw = dict(device=device, dtype=dtype)
    embed = normal(g, (vp, d), 1.0, **kw)
    lm_head = normal(g, (d, vp), 3.0 / math.sqrt(d), **kw)
    wq = normal(g, (L, d, h, hd), d ** -0.5, **kw)
    wk = normal(g, (L, d, hkv, hd), d ** -0.5, **kw)
    wv = normal(g, (L, d, hkv, hd), d ** -0.5, **kw)
    wo = normal(g, (L, h, hd, d), (h * hd) ** -0.5, **kw)
    qk = around_one(g, (L, 2, hd), **kw)
    norms = around_one(g, (2 * L + 1, d), **kw)
    router = normal(g, (L, d, e), d ** -0.5, device=device,
                     dtype=torch.float32)
    w_gate = normal(g, (L, e, d, f), d ** -0.5, **kw)
    w_up = normal(g, (L, e, d, f), d ** -0.5, **kw)
    w_down = normal(g, (L, e, f, d), f ** -0.5, **kw)
    blocks = []
    for i in range(L):
        blocks.append({
            "ln1": {"w": norms[2 * i]},
            "attn": {"wq": wq[i], "wk": wk[i], "wv": wv[i], "wo": wo[i],
                     "q_norm": qk[i, 0], "k_norm": qk[i, 1]},
            "ln2": {"w": norms[2 * i + 1]},
            "moe": {"router": router[i], "w_gate": w_gate[i],
                    "w_up": w_up[i], "w_down": w_down[i]},
        })
    return {"embed": embed, "final_norm": {"w": norms[2 * L]},
            "blocks": blocks, "lm_head": lm_head}


def _rope(x, pos, theta):
    """Half-split rotary embedding of x (S, H, hd) at positions pos (S,)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, device=x.device,
                                    dtype=torch.float64) / half)
    ang = (pos.double()[:, None] * freqs[None, :]).float()
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, block=1024):
    """Causal attention of q (S, H, hd) over k, v (S, Hkv, hd), query
    blocks at a time."""
    S, H, hd = q.shape
    rep = H // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).transpose(0, 1)      # (H, S, hd)
    v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(hd)
    for s0 in range(0, S, block):
        s1 = min(S, s0 + block)
        qb = q[s0:s1].transpose(0, 1)                          # (H, b, hd)
        sc = (qb @ k[:, :s1].transpose(1, 2)) * scale          # (H, b, s1)
        qi = torch.arange(s0, s1, device=q.device)[:, None]
        ki = torch.arange(s1, device=q.device)[None, :]
        sc = sc.masked_fill(ki > qi, float("-inf"))
        out[s0:s1] = (torch.softmax(sc, dim=-1) @ v[:, :s1]).transpose(0, 1)
    return out


def _experts(p, x, c, mm: Mat):
    """Top-k mixture of x (S, d) float32: the router in float32, the
    picked probabilities renormalised, each expert over its tokens."""
    probs = torch.softmax(x @ p["router"].float(), dim=-1)       # (S, E)
    top, idx = torch.topk(probs, c["top_k"], dim=-1)
    top = top / top.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in torch.unique(idx).tolist():
        tok, slot = (idx == e).nonzero(as_tuple=True)
        xe = x[tok]
        hdn = F.silu(mm(xe, mm.w(p["w_gate"][e]))) \
            * mm(xe, mm.w(p["w_up"][e]))
        out.index_add_(0, tok, mm(hdn, mm.w(p["w_down"][e]))
                       * top[tok, slot][:, None])
    return out


def logits(params: dict, c: dict, tokens: torch.Tensor, first: int, *,
           precision: str = "f32") -> torch.Tensor:
    """Next-token logits at positions ``first .. len(tokens) - 1`` of one
    sequence ``tokens`` (S,) int: (S - first, vocab) float32."""
    mm = Mat(precision)
    eps, theta = c.get("norm_eps", 1e-5), c.get("rope_theta", 10000.0)
    h, hkv, hd = c["num_heads"], c["num_kv_heads"], c["head_dim"]
    S = tokens.shape[0]
    pos = torch.arange(S, device=tokens.device)
    x = params["embed"][tokens.long()].float()
    for p in params["blocks"]:
        a = p["attn"]
        xn = rms(x, p["ln1"]["w"], eps)
        q = mm(xn, mm.w(a["wq"].reshape(a["wq"].shape[0], -1)))
        k = mm(xn, mm.w(a["wk"].reshape(a["wk"].shape[0], -1)))
        v = mm(xn, mm.w(a["wv"].reshape(a["wv"].shape[0], -1)))
        q = rms(q.view(S, h, hd), a["q_norm"], eps)
        k = rms(k.view(S, hkv, hd), a["k_norm"], eps)
        ctx = _attention(_rope(q, pos, theta), _rope(k, pos, theta),
                         v.view(S, hkv, hd))
        x = x + mm(ctx.reshape(S, h * hd), mm.w(a["wo"].reshape(h * hd, -1)))
        x = x + _experts(p["moe"], rms(x, p["ln2"]["w"], eps), c, mm)
    hid = rms(x[first:], params["final_norm"]["w"], eps)
    out = mm(hid, mm.w(params["lm_head"]))
    return out[:, :c["vocab_size"]]
