"""Mixture-of-experts FFN of the port: the reference's serve-time dropless
routing (``src/repro/models/moe.py``: ``init_moe``,
``moe_apply_dropless``).

Every token picks its top-k experts from a float32 router over float32
activations and combines their outputs under renormalised gates. No
grouping, no capacity, no drops: a token's output is a function of its
own hidden state alone, so a prompt split at any chunk boundary, or
batched with any neighbours, routes the same. As in the reference's
serve path, every expert runs on every token and the combine gives the
experts a token did not pick zero weight. The expert products are
batched matrix products over the stored ``(E, d, f)`` / ``(E, f, d)``
weights, read in place (no per-call permute or copy of a weight).

The reference's grouped, capacity-bounded ``moe_apply`` (with its
load-balance and z losses) is the training path and is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


def init_moe(cfg, generator, device, dtype):
    """``router (d, E)`` float32, ``w_gate``/``w_up (E, d, f)``, ``w_down
    (E, f, d)``; each expert drawn on its own, so the float32 draw of a
    stacked leaf never sits in memory whole."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts

    def stacked(shape, fan_in):
        out = torch.empty((e,) + shape, dtype=dtype, device=device)
        for i in range(e):
            out[i] = dense_init(shape, fan_in, generator, device, dtype)
        return out

    return {"router": dense_init((d, e), d, generator, device,
                                 torch.float32),
            "w_gate": stacked((d, f), d),
            "w_up": stacked((d, f), d),
            "w_down": stacked((f, d), f)}


def route(p, flat, cfg):
    """Router of ``flat`` (T, d) tokens: (expert ids (T, K), renormalised
    gates (T, K) float32). Experts are ranked by a stable descending sort,
    so equal probabilities keep the lower expert first, as
    ``jax.lax.top_k`` does."""
    logits = flat.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)                        # (T, E)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :cfg.top_k], idx[:, :cfg.top_k]
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    return idx, gates


def moe_apply_dropless(p, x, cfg):
    """x (B, S, d) -> (B, S, d): per-token top-k routing, every expert on
    every token, outputs combined under the gates (zero for experts a
    token did not pick)."""
    B, S, d = x.shape
    flat = x.reshape(B * S, d)
    idx, gates = route(p, flat, cfg)
    weights = torch.zeros((flat.shape[0], cfg.num_experts),
                          dtype=torch.float32, device=x.device)
    weights.scatter_(1, idx, gates)                              # (T, E)
    cd = x.dtype
    xe = flat.unsqueeze(0).expand(cfg.num_experts, -1, -1)       # (E, T, d)
    g = torch.bmm(xe, p["w_gate"].to(cd))                        # (E, T, f)
    u = torch.bmm(xe, p["w_up"].to(cd))
    out_e = torch.bmm(F.silu(g) * u, p["w_down"].to(cd))         # (E, T, d)
    out = torch.einsum("te,etd->td", weights.to(cd), out_e)
    return out.reshape(B, S, d)
