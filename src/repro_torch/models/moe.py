"""Mixture-of-experts FFN of the port (``src/repro/models/moe.py``): the
serve-time dropless routing (``moe_apply_dropless``) and training's
grouped, capacity-bounded routing (``moe_apply``).

Serving.
Every token picks its top-k experts from a float32 router over float32
activations and combines their outputs under renormalised gates. No
grouping, no capacity, no drops: a token's output is a function of its
own hidden state alone, so a prompt split at any chunk boundary, or
batched with any neighbours, routes the same. Each token runs only its
top-k experts (``kernels/moe``: a top-k dispatch, then grouped products
over the stored ``(E, d, f)`` / ``(E, f, d)`` weights, read in place,
float32 accumulation, the gates applied in float32). The result equals
the reference's serve path, which runs every expert on every token and
gives the experts a token did not pick a zero gate: a zero-gated expert
adds exactly 0 to that sum.

Training (:func:`moe_apply`). Tokens are routed in groups of
``moe_group_size`` (a ragged tail zero-row padded; padded rows route and
take capacity, their outputs are dropped). Within a group every expert
takes at most ``expert_capacity`` (token, slot) entries, queued by the k
slot first (every first choice before any second choice), then token
order; an entry past capacity is dropped (the token falls through on the
residual). Dispatch and combine are the reference's one-hot (G, E, C)
tensors and einsums, so the kept entries, the products and the Switch
load-balance and router z losses are the reference's term for term;
``moe_dropped`` is the dropped share.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe import ops as moe_ops
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


def _router(p, flat, cfg):
    """(logits (..., E) float32, probs, expert ids (..., K), renormalised
    gates (..., K) float32) of ``flat`` (..., d) tokens. Experts are
    ranked by a stable descending sort, so equal probabilities keep the
    lower expert first, as ``jax.lax.top_k`` does."""
    logits = flat.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)                        # (..., E)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :cfg.top_k], idx[..., :cfg.top_k]
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    return logits, probs, idx, gates


def route(p, flat, cfg):
    """Router of ``flat`` (T, d) tokens: (expert ids (T, K), renormalised
    gates (T, K) float32)."""
    _, _, idx, gates = _router(p, flat, cfg)
    return idx, gates


def expert_capacity(cfg, group: int) -> int:
    cap = int(group * cfg.top_k / cfg.num_experts * cfg.capacity_factor)
    return max(cap, cfg.top_k)


def _route_groups(p, xg, cfg):
    """Token groups, each routed on its own: xg (N, G, d) -> (out (N, G,
    d), (lb_loss, z_loss, dropped), each (N,)) — the reference's ``vmap``
    of one group's routing, with the group as a leading dim."""
    N, G, d = xg.shape
    E, K = cfg.num_experts, cfg.top_k
    C = expert_capacity(cfg, G)
    logits, probs, idx, gate_vals = _router(p, xg, cfg)
    onehot = F.one_hot(idx, E).float()                           # (N,G,K,E)
    # position of each (token, k) entry in its expert's queue: the k slot
    # first (all first choices before second choices), then token order
    flat = onehot.transpose(1, 2).reshape(N, K * G, E)
    pos = torch.cumsum(flat, dim=1) - flat
    pos = pos.reshape(N, K, G, E).transpose(1, 2)                # (N,G,K,E)
    pos_in_expert = (pos * onehot).sum(dim=-1)                   # (N, G, K)
    fits = pos_in_expert < C
    kept = onehot * fits[..., None]
    # an entry past capacity one-hots to nothing (jax.nn.one_hot of an
    # out-of-range index), and is not kept anyway
    pos_onehot = F.one_hot(pos_in_expert.long().clamp(max=C), C + 1)[
        ..., :C].float()                                         # (N,G,K,C)
    dispatch = torch.einsum("ngke,ngkc->ngec", kept, pos_onehot)
    combine = torch.einsum("ngke,ngkc,ngk->ngec", kept, pos_onehot,
                           gate_vals)
    cd = xg.dtype
    expert_in = torch.einsum("ngec,ngd->encd", dispatch.to(cd), xg)
    expert_in = expert_in.reshape(E, N * C, d)                   # (E,N*C,d)
    g = torch.bmm(expert_in, p["w_gate"].to(cd))                 # (E,N*C,f)
    u = torch.bmm(expert_in, p["w_up"].to(cd))
    out_e = torch.bmm(F.silu(g) * u, p["w_down"].to(cd))         # (E,N*C,d)
    out = torch.einsum("ngec,encd->ngd", combine.to(cd),
                       out_e.reshape(E, N, C, d))
    # Switch aux losses: load balance + router z-loss
    density = onehot[:, :, 0, :].mean(dim=1)                     # top-1
    density_proxy = probs.mean(dim=1)
    lb_loss = (density * density_proxy).sum(dim=-1) * (E ** 2) / E
    z_loss = torch.logsumexp(logits, dim=-1).square().mean(dim=-1)
    dropped = 1.0 - kept.sum(dim=(1, 2, 3)) / (G * K)
    return out, (lb_loss, z_loss, dropped)


def moe_apply(p, x, cfg):
    """Training's routing: x (B, S, d) -> (out (B, S, d), aux dict with
    ``moe_lb_loss``, ``moe_z_loss``, ``moe_dropped``, each the mean over
    the groups)."""
    B, S, d = x.shape
    n_tokens = B * S
    G = min(cfg.moe_group_size, n_tokens)
    flat = x.reshape(n_tokens, d)
    pad = (-n_tokens) % G
    if pad:
        flat = F.pad(flat, (0, 0, 0, pad))
    out, (lb, zl, dr) = _route_groups(p, flat.reshape(-1, G, d), cfg)
    out = out.reshape(-1, d)[:n_tokens]
    aux = {"moe_lb_loss": lb.mean(), "moe_z_loss": zl.mean(),
           "moe_dropped": dr.mean()}
    return out.reshape(B, S, d), aux


def moe_apply_dropless(p, x, cfg):
    """x (B, S, d) -> (B, S, d): per-token top-k routing, each token
    through its top-k experts only, combined under its gates (the
    reference's zero-gated dense sum)."""
    B, S, d = x.shape
    flat = x.reshape(B * S, d)
    idx, gates = route(p, flat, cfg)
    cd = x.dtype
    out = moe_ops.moe_experts(flat, idx, gates, p["w_gate"].to(cd),
                              p["w_up"].to(cd), p["w_down"].to(cd))
    return out.reshape(B, S, d)
