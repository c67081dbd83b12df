"""Plain reference of the Mamba-2 family (arXiv:2405.21060, the SSD
block), and the parameters the benchmark draws for it.

A stack of ``num_layers`` pre-norm residual blocks over a tied
embedding. A block: RMSNorm; one input projection into z (d_inner), the
x/B/C rows (d_inner + 2 state) and dt (one a head); a causal depthwise
convolution of width ``ssm_conv`` with bias over x/B/C, then SiLU; per
head ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``, and the
state-space recurrence, one group (B and C shared by all heads):

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t + D x_t

then ``y * silu(z)`` through an RMSNorm of width d_inner with its own
weight (eps 1e-5), and the output projection. A final RMSNorm and the
embedding's transpose give the logits.

Plain float32 ``torch``, one layer at a time. The recurrence is
evaluated exactly, block by block (256 positions): within a block as the
masked, decay-weighted sum it unrolls to, across blocks through the
state. ``precision="fp8"`` is the control: every matrix product takes
its weight and its input rounded to float8 e4m3, each under one scale
(its absolute maximum), the rest as above.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.common import Mat, around_one, generator, normal, rms


#: positions of one block of the exact blockwise recurrence
BLOCK = 256


def make_params(c: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The parameters in the layout the served program takes, drawn on
    ``device`` from ``seed``, one call a kind of leaf (all layers
    stacked). The embedding at 0.1 (tied: logits spread over a few
    units), fan-in projections, conv taps at 1/sqrt(width), decay rates
    ``A`` in [1, 16] and step sizes ``softplus(dt_bias)`` in [1e-3,
    1e-1], log-uniform."""
    L, d, di, n = (c["num_layers"], c["d_model"], c["ssm_d_inner"],
                   c["ssm_state"])
    h, k = di // c["ssm_head_dim"], c["ssm_conv"]
    conv_dim = di + 2 * n
    vp = -(-c["vocab_size"] // 128) * 128
    g = generator(seed, device)
    kw = dict(device=device, dtype=dtype)
    f32 = dict(device=device, dtype=torch.float32)
    embed = normal(g, (vp, d), 0.1, **kw)
    in_proj = normal(g, (L, d, 2 * di + 2 * n + h), d ** -0.5, **kw)
    conv_w = normal(g, (L, k, conv_dim), k ** -0.5, **kw)
    conv_b = normal(g, (L, conv_dim), 0.1, **kw)
    out_proj = normal(g, (L, di, d), di ** -0.5, **kw)
    norms = around_one(g, (L + 1, d), **kw)
    gate_norm = around_one(g, (L, di), **kw)
    u = torch.rand((3, L, h), generator=g, **f32)
    a_log = torch.log(1.0 + 15.0 * u[0])
    dt = torch.exp(math.log(1e-3) + u[1] * (math.log(1e-1) - math.log(1e-3)))
    dt_bias = dt + torch.log(-torch.expm1(-dt))          # softplus^-1
    D = 1.0 + 0.1 * (2.0 * u[2] - 1.0)
    blocks = []
    for i in range(L):
        blocks.append({"ln1": {"w": norms[i]}, "ssm": {
            "in_proj": in_proj[i], "conv_w": conv_w[i], "conv_b": conv_b[i],
            "A_log": a_log[i], "D": D[i], "dt_bias": dt_bias[i],
            "gate_norm": gate_norm[i], "out_proj": out_proj[i]}})
    return {"embed": embed, "final_norm": {"w": norms[L]}, "blocks": blocks}


def _recurrence(x, dt, A, Bm, Cm):
    """y_t = C_t . h_t for h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T from
    h = 0: x (S, H, P), dt (S, H), A (H,), Bm, Cm (S, N) -> (S, H, P).
    Exact, BLOCK positions at a time."""
    S, H, P = x.shape
    N = Bm.shape[-1]
    state = torch.zeros((H, P, N), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    for s0 in range(0, S, BLOCK):
        s1 = min(S, s0 + BLOCK)
        la = dt[s0:s1] * A                                   # (b, H) log decay
        cum = torch.cumsum(la, dim=0)                        # (b, H)
        xb = x[s0:s1] * dt[s0:s1, :, None]                   # (b, H, P)
        b = s1 - s0
        # decay from position s to position t (t >= s): exp(cum_t - cum_s)
        seg = cum[:, None, :] - cum[None, :, :]              # (t, s, H)
        mask = torch.ones((b, b), dtype=torch.bool,
                          device=x.device).tril()
        w = torch.exp(seg.masked_fill(~mask[:, :, None], float("-inf")))
        cb = Cm[s0:s1] @ Bm[s0:s1].T                         # (t, s)
        y_in = torch.einsum("tsh,ts,shp->thp", w, cb, xb)
        y_prev = torch.einsum("tn,hpn,th->thp", Cm[s0:s1], state,
                              torch.exp(cum))
        y[s0:s1] = y_in + y_prev
        tail = torch.exp(cum[-1][None, :] - cum)             # (s, H)
        state = state * torch.exp(cum[-1])[:, None, None] + torch.einsum(
            "sh,shp,sn->hpn", tail, xb, Bm[s0:s1])
    return y


def logits(params: dict, c: dict, tokens: torch.Tensor, first: int, *,
           precision: str = "f32") -> torch.Tensor:
    """Next-token logits at positions ``first .. len(tokens) - 1`` of one
    sequence ``tokens`` (S,) int: (S - first, vocab) float32."""
    mm = Mat(precision)
    eps = c.get("norm_eps", 1e-5)
    di, n, hp, k = (c["ssm_d_inner"], c["ssm_state"], c["ssm_head_dim"],
                    c["ssm_conv"])
    h = di // hp
    S = tokens.shape[0]
    x = params["embed"][tokens.long()].float()
    for p in params["blocks"]:
        s = p["ssm"]
        zxbcdt = mm(rms(x, p["ln1"]["w"], eps), mm.w(s["in_proj"]))
        z, xbc, dt = zxbcdt.split([di, di + 2 * n, h], dim=-1)
        w = s["conv_w"].float()                               # (k, conv)
        pad = F.pad(xbc, (0, 0, k - 1, 0))
        xbc = sum(pad[i:i + S] * w[i] for i in range(k)) + s["conv_b"].float()
        xbc = F.silu(xbc)
        xs, Bm, Cm = xbc.split([di, n, n], dim=-1)
        dt = F.softplus(dt + s["dt_bias"].float())
        A = -torch.exp(s["A_log"].float())
        xh = xs.reshape(S, h, hp)
        y = _recurrence(xh, dt, A, Bm, Cm) + xh * s["D"].float()[None, :,
                                                                   None]
        y = rms(y.reshape(S, di) * F.silu(z), s["gate_norm"], 1e-5)
        x = x + mm(y, mm.w(s["out_proj"]))
    hid = rms(x[first:], params["final_norm"]["w"], eps)
    out = mm(hid, mm.w(params["embed"]).T)
    return out[:, :c["vocab_size"]]
