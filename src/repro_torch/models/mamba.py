"""Mamba2 (SSD — state-space duality) block: the port of
``src/repro/models/mamba.py``.

The chunked SSD scan goes through ``kernels.ssd_scan.ops.ssd_scan`` (the
hand-written kernel on the card, its plain version on the CPU), unless
the caller hands another function of the same signature in ``scan``
(the plain version, for a comparison on the card, or training's
differentiable scan). The module owns that plain algorithm,
:func:`ssd_chunked` (the reference's); the kernel has no backward, so
training runs it under autograd on both devices, as the reference's
training runs ``mamba.ssd_chunked``. Every scan runs on the
fixed ``cfg.ssm_chunk`` grid anchored at position 0, never shrunk to the
sequence: a prompt split at ``ssm_chunk`` multiples resumes the scan on
the same grid. ngroups is 1, as in every config.

Decode keeps O(1) state per row: ``conv`` (B, k-1, conv_dim) — the last
k-1 raw (pre-activation) x/B/C rows — and ``ssm`` (B, h, p, n) float32.
The one-token decode recurrence is plain PyTorch, as the reference
computes it outside any Pallas kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops
from repro_torch.models import layers as L


def init_ssm(cfg, generator: torch.Generator, device, dtype):
    """The reference's init scheme, drawn from ``generator``."""
    d, di, n, h = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * n      # x, B, C are convolved together
    f32 = dict(dtype=torch.float32, device=device)
    conv_w = torch.randn((cfg.ssm_conv, conv_dim), generator=generator,
                         **f32) * 0.1
    # dt bias init so softplus(dt_bias) spans [1e-3, 1e-1]
    u = torch.rand((h,), generator=generator, **f32)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt + torch.log(-torch.expm1(-dt))            # inverse softplus
    return {
        "in_proj": L.dense_init((d, 2 * di + 2 * n + h), d, generator,
                                device, dtype),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.arange(1, h + 1, **f32)),
        "D": torch.ones((h,), **f32),
        "dt_bias": dt_bias,
        "gate_norm": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": L.dense_init((di, d), di, generator, device, dtype),
    }


def _softplus(x):
    """``jax.nn.softplus``: log(1 + exp(x)), computed as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _segsum(x):
    """x (..., L) -> (..., L, L): S[i,j] = sum_{k=j+1..i} x[k], -inf above
    the diagonal."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, float("-inf"))


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int, initial_state=None):
    """Chunked SSD scan (the reference's ``mamba.ssd_chunked``) in the
    model's layout: intra-chunk quadratic term, chunk-local states, the
    inter-chunk recurrence and the state-to-output term, with a ragged
    tail identity-padded by ``dt = 0``. xh (b,s,h,p); dt (b,s,h) positive
    rates; A (h,) negative decay; Bm, Cm (b,s,n) shared across heads
    (ngroups = 1). Returns (y (b,s,h,p), final_state (b,h,p,n)), in xh's
    dtype, as the reference computes them. Plain tensor ops, so it runs
    under autograd: training's scan (``kernels.ssd_scan.ref.
    ssd_chunked_scan`` puts it behind the kernel's signature)."""
    b, s, h, p = xh.shape
    n = Bm.shape[-1]
    s_out = s
    pad = (-s) % chunk
    if pad:
        # identity-pad ragged sequences: dt = 0 makes the padded steps
        # exact no-ops on the state (decay exp(0) = 1, contribution 0)
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        s = s + pad
    c = s // chunk

    xd = (xh * dt[..., None]).reshape(b, c, chunk, h, p)
    dA = (dt * A).reshape(b, c, chunk, h).permute(0, 3, 1, 2)   # (b,h,c,l)
    Bc = Bm.reshape(b, c, chunk, n)
    Cc = Cm.reshape(b, c, chunk, n)

    dA_cum = torch.cumsum(dA, dim=-1)                           # (b,h,c,l)
    # 1) intra-chunk (quadratic within the chunk)
    Lm = torch.exp(_segsum(dA))                                 # (b,h,c,l,l)
    y_diag = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp", Cc, Bc, Lm, xd)
    # 2) chunk-local states (each chunk's contribution to the state)
    decay_states = torch.exp(dA_cum[..., -1:] - dA_cum)         # (b,h,c,l)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, decay_states, xd)
    # 3) inter-chunk recurrence; keep the state entering each chunk
    chunk_decay = torch.exp(dA_cum[..., -1])                    # (b,h,c)
    st = (torch.zeros((b, h, p, n), dtype=xh.dtype, device=xh.device)
          if initial_state is None else initial_state.to(xh.dtype))
    prev = []
    for ci in range(c):
        prev.append(st)
        st = st * chunk_decay[:, :, ci, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)                      # (b,c,h,p,n)
    # 4) state -> output within the chunk
    state_decay = torch.exp(dA_cum)                             # (b,h,c,l)
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, prev_states,
                         state_decay)
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y[:, :s_out], st


def _causal_conv(x, w, b):
    """Depthwise causal conv1d. x (B,S,C), w (k,C), b (C)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    return out + b


def _split(zxbcdt, cfg):
    di, n = cfg.ssm_d_inner, cfg.ssm_state
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n],
            zxbcdt[..., 2 * di + 2 * n:])


def _scan(p, xbc, dt, cfg, state, scan):
    """SSD scan of the activated x/B/C rows xbc (B,S,conv_dim) at rates dt
    (B,S,h) float32, from ``state`` (B,h,p,n) or zeros. Returns (y
    (B,S,h,p) float32 with the D skip, final state (B,h,p,n))."""
    B, S, _ = xbc.shape
    di, n, h, hp = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    xs, Bm, Cm = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    A = -torch.exp(p["A_log"])                                   # (h,)
    xh = xs.reshape(B, S, h, hp).float()
    y, final = scan(xh.transpose(1, 2), dt.transpose(1, 2), A, Bm.float(),
                    Cm.float(), state, chunk=cfg.ssm_chunk,
                    return_state=True)
    y = y.transpose(1, 2) + xh * p["D"][None, None, :, None]
    return y, final


def _gated_out(p, y, z, cfg, cd):
    """y (B,S,h,p) float32 -> gated RMSNorm (mamba2) -> out_proj."""
    B, S = y.shape[:2]
    y = y.reshape(B, S, cfg.ssm_d_inner).to(cd)
    y = y * F.silu(z)
    yf = y.float()
    var = yf.square().mean(dim=-1, keepdim=True)
    y = (yf * torch.rsqrt(var + 1e-5) * p["gate_norm"].float()).to(cd)
    return y @ p["out_proj"].to(cd)


def ssm_apply(p, x, cfg, initial_state=None, return_state=False, *,
              scan=ops.ssd_scan):
    """Full-sequence SSD block. x (B,S,d) -> (B,S,d); with
    ``return_state`` also the carried state {conv (B,k-1,conv_dim) in x's
    dtype, ssm (B,h,p,n) float32}."""
    B, S, _ = x.shape
    cd = x.dtype
    k = cfg.ssm_conv
    zxbcdt = x @ p["in_proj"].to(cd)
    z, xbc_raw, dt_raw = _split(zxbcdt, cfg)
    xbc = F.silu(_causal_conv(xbc_raw, p["conv_w"].to(cd),
                              p["conv_b"].to(cd)))
    dt = _softplus(dt_raw.float() + p["dt_bias"])                # (B,S,h)
    y, final = _scan(p, xbc, dt, cfg, initial_state, scan)
    out = _gated_out(p, y, z, cfg, cd)
    if not return_state:
        return out
    # conv state: the last k-1 pre-activation x/B/C rows (left zero pad)
    conv = (xbc_raw[:, -(k - 1):] if S >= k - 1
            else F.pad(xbc_raw, (0, 0, k - 1 - S, 0)))
    return out, {"conv": conv.to(cd), "ssm": final}


def ssm_apply_chunk(p, x, cfg, state, n_valid, *, scan=ops.ssd_scan):
    """Chunk-resumed SSD block: one engine prefill chunk.

    x (B,C,d) — the chunk's hidden states (tail rows may be padding);
    state {conv (B,k-1,conv_dim) raw rows of the valid prefix, ssm
    (B,h,p,n)} from the previous chunk (zeros at position 0); n_valid (B,)
    valid rows of the chunk. Returns (out (B,C,d), new state). Padding
    rows are exact no-ops on the state (dt masked to 0); the new conv
    window ends at the last valid row (an ``n_valid == 0`` row keeps its
    old window)."""
    B, C, _ = x.shape
    cd = x.dtype
    k = cfg.ssm_conv
    zxbcdt = x @ p["in_proj"].to(cd)
    z, xbc_raw, dt_raw = _split(zxbcdt, cfg)
    n_valid = n_valid.long().to(x.device)
    valid = torch.arange(C, device=x.device)[None, :] < n_valid[:, None]

    # conv with the carried window as left context (zeros at position 0 ==
    # the monolithic left pad; the same order of adds as _causal_conv)
    window = torch.cat([state["conv"].to(cd), xbc_raw], dim=1)
    w = p["conv_w"].to(cd)
    xbc = sum(window[:, i:i + C, :] * w[i] for i in range(k))
    xbc = F.silu(xbc + p["conv_b"].to(cd))
    dt = _softplus(dt_raw.float() + p["dt_bias"])
    # softplus is > 0: padding rows are masked so they leave the state be
    dt = torch.where(valid[..., None], dt, torch.zeros_like(dt))
    y, final = _scan(p, xbc, dt, cfg, state["ssm"], scan)
    out = _gated_out(p, y, z, cfg, cd)
    # the k-1 raw rows ending at the last valid position
    idx = n_valid[:, None] + torch.arange(k - 1, device=x.device)[None, :]
    new_conv = torch.gather(
        window, 1, idx[..., None].expand(-1, -1, window.shape[-1]))
    return out, {"conv": new_conv.to(state["conv"].dtype), "ssm": final}


def ssm_decode_step(p, x1, state, cfg):
    """Single-token decode. x1 (B,1,d); state {conv (B,k-1,conv_dim), ssm
    (B,h,p,n)} -> (out (B,1,d), new state)."""
    B = x1.shape[0]
    di, n, h, hp = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    cd = x1.dtype
    k = cfg.ssm_conv
    zxbcdt = x1 @ p["in_proj"].to(cd)
    z, xbc_new, dt_raw = _split(zxbcdt, cfg)
    window = torch.cat([state["conv"].to(cd), xbc_new], dim=1)   # (B,k,cd)
    w = p["conv_w"].to(cd)
    xbc = sum(window[:, i, :] * w[i] for i in range(k)) + p["conv_b"].to(cd)
    xbc = F.silu(xbc)                                            # (B,conv)
    xs, Bv, Cv = xbc[:, :di], xbc[:, di:di + n], xbc[:, di + n:]
    dt = _softplus(dt_raw[:, 0, :].float() + p["dt_bias"])       # (B,h)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)
    xh = xs.reshape(B, h, hp).float()
    ssm = state["ssm"].float()
    ssm = (ssm * dA[..., None, None]
           + torch.einsum("bhp,bn->bhpn", xh * dt[..., None], Bv.float()))
    y = torch.einsum("bhpn,bn->bhp", ssm, Cv.float()) \
        + xh * p["D"][None, :, None]
    out = _gated_out(p, y[:, None], z, cfg, cd)
    return out, {"conv": window[:, 1:, :],
                 "ssm": ssm.to(state["ssm"].dtype)}


def init_ssm_state(cfg, batch: int, dtype, device):
    di, n = cfg.ssm_d_inner, cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * n),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, n),
                           dtype=torch.float32, device=device),
    }
