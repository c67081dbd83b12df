"""Shared layers of the port: norms, RoPE, q/k/v projection, attention
output, gated MLP, and the reference's initializers.

Plain functions on tensors; parameters are dicts of tensors in the
reference's layout (``wq`` is ``(d, H, hd)``, ``wo`` is ``(H, hd, d)``,
MLP weights are ``(d, f)`` / ``(f, d)``), so a parameter tree moved over
from the JAX package computes the same function. Matmuls run in the
activation dtype; normalization and RoPE are computed in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}

NEG_INF = -1e30  # large-negative instead of -inf: keeps softmax NaN-free when
                 # a row is fully masked (parked rows, absent table entries)


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


# ---------------------------------------------------------------------------
# Initializers (the reference's scheme, not its bits)
# ---------------------------------------------------------------------------

def _trunc_normal(shape, std: float, generator: torch.Generator, device,
                  dtype) -> torch.Tensor:
    """Normal(0, std) truncated at +-3 std, drawn in float32."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-3.0, b=3.0,
                                generator=generator)
    return (t * std).to(dtype)


def dense_init(shape, in_dim: int, generator, device, dtype):
    """Truncated-normal fan-in init (std = 1/sqrt(in_dim))."""
    return _trunc_normal(shape, in_dim ** -0.5, generator, device, dtype)


def embed_init(shape, generator, device, dtype):
    return _trunc_normal(shape, 0.02, generator, device, dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x, w, *, eps: float = 1e-5, unit_offset: bool = False):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    wf = w.float()
    scale = (1.0 + wf) if unit_offset else wf
    return (y * scale).to(x.dtype)


def apply_norm(x, p, cfg):
    if cfg.norm_type != "rmsnorm":
        raise NotImplementedError(
            f"norm_type {cfg.norm_type!r} is not ported yet (rmsnorm only)")
    return rmsnorm(x, p["w"], eps=cfg.norm_eps,
                   unit_offset=cfg.rmsnorm_unit_offset)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_cos_sin(positions, head_dim: int, theta: float):
    """positions: (...,) int -> cos/sin (..., head_dim//2) float32."""
    half = head_dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-math.log(theta) * idx / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, hd); cos/sin: (S, hd/2) or (B, S, hd/2). Half-split."""
    half = x.shape[-1] // 2
    if cos.dim() == 2:      # (S, half) -> broadcast over batch and heads
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    else:                   # (B, S, half)
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    o1 = xf1 * c - xf2 * s
    o2 = xf2 * c + xf1 * s
    return torch.cat([o1, o2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention projections
# ---------------------------------------------------------------------------

def _proj_heads(x, w):
    """x (B, S, d) @ w (d, H, hd) -> (B, S, H, hd)."""
    d, h, hd = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * hd)).reshape(
        *x.shape[:-1], h, hd)


def project_qkv(p, x, cfg, positions):
    """Project to q (B,S,H,hd) and k, v (B,S,Hkv,hd), with RoPE at
    ``positions`` ((S,) or per-row (B, S))."""
    if cfg.qkv_bias or cfg.qk_norm:
        raise NotImplementedError(
            "qkv_bias / qk_norm arrive with the slice that ports the "
            "qwen configs")
    q = _proj_heads(x, p["wq"])
    k = _proj_heads(x, p["wk"])
    v = _proj_heads(x, p["wv"])
    if cfg.pos_embed == "rope":
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def repeat_kv(k, num_heads: int):
    """(B,T,Hkv,hd) -> (B,T,H,hd) by repeating each kv head H/Hkv times."""
    hkv = k.shape[2]
    if hkv == num_heads:
        return k
    return torch.repeat_interleave(k, num_heads // hkv, dim=2)


def attn_output(p, ctx_heads, out_dtype):
    """ctx (B, S, H, hd) @ wo (H, hd, d) -> (B, S, d)."""
    h, hd, d = p["wo"].shape
    wo = p["wo"].to(ctx_heads.dtype).reshape(h * hd, d)
    return (ctx_heads.reshape(*ctx_heads.shape[:-2], h * hd) @ wo).to(
        out_dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_apply(p, x, cfg):
    """Gated (SwiGLU / GeGLU) or plain GELU MLP. ``jax.nn.gelu`` is the
    tanh approximation, so the port's GELU is too."""
    if cfg.mlp_act in ("swiglu", "geglu"):
        g = x @ p["w_gate"].to(x.dtype)
        u = x @ p["w_up"].to(x.dtype)
        act = (F.silu(g) if cfg.mlp_act == "swiglu"
               else F.gelu(g, approximate="tanh"))
        h = act * u
    else:
        h = F.gelu(x @ p["w_up"].to(x.dtype), approximate="tanh")
    return h @ p["w_down"].to(x.dtype)
