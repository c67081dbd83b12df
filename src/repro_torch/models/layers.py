"""Shared layers of the port: norms (RMSNorm, LayerNorm), RoPE, the
sinusoid table, q/k/v projection (biases, per-head q/k norm,
cross-attention), the plain full and chunked attention, attention output,
gated MLP, the chunked cross-entropy of training, and the reference's
initializers.

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
import torch.utils.checkpoint
# The first ``torch.utils.checkpoint`` call of a process otherwise
# imports ``torch._dynamo``, inside the train step; during that import
# ``torch.fx``'s ``wrap`` keeps its own frame in a reference cycle, and
# the frame's caller chain holds the step's locals (its gradients and
# hidden states) until the cyclic collector runs. Importing it here
# moves that cycle to import time, where it holds nothing of a step.
import torch._dynamo  # noqa: F401

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


def layernorm(x, w, b, *, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def apply_norm(x, p, cfg):
    if cfg.norm_type == "layernorm":
        return layernorm(x, p["w"], p["b"], eps=cfg.norm_eps)
    return rmsnorm(x, p["w"], eps=cfg.norm_eps,
                   unit_offset=cfg.rmsnorm_unit_offset)


def init_norm(cfg, device, dtype):
    """The reference's norm init: LayerNorm ``{w: 1, b: 0}``; RMSNorm
    ``{w: 1}``, or ``{w: 0}`` with the (1 + w) unit offset."""
    d = cfg.d_model
    if cfg.norm_type == "layernorm":
        return {"w": torch.ones((d,), dtype=dtype, device=device),
                "b": torch.zeros((d,), dtype=dtype, device=device)}
    fill = torch.zeros if cfg.rmsnorm_unit_offset else torch.ones
    return {"w": fill((d,), dtype=dtype, device=device)}


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


def sinusoidal_pos(seq: int, d_model: int, device=None):
    """Whisper-style sinusoid table (seq, d_model), float32."""
    half = d_model // 2
    idx = torch.arange(half, dtype=torch.float32, device=device)
    freqs = torch.exp(-math.log(10_000.0) * idx / max(half - 1, 1))
    ang = torch.arange(seq, dtype=torch.float32, device=device)[:, None] \
        * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Attention projections
# ---------------------------------------------------------------------------

def _proj_heads(x, w):
    """x (B, S, d) @ w (d, H, hd) -> (B, S, H, hd)."""
    d, h, hd = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * hd)).reshape(
        *x.shape[:-1], h, hd)


def init_attention(cfg, generator, device, dtype):
    """The reference's attention leaves: ``wq (d,H,hd)``, ``wk``/``wv``
    ``(d,Hkv,hd)``, ``wo (H,hd,d)``; zero biases ``bq (H,hd)``, ``bk``/``bv``
    ``(Hkv,hd)`` with ``qkv_bias``; unit ``q_norm``/``k_norm`` ``(hd,)``
    with ``qk_norm``."""
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    p = {"wq": dense_init((d, h, hd), d, generator, device, dtype),
         "wk": dense_init((d, hkv, hd), d, generator, device, dtype),
         "wv": dense_init((d, hkv, hd), d, generator, device, dtype),
         "wo": dense_init((h, hd, d), h * hd, generator, device, dtype)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((hkv, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((hkv, hd), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def _qk_head_norm(x, w, eps):
    """Per-head RMS norm over hd (qwen3 / olmoe q-k norm), in float32."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def project_qkv(p, x, cfg, positions, *, x_kv=None, kv_positions=None,
                use_rope=True):
    """Project to q (B,S,H,hd) and k, v (B,T,Hkv,hd): biases, then the
    per-head q/k norm, then RoPE at ``positions`` ((S,) or per-row (B, S))
    and ``kv_positions`` (default: the same). ``x_kv`` gives keys and
    values from another sequence (cross-attention)."""
    x_kv = x if x_kv is None else x_kv
    kv_positions = positions if kv_positions is None else kv_positions
    q = _proj_heads(x, p["wq"])
    k = _proj_heads(x_kv, p["wk"])
    v = _proj_heads(x_kv, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = _qk_head_norm(q, p["q_norm"], cfg.norm_eps)
        k = _qk_head_norm(k, p["k_norm"], cfg.norm_eps)
    if use_rope and cfg.pos_embed == "rope":
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        if kv_positions is not positions:
            cos, sin = rope_cos_sin(kv_positions, cfg.head_dim,
                                    cfg.rope_theta)
        k = apply_rope(k, cos, sin)
    return q, k, v


def repeat_kv(k, num_heads: int):
    """(B,T,Hkv,hd) -> (B,T,H,hd) by repeating each kv head H/Hkv times."""
    hkv = k.shape[2]
    if hkv == num_heads:
        return k
    return torch.repeat_interleave(k, num_heads // hkv, dim=2)


PAD_POS = 2 ** 30   # sentinel position for padded kv slots


def _mask_bias(q_pos, k_pos, *, causal: bool, window):
    """Additive mask bias float32, broadcastable to (..., Sq, Sk), from
    absolute positions.

    ``window``: 0 / None = unlimited. Sentinel positions (>= PAD_POS/2)
    are always masked, so chunk padding never leaks into non-causal
    attention."""
    dq = q_pos[..., :, None]
    dk = k_pos[..., None, :]
    ok = dk < PAD_POS // 2       # broadcasts against the scores it biases
    if causal:
        ok = ok & (dk <= dq)
    if window:
        ok = ok & (dk > dq - int(window))
    return torch.where(ok, 0.0, NEG_INF).float()


def full_attention(q, k, v, *, q_pos, k_pos, causal=True, window=None,
                   softcap: float = 0.0, extra_mask=None):
    """Dense attention. q (B,S,H,hd), k/v (B,T,H,hd) (kv already
    repeated); q_pos (S,), k_pos (T,). ``extra_mask``: optional (B, T)
    validity mask for cache slots. Scores are formed in the activation
    dtype and softmaxed in float32; the probabilities are normalised
    before they are cast back (the reference's order)."""
    hd = q.shape[-1]
    scores = torch.einsum("bshk,bthk->bhst", q, k).float()
    scores = scores / math.sqrt(hd)
    if softcap > 0:
        scores = softcap * torch.tanh(scores / softcap)
    scores = scores + _mask_bias(q_pos, k_pos, causal=causal, window=window)
    if extra_mask is not None:
        scores = scores + torch.where(
            extra_mask, 0.0, NEG_INF).float()[:, None, None, :]
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthk->bshk", probs, v)


def _kv_block(m, l, acc, qc, kc, vc, qp, kp, *, scale, causal, window,
              softcap):
    """One kv block of ``chunked_attention``'s online softmax: the carries
    ``(m, l, acc)`` of one q block updated by one (cq, ck) tile."""
    s = torch.einsum("bshk,bthk->bhst", qc, kc).float() * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    s = s + _mask_bias(qp, kp, causal=causal, window=window)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum(
        "bhst,bthk->bhsk", p.to(qc.dtype), vc).float()
    return m_new, l, acc


def chunked_attention(q, k, v, *, q_pos, k_pos, causal=True, window=None,
                      softcap: float = 0.0, chunk_q: int = 512,
                      chunk_k: int = 512):
    """Flash-style online-softmax attention over q and kv blocks (the
    reference's ``lax.scan`` as Python loops). Never materialises the
    (S, T) score matrix. Ragged tails are padded: padded queries sit at
    position -1 and are dropped, padded keys at ``PAD_POS`` and are always
    masked. q (B,S,H,hd); k, v (B,T,H,hd); q_pos (S,), k_pos (T,).

    Under autograd (grad enabled and q, k or v requiring it) each kv block
    runs under non-reentrant ``torch.utils.checkpoint``, as the
    reference's ``jax.checkpoint(kv_block)``: the backward saves each
    block's inputs, the carries (m, l of (B,H,cq) and acc of (B,H,cq,hd),
    float32) and views of q, k, v, and recomputes that block's (cq, ck)
    score and probability tiles, so one block pair's tiles are live at a
    time instead of every pair's. The forward computes the same values
    either way."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    cq, ck = min(chunk_q, S), min(chunk_k, T)
    nq, nk = -(-S // cq), -(-T // ck)
    pad_q, pad_k = nq * cq - S, nk * ck - T
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
        q_pos = F.pad(q_pos, (0, pad_q), value=-1)
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
        k_pos = F.pad(k_pos, (0, pad_k), value=PAD_POS)
    kw = dict(scale=1.0 / math.sqrt(hd), causal=causal, window=window,
              softcap=softcap)
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    outs = []
    for iq in range(nq):
        qc = q[:, iq * cq:(iq + 1) * cq]
        qp = q_pos[iq * cq:(iq + 1) * cq]
        m = torch.full((B, H, cq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, cq, hd), dtype=torch.float32,
                          device=q.device)
        for ik in range(nk):
            blk = (m, l, acc, qc, k[:, ik * ck:(ik + 1) * ck],
                   v[:, ik * ck:(ik + 1) * ck], qp,
                   k_pos[ik * ck:(ik + 1) * ck])
            if remat:
                m, l, acc = torch.utils.checkpoint.checkpoint(
                    _kv_block, *blk, use_reentrant=False, **kw)
            else:
                m, l, acc = _kv_block(*blk, **kw)
        out = acc / l.clamp(min=1e-30)[..., None]
        outs.append(out.transpose(1, 2).to(qc.dtype))     # (B,cq,H,hd)
    return torch.cat(outs, dim=1)[:, :S]


def attn_output(p, ctx_heads, out_dtype):
    """ctx (B, S, H, hd) @ wo (H, hd, d) -> (B, S, d)."""
    h, hd, d = p["wo"].shape
    wo = p["wo"].to(ctx_heads.dtype).reshape(h * hd, d)
    return (ctx_heads.reshape(*ctx_heads.shape[:-2], h * hd) @ wo).to(
        out_dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(cfg, generator, device, dtype):
    """Gated MLP ``w_gate``/``w_up (d,f)``, ``w_down (f,d)``; the plain GELU
    MLP has no ``w_gate``."""
    d, f = cfg.d_model, cfg.d_ff
    p = {}
    if cfg.mlp_act in ("swiglu", "geglu"):
        p["w_gate"] = dense_init((d, f), d, generator, device, dtype)
    p["w_up"] = dense_init((d, f), d, generator, device, dtype)
    p["w_down"] = dense_init((f, d), f, generator, device, dtype)
    return p


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


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def _ce_chunk(h, w_out, lbl, ok, vocab_size: int):
    """One sequence chunk's (sum of masked NLL, valid count), float32."""
    logits = (h @ w_out.to(h.dtype)).float()                  # (B, c, Vp)
    logits = logits.masked_fill(
        torch.arange(logits.shape[-1], device=h.device) >= vocab_size,
        NEG_INF)
    mx = logits.amax(dim=-1)
    lse = mx + torch.log(torch.exp(logits - mx[..., None]).sum(dim=-1))
    gold = logits.gather(-1, lbl.long()[..., None])[..., 0]
    okf = ok.float()
    return ((lse - gold) * okf).sum(), okf.sum()


def chunked_cross_entropy(hidden, w_out, labels, *, valid, vocab_size: int,
                          chunk: int = 512):
    """Cross-entropy without materialising full (B, S, V) logits (the
    reference's ``layers.chunked_cross_entropy``).

    hidden (B,S,d), w_out (d,Vp), labels (B,S) int, valid (B,S) bool.
    Logits are formed one sequence chunk at a time in the activation
    dtype, their statistics in float32; padded vocab entries (>=
    vocab_size) are masked out. Each chunk runs under
    ``torch.utils.checkpoint``, so its (B, c, Vp) logits are recomputed
    in the backward, never saved. Returns (sum_loss, sum_valid), float32
    0-d tensors, so callers control normalisation."""
    B, S, _ = hidden.shape
    c = min(chunk, S)
    loss_sum = hidden.new_zeros((), dtype=torch.float32)
    n_valid = hidden.new_zeros((), dtype=torch.float32)
    for s0 in range(0, S, c):
        l, n = torch.utils.checkpoint.checkpoint(
            _ce_chunk, hidden[:, s0:s0 + c], w_out, labels[:, s0:s0 + c],
            valid[:, s0:s0 + c], vocab_size, use_reentrant=False)
        loss_sum = loss_sum + l
        n_valid = n_valid + n
    return loss_sum, n_valid
