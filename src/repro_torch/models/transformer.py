"""Dense decoder-only transformer over the paged KV pool: the port of the
main-path functions of ``src/repro/models/transformer.py``.

Two entry points serve the continuous engine:

* :func:`decode_step_paged` — one token per request row, through the
  rows' block tables (the paged-attention decode kernel);
* :func:`prefill_chunk_paged` — a fixed-size chunk of prompt tokens per
  row, deposited through the block tables (the multi-query kernel, with
  ``lengths = pos0 + C``).

The KV pool is ``{"k", "v"}``, each ``(L, P, bs, Gs, hd)``. Both steps
write it **in place**: PyTorch has no buffer donation, so where the
reference returns a new pool the port updates the one it was given and
returns only the logits. Only valid query tokens write: parked rows
(negative positions), chunk padding (``j >= n_valid``) and rows with an
all ``-1`` table leave the pool byte-identical.

Layers run as a Python loop; attention goes through
``kernels.paged_attention.ops.paged_attention`` unless the caller hands
another function of the same signature in ``attention`` (the plain
version, for a comparison on the card).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels.paged_attention import ops
from repro_torch.models import layers as L


def kv_store_heads(cfg: ModelConfig, tp: int) -> int:
    """Number of kv heads to *store* in the cache: the smallest replication
    of the true kv heads that the model mesh axis divides. Falls back to no
    replication when head counts are coprime to tp."""
    if cfg.num_kv_heads == 0:
        return 0
    reps = cfg.num_heads // cfg.num_kv_heads
    for r in range(1, reps + 1):
        if reps % r == 0 and (cfg.num_kv_heads * r) % tp == 0 \
                and cfg.num_heads % (cfg.num_kv_heads * r) == 0:
            return cfg.num_kv_heads * r
    return cfg.num_kv_heads


def layer_flags(cfg: ModelConfig) -> List[bool]:
    """Per-layer is_global (full attention) flag."""
    return [i in cfg.global_layers for i in range(cfg.num_layers)]


def embed_tokens(cfg, params, tokens, compute_dtype):
    x = params["embed"][tokens.long()].to(compute_dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=compute_dtype,
                             device=x.device)
    return x


def lm_head_weight(cfg, params):
    if cfg.tie_embeddings:
        return params["embed"].t()
    return params["lm_head"]


def _logits(cfg, params, hidden, compute_dtype):
    """(B, d) -> (B, Vp) float32, masked past vocab_size."""
    w_out = lm_head_weight(cfg, params).to(compute_dtype)
    logits = (hidden @ w_out).float()
    logits[:, cfg.vocab_size:] = L.NEG_INF
    return logits


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int, *,
                     device, dtype) -> Dict[str, torch.Tensor]:
    """Global KV block pool: k/v ``(L, P, bs, Gs, hd)``. Table entry ``i`` of
    a request maps its tokens ``[i*bs, (i+1)*bs)`` onto one pool block
    shared across all layers, so positions are structural."""
    gs = kv_store_heads(cfg, 1)
    shape = (cfg.num_layers, num_blocks, block_size, gs, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _write_targets(tables, qpos, wvalid, bs):
    """Which query tokens write the pool, and where: ``(sel_b, sel_j,
    flat)``, with ``flat`` the token's index in the pool viewed as
    ``(P * bs, Gs, hd)``. Only valid queries with a table entry are
    selected — the reference aims the rest at an out-of-range block and
    drops them; the port never forms their index. Computed once per
    forward (one host sync for the selection size), shared by all
    layers."""
    NB = tables.shape[1]
    entry = torch.div(qpos, bs, rounding_mode="floor").clamp(0, NB - 1)
    blk = torch.gather(tables.long(), 1, entry.long())
    ok = wvalid & (blk >= 0)
    sel_b, sel_j = ok.nonzero(as_tuple=True)
    flat = blk[sel_b, sel_j] * bs + torch.remainder(qpos[sel_b, sel_j], bs)
    return sel_b, sel_j, flat


def _paged_attn(cfg, p, xn, k_pool, v_pool, tables, qpos, lengths, targets,
                is_global, attention):
    """Attention for query tokens against (and into) one layer's pool.

    xn (B,C,d); k_pool/v_pool (P,bs,Gs,hd), written in place; tables
    (B,NB); qpos (B,C) absolute query positions; lengths (B,) the
    attention lengths (query j of row b sits at ``lengths[b] - C + j``)."""
    P, bs, gs, hd = k_pool.shape
    q, k, v = L.project_qkv(p, xn, cfg, qpos)
    sel_b, sel_j, flat = targets
    k_pool.view(P * bs, gs, hd)[flat] = \
        L.repeat_kv(k, gs)[sel_b, sel_j].to(k_pool.dtype)
    v_pool.view(P * bs, gs, hd)[flat] = \
        L.repeat_kv(v, gs)[sel_b, sel_j].to(v_pool.dtype)
    window = cfg.swa_window if (cfg.swa_window > 0 and not is_global) else 0
    ctx = attention(q, k_pool, v_pool, tables, lengths, window=window,
                    softcap=cfg.logit_softcap)
    return L.attn_output(p, ctx, xn.dtype)


def _paged_backbone(cfg, params, x, cache, tables, qpos, wvalid, lengths,
                    attention):
    """The dense branch of the reference's paged backbone, as a loop over
    layers. Returns the final-normed hidden states (B, C, d)."""
    bs = cache["k"].shape[2]
    targets = _write_targets(tables, qpos, wvalid, bs)
    h = x
    for i, (p_l, flag) in enumerate(zip(params["blocks"], layer_flags(cfg))):
        xn = L.apply_norm(h, p_l["ln1"], cfg)
        h = h + _paged_attn(cfg, p_l["attn"], xn, cache["k"][i],
                            cache["v"][i], tables, qpos, lengths, targets,
                            flag, attention)
        h = h + L.mlp_apply(p_l["mlp"], L.apply_norm(h, p_l["ln2"], cfg), cfg)
    return L.apply_norm(h, params["final_norm"], cfg)


def decode_step_paged(cfg, params, cache, tokens, positions, block_tables,
                      *, compute_dtype, attention=ops.paged_attention):
    """Batched one-token decode through per-request block tables.

    tokens (B,1) int, positions (B,) int, block_tables (B,NB) int32 ->
    logits (B,Vp) float32; ``cache`` is updated in place. A negative
    (parked) position writes nothing and yields a garbage row the engine
    discards."""
    x = embed_tokens(cfg, params, tokens, compute_dtype)
    qpos = positions.long()[:, None]                  # (B, 1)
    wvalid = qpos >= 0
    lengths = (positions.long() + 1).to(torch.int32)
    h = _paged_backbone(cfg, params, x, cache, block_tables, qpos, wvalid,
                        lengths, attention)
    return _logits(cfg, params, h[:, 0], compute_dtype)


def prefill_chunk_paged(cfg, params, cache, tokens, block_tables, pos0,
                        n_valid, *, compute_dtype,
                        attention=ops.paged_attention):
    """Fixed-shape chunked prompt deposit through block tables.

    tokens (B,C) int; block_tables (B,NB); pos0, n_valid (B,) int ->
    logits at each row's last valid position (B,Vp) float32; ``cache`` is
    updated in place. Padding rows carry an all ``-1`` table and
    ``n_valid == 0``: nothing is written and their logits are garbage."""
    B, C = tokens.shape
    dev = tokens.device
    x = embed_tokens(cfg, params, tokens, compute_dtype)
    j = torch.arange(C, device=dev)[None, :]
    qpos = pos0.long()[:, None] + j
    wvalid = j < n_valid.long()[:, None]
    lengths = (pos0.long() + C).to(torch.int32)
    h = _paged_backbone(cfg, params, x, cache, block_tables, qpos, wvalid,
                        lengths, attention)
    last = (n_valid.long() - 1).clamp(0, C - 1)
    hidden = h[torch.arange(B, device=dev), last]
    return _logits(cfg, params, hidden, compute_dtype)


def init_lm_params(cfg: ModelConfig, generator: torch.Generator, device,
                   dtype) -> Dict[str, Any]:
    """Parameters with the reference's init scheme (truncated-normal
    fan-in weights, 0.02 embedding, zero unit-offset norms), drawn from
    ``generator`` — the scheme, not the reference's bits."""
    d, h, hkv, hd, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim, cfg.d_ff)

    def norm():
        fill = torch.zeros if cfg.rmsnorm_unit_offset else torch.ones
        return {"w": fill((d,), dtype=dtype, device=device)}

    def dense(shape, fan_in):
        return L.dense_init(shape, fan_in, generator, device, dtype)

    params: Dict[str, Any] = {
        "embed": L.embed_init((cfg.padded_vocab, d), generator, device,
                              dtype),
        "final_norm": norm(),
        "blocks": [],
    }
    for _ in range(cfg.num_layers):
        params["blocks"].append({
            "ln1": norm(),
            "attn": {"wq": dense((d, h, hd), d), "wk": dense((d, hkv, hd), d),
                     "wv": dense((d, hkv, hd), d),
                     "wo": dense((h, hd, d), h * hd)},
            "ln2": norm(),
            "mlp": {"w_gate": dense((d, f), d), "w_up": dense((d, f), d),
                    "w_down": dense((f, d), f)},
        })
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((d, cfg.padded_vocab), d)
    return params
