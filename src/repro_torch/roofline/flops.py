"""Analytical compute/memory roofline terms per workload cell — the port
of ``src/repro/roofline/flops.py``, formula for formula, with the same
dict keys.

The formulas count what the plain model algorithms compute: the chunked
attention evaluates all S x T block pairs, so attention FLOPs use the
full S*T rectangle, not the causal half; the gap to the causal minimum
shows up as the useful-flops ratio, not hidden. A step traced under
``torch.utils.flop_counter.FlopCounterMode`` (``roofline/analysis.py``)
is kept beside them as a cross-check.

Conventions: 1 MAC = 2 FLOPs. Backward pass = 2x forward matmul FLOPs;
remat adds ~1x forward recompute (every block and the CE chunks are
checkpointed), so train ~ 4x forward.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.config import (BLOCK_DENSE, BLOCK_HYBRID, BLOCK_MOE,
                                BLOCK_SSM, MeshConfig, ModelConfig,
                                ShapeConfig)


def _per_token_matmul_flops(cfg: ModelConfig) -> float:
    """Forward matmul FLOPs per token, all layers + LM head."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.num_layers
    per_layer = 0.0
    if cfg.uses_attention:
        h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        per_layer += 2 * d * (h * hd)          # wq
        per_layer += 2 * 2 * d * (hkv * hd)    # wk, wv
        per_layer += 2 * (h * hd) * d          # wo
    if cfg.block in (BLOCK_DENSE, BLOCK_HYBRID):
        gates = 2 if cfg.mlp_act in ("swiglu", "geglu") else 1
        per_layer += 2 * (gates + 1) * d * f
    if cfg.block == BLOCK_MOE:
        gates = 2 if cfg.mlp_act in ("swiglu", "geglu") else 1
        per_layer += 2 * cfg.top_k * (gates + 1) * d * f   # active experts
        per_layer += 2 * d * cfg.num_experts               # router
    if cfg.block in (BLOCK_SSM, BLOCK_HYBRID):
        di, n, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
        per_layer += 2 * d * (2 * di + 2 * n + h)          # in_proj
        per_layer += 2 * di * d                            # out_proj
        per_layer += 2 * cfg.ssm_conv * (di + 2 * n)       # depthwise conv
    total = per_layer * L
    total += 2 * d * cfg.padded_vocab                      # LM head matmul
    if cfg.is_encoder_decoder:
        # encoder blocks + decoder cross-attention projections (per dec tok)
        h, hd = cfg.num_heads, cfg.head_dim
        total += 2 * 2 * d * h * hd * cfg.num_layers       # x-attn q & out
        # encoder runs over encoder_seq tokens regardless of decoder length;
        # accounted separately in cell_compute (enc_tokens)
        return total
    return total


def _attention_score_flops(cfg: ModelConfig, s_q: int, s_kv: int,
                           batch: int) -> float:
    """QK^T + PV einsum FLOPs, as computed (full rectangle, incl. masked)."""
    if not cfg.uses_attention:
        return 0.0
    h, hd, L = cfg.num_heads, cfg.head_dim, cfg.num_layers
    return 2 * 2 * batch * s_q * s_kv * h * hd * L


def _ssd_flops(cfg: ModelConfig, tokens: float) -> float:
    """SSD chunked-scan einsum FLOPs per DESIGN: intra-chunk quadratic
    (l per token) + state in/out projections (n per token)."""
    if cfg.block not in (BLOCK_SSM, BLOCK_HYBRID):
        return 0.0
    h, p, n, l = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
    per_tok = 2 * h * p * l          # y_diag (attention-like within chunk)
    per_tok += 2 * h * l * n         # L/B contraction
    per_tok += 2 * 3 * h * p * n     # states build + y_off + decay apply
    return per_tok * tokens * cfg.num_layers


def cell_compute_flops(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """Global computed FLOPs for one executed step of this cell."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens = B * S
        fwd = (_per_token_matmul_flops(cfg) * tokens
               + _attention_score_flops(cfg, S, S, B)
               + _ssd_flops(cfg, tokens))
        if cfg.is_encoder_decoder:
            enc_tokens = B * cfg.encoder_seq
            enc = (2 * (4 * cfg.d_model * cfg.num_heads * cfg.head_dim
                        + 2 * cfg.d_model * cfg.d_ff)
                   * cfg.num_encoder_layers) * enc_tokens
            enc += _attention_score_flops(
                cfg, cfg.encoder_seq, cfg.encoder_seq, B) \
                / cfg.num_layers * cfg.num_encoder_layers
            xattn = 2 * 2 * B * S * cfg.encoder_seq * cfg.num_heads \
                * cfg.head_dim * cfg.num_layers
            fwd += enc + xattn
        total = 4.0 * fwd          # fwd + bwd(2x) + remat recompute(1x)
        useful = 6.0 * cfg.active_param_count() * tokens
        return {"computed": total, "model_flops": useful}
    if shape.kind == "prefill":
        tokens = B * S
        fwd = (_per_token_matmul_flops(cfg) * tokens
               + _attention_score_flops(cfg, S, S, B)
               + _ssd_flops(cfg, tokens))
        return {"computed": fwd,
                "model_flops": 2.0 * cfg.active_param_count() * tokens}
    # decode: one token, attention reads the whole cache
    cache = shape.seq_len
    if cfg.swa_window > 0:
        # windowed layers only read the window; global layers the full cache
        n_glob = len(cfg.global_layers)
        eff = (n_glob * min(cache, cache)
               + (cfg.num_layers - n_glob) * min(cfg.swa_window, cache)) \
            / cfg.num_layers
        cache = eff
    fwd = (_per_token_matmul_flops(cfg) * B
           + _attention_score_flops(cfg, 1, int(cache), B)
           + _ssd_flops(cfg, B))
    return {"computed": fwd,
            "model_flops": 2.0 * cfg.active_param_count() * B}


def cell_memory_bytes(cfg: ModelConfig, shape: ShapeConfig,
                      mesh_cfg: MeshConfig, *, param_bytes: int = 2,
                      cache_len: int = None) -> Dict:
    """Per-device HBM traffic for one step (reads+writes, estimate).

    Train:  weights fwd+bwd+recompute (3 passes) + grad write + AdamW state
            (m,v,master read+write, f32) + activation traffic
            (~14 d-vectors per token-layer with remat, bf16).
    Prefill: weights once + activations + cache write.
    Decode:  weights once + full cache read + tiny activations (the classic
             memory-bound regime).
    """
    N = cfg.param_count()
    tp = mesh_cfg.tp
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model

    if shape.kind == "train":
        tokens_dev = B * S / mesh_cfg.dp
        w = 3 * N / tp / mesh_cfg.dp * param_bytes   # fsdp gathers land 3x
        grads = N / (tp * mesh_cfg.dp) * 4
        opt = 6 * N / (tp * mesh_cfg.dp) * 4         # m,v,master r+w
        act = 14 * cfg.num_layers * tokens_dev * d * 2
        total = w + grads + opt + act
        return {"bytes": total, "weights": w, "opt": opt + grads, "act": act}
    if shape.kind == "prefill":
        tokens_dev = B * S / mesh_cfg.dp
        w = N / (tp * mesh_cfg.dp) * param_bytes
        act = 6 * cfg.num_layers * tokens_dev * d * 2
        kv = 0.0
        if cfg.uses_attention:
            from repro_torch.models.transformer import kv_store_heads
            gs = kv_store_heads(cfg, tp)
            kv = (2 * cfg.num_layers * (B / mesh_cfg.dp) * S * gs
                  * cfg.head_dim * 2 / max(1, tp if gs % tp == 0 else 1))
        total = w + act + kv
        return {"bytes": total, "weights": w, "act": act, "cache": kv}
    # decode
    w = N / (tp * mesh_cfg.dp) * param_bytes
    dp_eff = mesh_cfg.dp if B % mesh_cfg.dp == 0 else 1
    kv = 0.0
    cl = cache_len if cache_len is not None else S
    if cfg.uses_attention:
        from repro_torch.models.transformer import kv_store_heads
        gs = kv_store_heads(cfg, tp)
        head_shard = tp if gs % tp == 0 else 1
        kv = 2 * cfg.num_layers * (B / dp_eff) * cl * gs * cfg.head_dim * 2 \
            / head_shard
    ssm = 0.0
    if cfg.block in (BLOCK_SSM, BLOCK_HYBRID):
        ssm = (cfg.num_layers * (B / dp_eff) * cfg.ssm_heads
               * cfg.ssm_head_dim * cfg.ssm_state * 4) * 2
    act = 4 * cfg.num_layers * (B / dp_eff) * d * 2
    total = w + kv + ssm + act
    return {"bytes": total, "weights": w, "cache": kv + ssm, "act": act}
