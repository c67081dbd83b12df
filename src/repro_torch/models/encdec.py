"""Whisper-style encoder-decoder of the port: the serving entry points of
``src/repro/models/encdec.py``.

The audio (conv/mel) frontend is a stub, as in the reference: a request
carries precomputed frame embeddings ``frames`` (B, encoder_seq, d). The
encoder is bidirectional self-attention over sinusoidal positions; the
decoder is causal self-attention (KV-cached) plus cross-attention to the
encoder output, with learned positions (``dec_pos``, ``MAX_DECODE_POS``
rows). LayerNorm and the ungated GELU MLP throughout.

Slot layout (the static engine and slot monolithic admission):

* :func:`prefill` — encode the frames, store every decoder layer's cross
  K/V in the cache rows, run the decoder prompt; returns the logits and
  the slot cache;
* :func:`decode_step` — one token per cache row at per-row positions.

There is no slot chunk (the reference's capabilities: an encoder-decoder
chunks on the paged path only).

Training: :func:`make_train_loss` (the encoder, :func:`decode_full`'s
teacher-forced decoder and the chunked cross-entropy, under autograd;
every attention the plain ``full_attention`` / ``chunked_attention`` on
both devices, as the reference's training computes it: the flash kernel
has no backward).

Paged layout: the decoder's self-attention KV pages like any dense
model's; the cross K/V is per-request carried state, ``cross_k`` /
``cross_v`` ``(L, rows, encoder_seq, Hkv, hd)``, one row per engine
request row:

* :func:`encode_prechunk` — the encoder as a fixed pre-chunk at
  admission: installs the request's cross K/V into its row; padding rows
  (out of range) write nothing;
* :func:`prefill_chunk_paged` / :func:`decode_step_paged` — the decoder
  through the block tables (the paged kernels), cross-attending to the
  rows' carried K/V. The cross leaves are read-only after admission.

Caches are updated in place, as in :mod:`transformer`. On the card the
encoder's self-attention and every cross-attention are the flash kernel
with ``causal=False`` on un-repeated K/V (a chunk's gathered cross rows
are a fresh copy the kernel takes by its strides), the static prefill's
decoder self-attention the causal flash kernel, and the paged decoder's
self-attention ``paged_decode`` / ``paged_mq``; the slot decode's
self-attention is plain PyTorch, as for the decoder-only families. On
the CPU the attention is the reference's plain arithmetic.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_attention import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

#: decoder learned-position capacity (the reference's)
MAX_DECODE_POS = 32_768

#: encoder passes (static prefill or the paged pre-chunk) and decoder
#: forwards that cross-attend one step (slot or paged decode) since the
#: last :func:`reset_counters`; on the card an encoder pass launches the
#: flash kernel once per encoder layer, a decode forward once per decoder
#: layer (its cross-attention)
encode_calls = 0
decode_calls = 0


def reset_counters() -> None:
    global encode_calls, decode_calls
    with _build.count_lock:
        encode_calls = decode_calls = 0


def count(name: str) -> None:
    """Add one to the counter ``name`` (``encode_calls`` or
    ``decode_calls``) under the port's count lock."""
    _build.count(globals(), name)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _attn_block(cfg, generator, device, dtype):
    return {"ln1": L.init_norm(cfg, device, dtype),
            "attn": L.init_attention(cfg, generator, device, dtype),
            "ln2": L.init_norm(cfg, device, dtype),
            "mlp": L.init_mlp(cfg, generator, device, dtype)}


def init_encdec_params(cfg: ModelConfig, generator: torch.Generator, device,
                       dtype, max_pos: int = MAX_DECODE_POS
                       ) -> Dict[str, Any]:
    """The reference's tree and init scheme: ``embed (Vp, d)``, ``dec_pos
    (max_pos, d)``, ``enc_blocks`` (ln1, attn, ln2, mlp), ``dec_blocks``
    (the same plus ``ln_x`` and the cross-attention ``xattn``),
    ``enc_norm``, ``final_norm`` and ``lm_head`` — drawn from
    ``generator``."""
    d = cfg.d_model
    params: Dict[str, Any] = {
        "embed": L.embed_init((cfg.padded_vocab, d), generator, device,
                              dtype),
        "dec_pos": L.embed_init((max_pos, d), generator, device, dtype),
        "enc_blocks": [_attn_block(cfg, generator, device, dtype)
                       for _ in range(cfg.num_encoder_layers)],
        "dec_blocks": [],
        "enc_norm": L.init_norm(cfg, device, dtype),
        "final_norm": L.init_norm(cfg, device, dtype),
    }
    for _ in range(cfg.num_layers):
        blk = _attn_block(cfg, generator, device, dtype)
        blk["ln_x"] = L.init_norm(cfg, device, dtype)
        blk["xattn"] = L.init_attention(cfg, generator, device, dtype)
        params["dec_blocks"].append(blk)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init((d, cfg.padded_vocab), d, generator,
                                         device, dtype)
    return params


# ---------------------------------------------------------------------------
# Attention pieces
# ---------------------------------------------------------------------------

def _self_attn(cfg, p, xn, positions, *, causal, serve, attention):
    """Self-attention of a whole sequence (encoder: non-causal; static
    decoder prompt: causal). Returns (out, k, v), k/v un-repeated."""
    q, k, v = L.project_qkv(p, xn, cfg, positions, use_rope=False)
    if xn.device.type == "cuda":
        ctx = attention(q, k, v, causal=causal)
    else:
        kf = L.repeat_kv(k, cfg.num_heads)
        vf = L.repeat_kv(v, cfg.num_heads)
        if xn.shape[1] > serve.attn_chunk_threshold:
            ctx = L.chunked_attention(
                q, kf, vf, q_pos=positions, k_pos=positions, causal=causal,
                chunk_q=serve.attn_chunk, chunk_k=serve.attn_chunk)
        else:
            ctx = L.full_attention(q, kf, vf, q_pos=positions,
                                   k_pos=positions, causal=causal)
    return L.attn_output(p, ctx, xn.dtype), k, v


def _cross_kv(cfg, p_x, enc_out):
    """Encoder-side K/V of one decoder layer's cross-attention (no rope):
    (B, T_enc, Hkv, hd) each."""
    k = L._proj_heads(enc_out, p_x["wk"])
    v = L._proj_heads(enc_out, p_x["wv"])
    if cfg.qkv_bias:
        k = k + p_x["bk"].to(enc_out.dtype)
        v = v + p_x["bv"].to(enc_out.dtype)
    return k, v


def _cross_attn(cfg, p_x, xn, ck, cv, attention):
    """Decoder queries xn (B, S, d) against cross K/V (B, T_enc, Hkv, hd):
    non-causal, no window."""
    q = L._proj_heads(xn, p_x["wq"])
    if cfg.qkv_bias:
        q = q + p_x["bq"].to(xn.dtype)
    ck, cv = ck.to(xn.dtype), cv.to(xn.dtype)
    if xn.device.type == "cuda":
        ctx = attention(q, ck, cv, causal=False)
    else:
        dev = xn.device
        ctx = L.full_attention(
            q, L.repeat_kv(ck, cfg.num_heads), L.repeat_kv(cv, cfg.num_heads),
            q_pos=torch.arange(xn.shape[1], device=dev),
            k_pos=torch.arange(ck.shape[1], device=dev), causal=False)
    return L.attn_output(p_x, ctx, xn.dtype)


def encode(cfg, params, frames, *, compute_dtype, serve,
           attention=flash_ops.flash_attention):
    """frames (B, T_enc, d) (stub embeddings) -> the encoder's normed
    output (B, T_enc, d) in ``compute_dtype``."""
    x = frames.to(compute_dtype)
    T_enc = x.shape[1]
    x = x + L.sinusoidal_pos(T_enc, cfg.d_model, x.device).to(compute_dtype)
    positions = torch.arange(T_enc, device=x.device)
    for p_l in params["enc_blocks"]:
        hn = L.apply_norm(x, p_l["ln1"], cfg)
        a_out, _, _ = _self_attn(cfg, p_l["attn"], hn, positions,
                                 causal=False, serve=serve,
                                 attention=attention)
        x = x + a_out
        x = x + L.mlp_apply(p_l["mlp"], L.apply_norm(x, p_l["ln2"], cfg), cfg)
    count("encode_calls")
    return L.apply_norm(x, params["enc_norm"], cfg)


def _dec_embed(cfg, params, tokens, qpos, compute_dtype):
    """Token embedding + learned decoder positions; parked and padding
    queries clip to a position in range (their outputs are dropped)."""
    x = params["embed"][tokens.long()].to(compute_dtype)
    pos = qpos.long().clamp(0, params["dec_pos"].shape[0] - 1)
    return x + params["dec_pos"][pos].to(compute_dtype)


def _dec_tail(cfg, p_l, h, ck, cv, attention):
    """A decoder layer after its self-attention: cross-attention, MLP."""
    h = h + _cross_attn(cfg, p_l["xattn"], L.apply_norm(h, p_l["ln_x"], cfg),
                        ck, cv, attention)
    return h + L.mlp_apply(p_l["mlp"], L.apply_norm(h, p_l["ln2"], cfg), cfg)


# ---------------------------------------------------------------------------
# Slot layout: monolithic prefill and slot decode
# ---------------------------------------------------------------------------

def _cross_leaves(cfg, rows: int, *, device, dtype):
    shape = (cfg.num_layers, rows, cfg.encoder_seq, cfg.num_kv_heads,
             cfg.head_dim)
    return {"cross_k": torch.zeros(shape, dtype=dtype, device=device),
            "cross_v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *, device,
               dtype) -> Dict[str, torch.Tensor]:
    """The decoder-only slot cache (k/v with the scratch column, pos) plus
    ``cross_k``/``cross_v`` ``(L, batch, encoder_seq, Hkv, hd)``."""
    c = T.init_cache(cfg, batch, cache_len, device=device, dtype=dtype)
    c.update(_cross_leaves(cfg, batch, device=device, dtype=dtype))
    return c


def prefill(cfg, params, tokens, cache_len: int, *, compute_dtype, serve,
            frames, attention=flash_ops.flash_attention):
    """Encode ``frames`` (B, T_enc, d), store each decoder layer's cross
    K/V, then run the decoder prompt tokens (B, S) -> (last-position
    logits (B, Vp) float32, slot cache of ``cache_len`` tokens). The
    prompt must fit the cache (the reference's has no ring here)."""
    B, S = tokens.shape
    if S > cache_len:
        raise ValueError(f"{cfg.name}: a prompt of {S} tokens does not fit "
                         f"the decoder cache of {cache_len}")
    dev = tokens.device
    enc_out = encode(cfg, params, frames.to(dev), compute_dtype=compute_dtype,
                     serve=serve, attention=attention)
    cache = init_cache(cfg, B, cache_len, device=dev, dtype=compute_dtype)
    positions = torch.arange(S, device=dev)
    h = _dec_embed(cfg, params, tokens, positions, compute_dtype)
    gs = cache["k"].shape[3]
    for i, p_l in enumerate(params["dec_blocks"]):
        ck, cv = _cross_kv(cfg, p_l["xattn"], enc_out)
        # i is the layer, not a request row: the monolithic prefill writes
        # every row of the layer's leaf
        cache["cross_k"][i] = ck.to(compute_dtype)  # lint: ok[state-thread]
        cache["cross_v"][i] = cv.to(compute_dtype)  # lint: ok[state-thread]
        a_out, k, v = _self_attn(cfg, p_l["attn"],
                                 L.apply_norm(h, p_l["ln1"], cfg), positions,
                                 causal=True, serve=serve,
                                 attention=attention)
        cache["k"][i][:, :S] = L.repeat_kv(k, gs).to(compute_dtype)
        cache["v"][i][:, :S] = L.repeat_kv(v, gs).to(compute_dtype)
        h = _dec_tail(cfg, p_l, h + a_out, ck, cv, attention)
    cache["pos"][:, :S] = positions.to(torch.int32)
    h = L.apply_norm(h, params["final_norm"], cfg)
    T.count("prefill_calls")
    return T._logits(cfg, params, h[:, -1], compute_dtype), cache


def decode_step(cfg, params, cache, tokens, positions, *, compute_dtype,
                attention=flash_ops.flash_attention):
    """Batched one-token decode over a slot cache: tokens (B,1) int,
    positions (B,) int -> logits (B,Vp) float32; ``cache`` is updated in
    place. A negative (parked) position writes nothing visible."""
    B = tokens.shape[0]
    qpos = positions.long()[:, None]                  # (B, 1)
    valid = qpos >= 0
    h = _dec_embed(cfg, params, tokens, qpos, compute_dtype)
    W = cache["pos"].shape[1] - 1
    rows = torch.arange(B, device=h.device)[:, None]
    wcol = torch.where(valid, torch.remainder(qpos, W), W)
    cache["pos"][rows, wcol] = torch.where(valid, qpos, -1).to(torch.int32)
    kpos = cache["pos"].long()
    for i, p_l in enumerate(params["dec_blocks"]):
        a_out = T._cached_attn(cfg, p_l["attn"],
                               L.apply_norm(h, p_l["ln1"], cfg),
                               cache["k"][i], cache["v"][i], kpos, qpos,
                               rows, wcol, True)
        h = _dec_tail(cfg, p_l, h + a_out, cache["cross_k"][i],
                      cache["cross_v"][i], attention)
    h = L.apply_norm(h, params["final_norm"], cfg)
    count("decode_calls")
    return T._logits(cfg, params, h[:, 0], compute_dtype)


# ---------------------------------------------------------------------------
# Paged layout: the encoder pre-chunk, decoder chunks and decode
# ---------------------------------------------------------------------------

def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int, *,
                     device, dtype, num_rows: int = 0
                     ) -> Dict[str, torch.Tensor]:
    """The decoder's KV block pool, k/v ``(L, P, bs, Hkv, hd)``, plus the
    row-aligned carried cross K/V ``(L, num_rows, encoder_seq, Hkv,
    hd)``."""
    c = T.init_paged_cache(cfg, num_blocks, block_size, device=device,
                           dtype=dtype, num_rows=num_rows)
    c.update(_cross_leaves(cfg, num_rows, device=device, dtype=dtype))
    return c


def encode_prechunk(cfg, params, cache, frames, rows, *, compute_dtype,
                    serve, attention=flash_ops.flash_attention) -> None:
    """The encoder pass as a fixed pre-chunk at admission: frames (B,
    T_enc, d), rows (B,) each frame row's request row (on the host) ->
    every decoder layer's cross K/V installed into those rows of
    ``cache``, in place. An out-of-range row writes nothing."""
    dev = cache["cross_k"].device
    enc_out = encode(cfg, params, frames.to(dev), compute_dtype=compute_dtype,
                     serve=serve, attention=attention)
    _, dst, src = T._row_indices(rows, cache["cross_k"].shape[1], dev)
    for i, p_l in enumerate(params["dec_blocks"]):
        ck, cv = _cross_kv(cfg, p_l["xattn"], enc_out)
        for name, t in (("cross_k", ck), ("cross_v", cv)):
            cache[name][i].index_copy_(0, dst, t.index_select(0, src).to(
                cache[name].dtype))


def _paged_dec_backbone(cfg, params, x, cache, tables, qpos, wvalid, lengths,
                        attention, cross_attention, rows=None):
    """The decoder over the paged pool: self-attention through the block
    tables (the paged kernels), cross-attention against the carried cross
    K/V — the rows' own in a chunk (``rows``: each chunk row's request
    row, gathered; a padding row reads a clamped row and is dropped), the
    whole row-aligned leaf in decode. Returns the final-normed hidden
    states."""
    targets = T._write_targets(tables, qpos, wvalid, cache["k"].shape[2])
    if rows is not None:
        gather = T._row_indices(rows, cache["cross_k"].shape[1],
                                x.device)[0]
    h = x
    for i, p_l in enumerate(params["dec_blocks"]):
        a_out = T._paged_attn(cfg, p_l["attn"],
                              L.apply_norm(h, p_l["ln1"], cfg),
                              cache["k"][i], cache["v"][i], tables, qpos,
                              lengths, targets, True, attention)
        ck, cv = cache["cross_k"][i], cache["cross_v"][i]
        if rows is not None:
            ck, cv = ck.index_select(0, gather), cv.index_select(0, gather)
        h = _dec_tail(cfg, p_l, h + a_out, ck, cv, cross_attention)
    return L.apply_norm(h, params["final_norm"], cfg)


def prefill_chunk_paged(cfg, params, cache, tokens, block_tables, rows, pos0,
                        n_valid, *, compute_dtype,
                        attention=ops.paged_attention,
                        cross_attention=flash_ops.flash_attention):
    """The decoder-only path's contract (tokens (B,C), block_tables
    (B,NB), rows (B,) on the host, pos0 / n_valid (B,)) -> logits at each
    row's last valid position (B,Vp) float32, with cross-attention to the
    rows' carried encoder state the only extra term."""
    B, C = tokens.shape
    dev = tokens.device
    j = torch.arange(C, device=dev)[None, :]
    qpos = pos0.long()[:, None] + j
    wvalid = j < n_valid.long()[:, None]
    lengths = (pos0.long() + C).to(torch.int32)
    x = _dec_embed(cfg, params, tokens, qpos, compute_dtype)
    h = _paged_dec_backbone(cfg, params, x, cache, block_tables, qpos, wvalid,
                            lengths, attention, cross_attention, rows=rows)
    T.count("chunk_calls")
    last = (n_valid.long() - 1).clamp(0, C - 1)
    return T._logits(cfg, params, h[torch.arange(B, device=dev), last],
                     compute_dtype)


def decode_step_paged(cfg, params, cache, tokens, positions, block_tables, *,
                      compute_dtype, attention=ops.paged_attention,
                      cross_attention=flash_ops.flash_attention):
    """Batched one-token decode through block tables, row-aligned with the
    carried cross K/V (batch row i is engine row i): tokens (B,1),
    positions (B,) (negative = parked: writes nothing), block_tables
    (B,NB) -> logits (B,Vp) float32."""
    qpos = positions.long()[:, None]
    lengths = (positions.long() + 1).to(torch.int32)
    x = _dec_embed(cfg, params, tokens, qpos, compute_dtype)
    h = _paged_dec_backbone(cfg, params, x, cache, block_tables, qpos,
                            qpos >= 0, lengths, attention, cross_attention)
    count("decode_calls")
    return T._logits(cfg, params, h[:, 0], compute_dtype)


# ---------------------------------------------------------------------------
# Training: encoder + teacher-forced decoder + chunked cross-entropy
# ---------------------------------------------------------------------------

def _train_self_attn(cfg, p, xn, positions, *, causal, knobs):
    """Self-attention of training (no rope): the plain full attention, or
    the plain chunked one above ``attn_chunk_threshold``."""
    q, k, v = L.project_qkv(p, xn, cfg, positions, use_rope=False)
    kf, vf = L.repeat_kv(k, cfg.num_heads), L.repeat_kv(v, cfg.num_heads)
    if xn.shape[1] > knobs["attn_chunk_threshold"]:
        ctx = L.chunked_attention(q, kf, vf, q_pos=positions,
                                  k_pos=positions, causal=causal,
                                  chunk_q=knobs["attn_chunk"],
                                  chunk_k=knobs["attn_chunk"])
    else:
        ctx = L.full_attention(q, kf, vf, q_pos=positions, k_pos=positions,
                               causal=causal)
    return L.attn_output(p, ctx, xn.dtype)


def _train_cross_attn(cfg, p_x, xn, enc_out):
    """Cross-attention of training: the plain full attention over the
    encoder output's K/V."""
    ck, cv = _cross_kv(cfg, p_x, enc_out)
    q = L._proj_heads(xn, p_x["wq"])
    if cfg.qkv_bias:
        q = q + p_x["bq"].to(xn.dtype)
    dev = xn.device
    ctx = L.full_attention(
        q, L.repeat_kv(ck, cfg.num_heads), L.repeat_kv(cv, cfg.num_heads),
        q_pos=torch.arange(xn.shape[1], device=dev),
        k_pos=torch.arange(ck.shape[1], device=dev), causal=False)
    return L.attn_output(p_x, ctx, xn.dtype)


def train_encode(cfg, params, frames, knobs):
    """frames (B, T_enc, d) -> the encoder's normed output, each layer
    recomputed in the backward when ``knobs["remat"]``."""
    compute_dtype = L.dtype_of(knobs["compute_dtype"])
    x = frames.to(compute_dtype)
    T_enc = x.shape[1]
    x = x + L.sinusoidal_pos(T_enc, cfg.d_model, x.device).to(compute_dtype)
    positions = torch.arange(T_enc, device=x.device)
    for p_l in params["enc_blocks"]:
        def body(h, p_l=p_l):
            hn = L.apply_norm(h, p_l["ln1"], cfg)
            h = h + _train_self_attn(cfg, p_l["attn"], hn, positions,
                                     causal=False, knobs=knobs)
            return h + L.mlp_apply(p_l["mlp"],
                                   L.apply_norm(h, p_l["ln2"], cfg), cfg)
        x = T.remat_call(body, x, remat=knobs["remat"])
    return L.apply_norm(x, params["enc_norm"], cfg)


def decode_full(cfg, params, tokens, enc_out, knobs, pos_offset: int = 0):
    """Teacher-forced decoder pass (the reference's): tokens (B, S) at
    positions ``pos_offset..`` -> final-normed hidden (B, S, d)."""
    compute_dtype = L.dtype_of(knobs["compute_dtype"])
    S = tokens.shape[1]
    x = params["embed"][tokens.long()].to(compute_dtype)
    x = x + params["dec_pos"][pos_offset:pos_offset + S].to(compute_dtype)
    positions = torch.arange(pos_offset, pos_offset + S, device=x.device)
    for p_l in params["dec_blocks"]:
        def body(h, p_l=p_l):
            hn = L.apply_norm(h, p_l["ln1"], cfg)
            h = h + _train_self_attn(cfg, p_l["attn"], hn, positions,
                                     causal=True, knobs=knobs)
            h = h + _train_cross_attn(cfg, p_l["xattn"],
                                      L.apply_norm(h, p_l["ln_x"], cfg),
                                      enc_out)
            return h + L.mlp_apply(p_l["mlp"],
                                   L.apply_norm(h, p_l["ln2"], cfg), cfg)
        x = T.remat_call(body, x, remat=knobs["remat"])
    return L.apply_norm(x, params["final_norm"], cfg)


def make_train_loss(cfg: ModelConfig, knobs):
    """``train_loss(params, batch) -> (loss, {"loss": loss})`` over a batch
    of ``frames`` (B, T_enc, d), ``tokens`` and ``labels`` (B, S)."""

    def train_loss(params, batch):
        enc_out = train_encode(cfg, params, batch["frames"], knobs)
        hidden = decode_full(cfg, params, batch["tokens"], enc_out, knobs)
        labels = batch["labels"].long()
        w_out = (params["embed"].t() if cfg.tie_embeddings
                 else params["lm_head"])
        loss_sum, n_valid = L.chunked_cross_entropy(
            hidden, w_out.to(hidden.dtype), labels.clamp(min=0),
            valid=labels >= 0, vocab_size=cfg.vocab_size,
            chunk=knobs["loss_chunk"])
        loss = loss_sum / n_valid.clamp(min=1.0)
        return loss, {"loss": loss}

    return train_loss
