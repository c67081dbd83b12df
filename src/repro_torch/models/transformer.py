"""Decoder-only LM of the dense, MoE, SSM and hybrid families: the port of
the entry points of ``src/repro/models/transformer.py``.

Training: :func:`make_train_loss` — a full causal forward and the chunked
cross-entropy, under autograd (see its docstring).

Paged layout (the paged continuous engine):

* :func:`decode_step_paged` — one token per request row, through the
  rows' block tables (the paged-attention decode kernel);
* :func:`prefill_chunk_paged` — a fixed-size chunk of prompt tokens per
  row, deposited through the block tables (the multi-query kernel, with
  ``lengths = pos0 + C``);
* :func:`verify_step_paged` — K teacher-forced tokens per row with
  full-width logits (speculative decoding's verify and the drafter's
  resync; the multi-query kernel, with ``lengths = positions + K``);
* :func:`clone_paged_block` — the copy-on-write copy of one pool block
  (prefix caching).

Slot layout (the static engine and the slot continuous engine):

* :func:`prefill` — a whole prompt at once (monolithic prefill), its
  attention through the flash kernel on the card; returns the logits and
  a fresh slot cache;
* :func:`decode_step` — one token per cache row at per-row positions;
* :func:`prefill_chunk` — a fixed-size chunk per cache row.

The KV pool is ``{"k", "v"}``, each ``(L, P, bs, Gs, hd)``; the slot cache
is ``{"k", "v"}``, each ``(L, B, W + 1, Gs, hd)``, plus ``"pos"`` ``(B, W +
1)`` int32, the absolute position held in each column (-1 = empty). The
reference keeps one position row per layer; every layer writes the same
positions, so the port keeps one per cache row. Column ``W`` is a scratch
column: the reference's writes drop out-of-range slots, where
``index_put_`` would raise, so queries that must write nothing (parked
rows, chunk padding) write their k/v there and store position -1, which
keeps the column invisible — without a host sync.

The SSM and hybrid families add the recurrent carried state of each row:
``"conv"`` ``(L, rows, k-1, conv_dim)`` (compute dtype) and ``"ssm"``
``(L, rows, h, p, n)`` float32, in the slot cache (one row per cache row)
and beside the paged pool (one row per request row, threaded through the
chunk steps by ``rows``). An attention-free cache (mamba2) has no
``k``/``v``/``pos``. The hybrid block (hymba) runs attention and the SSM
on the same normed input and averages their RMS-normed outputs. Decode
keeps the state of parked rows; a chunk at ``pos0 == 0`` starts from
zeros by a select, so a recycled row's stale state never leaks in. The
MoE block's FFN is the reference's serve-time dropless routing
(:mod:`repro_torch.models.moe`) on every path. A patch_stub frontend
(internvl2) prepends the request's patch embeddings in monolithic
prefill, positions running over the whole sequence; it has no chunked or
paged path.

Every step writes its cache **in place**: PyTorch has no buffer donation,
so where the reference returns a new cache the port updates the one it
was given and returns only the logits. Only valid query tokens write
visible entries: parked rows (negative positions), chunk padding
(``j >= n_valid``) and, in the paged pool, rows with an all ``-1`` table
leave them byte-identical.

Layers run as a Python loop. Paged attention goes through
``kernels.paged_attention.ops.paged_attention``, monolithic prefill on
the card through ``kernels.flash_attention.ops.flash_attention``, and
every SSD scan (monolithic prefill and chunks) through
``kernels.ssd_scan.ops.ssd_scan``, unless the caller hands another
function of the same signature in ``attention`` or ``scan`` (the plain
versions, for a comparison on the card). On the CPU, monolithic prefill
mirrors the reference: kv repeated, then ``full_attention`` or, above
``attn_chunk_threshold``, ``chunked_attention``. Slot decode and slot
chunks attend in plain PyTorch on both devices, and the one-token SSM
decode is plain PyTorch, as the reference computes them outside any
Pallas kernel.

A prompt longer than the slot cache (a ring buffer: ``cache_len`` is the
sliding window) is prefilled whole, then only its last ``W`` entries are
kept, at columns ``abs_pos % W``, with those absolute positions in the
position row; slot decode and slot chunks write column ``qpos % W``, so
the ring recycles in place.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.utils.checkpoint

from repro_torch.config import (BLOCK_DENSE, BLOCK_HYBRID, BLOCK_MOE,
                                BLOCK_SSM, ModelConfig, ServeConfig)
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_scan
from repro_torch.models import layers as L
from repro_torch.models import mamba, moe
from repro_torch.obs.trace import active as _tr_active

#: monolithic prefill calls since the last :func:`reset_counters`; on the
#: card each launches the flash kernel (attention families) and the SSD
#: scan kernel (SSM families) once per layer
prefill_calls = 0
#: chunk forwards (slot or paged) since the last :func:`reset_counters`;
#: on the card each launches the SSD scan kernel once per layer (SSM
#: families)
chunk_calls = 0
#: verify forwards (:func:`verify_step_paged`) since the last
#: :func:`reset_counters`; on the card each launches the multi-query
#: paged kernel once per layer
verify_calls = 0


def reset_counters() -> None:
    global prefill_calls, chunk_calls, verify_calls
    with _build.count_lock:
        prefill_calls = chunk_calls = verify_calls = 0


def count(name: str) -> None:
    """Add one to the counter ``name`` (``prefill_calls``,
    ``chunk_calls`` or ``verify_calls``) under the port's count lock."""
    _build.count(globals(), name)


def has_state(cfg: ModelConfig) -> bool:
    """Whether the family carries recurrent (conv + SSM) state."""
    return cfg.block in (BLOCK_SSM, BLOCK_HYBRID)


def _residual(cfg, p, h, a_out, s_out):
    """The block's residual update from its attention and SSM outputs
    (either may be None): the hybrid block averages the RMS-normed two."""
    if cfg.block == BLOCK_SSM:
        return h + s_out
    if cfg.block == BLOCK_HYBRID:
        a_out = L.rmsnorm(a_out, p["attn_out_norm"], eps=cfg.norm_eps)
        s_out = L.rmsnorm(s_out, p["ssm_out_norm"], eps=cfg.norm_eps)
        return h + 0.5 * (a_out + s_out)
    return h + a_out


def _combine(cfg, p, h, a_out, s_out, tr=None, phase=None, layer=None):
    """:func:`_residual`, then the MLP of the dense and hybrid blocks or
    the MoE block's dropless experts. Given the tracer ``tr`` (the paged
    forwards, while tracing), the experts' call is a device-timed ``moe``
    span (``cat="block"``) of the forward's ``phase`` and ``layer``."""
    h = _residual(cfg, p, h, a_out, s_out)
    if cfg.block in (BLOCK_DENSE, BLOCK_HYBRID):
        h = h + L.mlp_apply(p["mlp"], L.apply_norm(h, p["ln2"], cfg), cfg)
    elif cfg.block == BLOCK_MOE:
        xn = L.apply_norm(h, p["ln2"], cfg)
        if tr is None:
            out = moe.moe_apply_dropless(p["moe"], xn, cfg)
        else:
            with tr.span("moe", cat="block", device=h.device, phase=phase,
                         layer=layer):
                out = moe.moe_apply_dropless(p["moe"], xn, cfg)
        h = h + out
    return h


def _bcast(mask, like):
    """A (B,) mask shaped to broadcast against ``like`` (B, ...)."""
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


def _ssm_decode(cfg, p, xn, state, live):
    """One-token SSM step; rows that are not ``live`` (parked) keep their
    state, by a select."""
    out, st = mamba.ssm_decode_step(p["ssm"], xn, state, cfg)
    return out, {k: torch.where(_bcast(live, v), v.to(state[k].dtype),
                                state[k]) for k, v in st.items()}


def _ssm_chunk(cfg, p, xn, state, pos0, n_valid, scan):
    """One chunk of the SSM: a row at ``pos0 == 0`` starts from zeros (a
    select, not a multiply, so a stale row's garbage cannot leak into a
    fresh prompt)."""
    fresh = pos0 == 0
    state = {k: torch.where(_bcast(fresh, v), torch.zeros_like(v), v)
             for k, v in state.items()}
    out, st = mamba.ssm_apply_chunk(p["ssm"], xn, cfg, state, n_valid,
                                    scan=scan)
    return out, {k: v.to(state[k].dtype) for k, v in st.items()}


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


def _state_leaves(cfg, rows: int, *, device, dtype):
    """Carried-state leaves of ``rows`` rows: conv (L, rows, k-1,
    conv_dim) in ``dtype``, ssm (L, rows, h, p, n) float32."""
    Lc, di, n = cfg.num_layers, cfg.ssm_d_inner, cfg.ssm_state
    return {"conv": torch.zeros((Lc, rows, cfg.ssm_conv - 1, di + 2 * n),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((Lc, rows, cfg.ssm_heads, cfg.ssm_head_dim,
                                n), dtype=torch.float32, device=device)}


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int, *,
                     device, dtype, num_rows: int = 0
                     ) -> Dict[str, torch.Tensor]:
    """Global KV block pool: k/v ``(L, P, bs, Gs, hd)``. Table entry ``i`` of
    a request maps its tokens ``[i*bs, (i+1)*bs)`` onto one pool block
    shared across all layers, so positions are structural. Recurrent
    carried state is not block-addressable: the SSM and hybrid families
    add conv/ssm leaves ``(L, num_rows, ...)``, one row per engine request
    row. An attention-free model has no k/v. The patch_stub frontend has
    no paged path and raises."""
    if cfg.frontend == "patch_stub":
        raise ValueError("paged KV does not support the patch_stub "
                         "modality frontend (prepended frontend tokens "
                         "have no block-table deposit path)")
    c: Dict[str, torch.Tensor] = {}
    if cfg.uses_attention:
        gs = kv_store_heads(cfg, 1)
        shape = (cfg.num_layers, num_blocks, block_size, gs, cfg.head_dim)
        c["k"] = torch.zeros(shape, dtype=dtype, device=device)
        c["v"] = torch.zeros(shape, dtype=dtype, device=device)
    if has_state(cfg):
        c.update(_state_leaves(cfg, num_rows, device=device, dtype=dtype))
    return c


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
    # One sync a forward, for the selection's size: ROADMAP.md's
    # launch-overhead work removes it (invalid writes aimed at a scratch
    # block instead).
    sel_b, sel_j = ok.nonzero(as_tuple=True)  # lint: ok[host-sync]
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


def _row_indices(rows, num_rows: int, device):
    """The chunk rows' state rows: (gather, dst, src). ``gather`` clamps
    (a padding row reads a real row's state and is never written back);
    ``dst``/``src`` select the rows in range, so an out-of-range row writes
    nothing (the reference's drop mode). Decided on the host: ``rows``
    is a sequence, array or CPU tensor (a CUDA tensor is read back, one
    sync)."""
    # The rows are decided on the host: a CUDA tensor is read back, one
    # sync that ROADMAP.md's launch-overhead work removes; the nonzero
    # below runs on the host copy and syncs nothing.
    r = torch.as_tensor(rows).cpu().long()  # lint: ok[host-sync]
    keep = ((r >= 0) & (r < num_rows)).nonzero().flatten()  # lint: ok[host-sync]
    return (r.clamp(0, num_rows - 1).to(device), r[keep].to(device),
            keep.to(device))


def _paged_backbone(cfg, params, x, cache, tables, qpos, wvalid, lengths,
                    attention, scan, chunk=None):
    """The reference's paged backbone as a loop over layers. KV goes
    through the block tables; the carried state (SSM and hybrid) is
    row-aligned: in decode (``chunk`` None) it advances full width in
    place, parked rows keeping theirs; in a chunk, ``chunk = (rows, pos0,
    n_valid)``, the chunk rows' state is gathered at ``rows``, zeroed for
    fresh prompts, advanced and scattered back. While tracing, each MoE
    layer is a ``moe`` span of phase ``"chunk"`` (a prompt chunk) or
    ``"decode"`` (a decode or verify step). Returns the final-normed
    hidden states (B, C, d)."""
    tr = _tr_active() if cfg.block == BLOCK_MOE else None
    phase = "decode" if chunk is None else "chunk"
    if cfg.uses_attention:
        targets = _write_targets(tables, qpos, wvalid, cache["k"].shape[2])
    if has_state(cfg) and chunk is not None:
        rows, pos0, n_valid = chunk
        gather, dst, src = _row_indices(rows, cache["conv"].shape[1],
                                        x.device)
    h = x
    for i, (p_l, flag) in enumerate(zip(params["blocks"], layer_flags(cfg))):
        xn = L.apply_norm(h, p_l["ln1"], cfg)
        a_out = s_out = None
        if cfg.uses_attention:
            a_out = _paged_attn(cfg, p_l["attn"], xn, cache["k"][i],
                                cache["v"][i], tables, qpos, lengths,
                                targets, flag, attention)
        if has_state(cfg):
            leaves = {k: cache[k][i] for k in ("conv", "ssm")}
            if chunk is None:
                s_out, st = _ssm_decode(cfg, p_l, xn, leaves, qpos[:, 0] >= 0)
                for k, v in st.items():
                    leaves[k].copy_(v)
            else:
                state = {k: v.index_select(0, gather)
                         for k, v in leaves.items()}
                s_out, st = _ssm_chunk(cfg, p_l, xn, state, pos0, n_valid,
                                       scan)
                for k, v in st.items():
                    leaves[k].index_copy_(0, dst, v.index_select(0, src))
        h = _combine(cfg, p_l, h, a_out, s_out, tr, phase, i)
    return L.apply_norm(h, params["final_norm"], cfg)


def decode_step_paged(cfg, params, cache, tokens, positions, block_tables,
                      *, compute_dtype, attention=ops.paged_attention):
    """Batched one-token decode through per-request block tables.

    tokens (B,1) int, positions (B,) int, block_tables (B,NB) int32 ->
    logits (B,Vp) float32; ``cache`` is updated in place. A negative
    (parked) position writes nothing, keeps its row's carried state, and
    yields a garbage row the engine discards. The batch is every request
    row (row-aligned with the carried state)."""
    x = embed_tokens(cfg, params, tokens, compute_dtype)
    qpos = positions.long()[:, None]                  # (B, 1)
    wvalid = qpos >= 0
    lengths = (positions.long() + 1).to(torch.int32)
    h = _paged_backbone(cfg, params, x, cache, block_tables, qpos, wvalid,
                        lengths, attention, None)
    return _logits(cfg, params, h[:, 0], compute_dtype)


def prefill_chunk_paged(cfg, params, cache, tokens, block_tables, rows, pos0,
                        n_valid, *, compute_dtype,
                        attention=ops.paged_attention, scan=ssd_ops.ssd_scan):
    """Fixed-shape chunked prompt deposit through block tables.

    tokens (B,C) int; block_tables (B,NB); rows (B,) each chunk row's
    engine request row (on the host: a sequence, array or CPU tensor);
    pos0, n_valid (B,) int -> logits at each row's last valid position
    (B,Vp) float32; ``cache`` is updated in place. Padding rows carry an
    all ``-1`` table, ``n_valid == 0`` and an out-of-range ``rows`` entry:
    nothing is written and their logits are garbage. ``rows`` matters only
    to the families with carried state."""
    B, C = tokens.shape
    dev = tokens.device
    x = embed_tokens(cfg, params, tokens, compute_dtype)
    j = torch.arange(C, device=dev)[None, :]
    qpos = pos0.long()[:, None] + j
    wvalid = j < n_valid.long()[:, None]
    lengths = (pos0.long() + C).to(torch.int32)
    h = _paged_backbone(cfg, params, x, cache, block_tables, qpos, wvalid,
                        lengths, attention, scan, chunk=(rows, pos0, n_valid))
    count("chunk_calls")
    last = (n_valid.long() - 1).clamp(0, C - 1)
    hidden = h[torch.arange(B, device=dev), last]
    return _logits(cfg, params, hidden, compute_dtype)


def verify_step_paged(cfg, params, cache, tokens, positions, block_tables,
                      n_valid, *, compute_dtype,
                      attention=ops.paged_attention):
    """K-token teacher-forced decode through block tables (speculative
    decoding): tokens (B,K) int, token j of row b at ``positions[b] + j``;
    positions (B,) int (negative = a parked row, which writes nothing);
    block_tables (B,NB); n_valid (B,) the live queries of each row (<= K;
    the rest are padding and write nothing) -> logits (B,K,Vp) float32,
    ``logits[:, j]`` the next-token distribution after token j; ``cache``
    is updated in place. Rolling back a rejected draft is structural: the
    engine advances the row by the accepted count only, and the stale
    rows beyond stay out of causal range until overwritten. Dense family
    only (carried state cannot be rewound)."""
    if has_state(cfg):
        raise ValueError(f"{cfg.name}: speculative verify cannot rewind "
                         "carried recurrent state")
    B, K = tokens.shape
    dev = tokens.device
    x = embed_tokens(cfg, params, tokens, compute_dtype)
    j = torch.arange(K, device=dev)[None, :]
    pos = positions.long()
    qpos = pos[:, None] + j
    wvalid = (j < n_valid.long()[:, None]) & (pos >= 0)[:, None]
    lengths = (pos + K).to(torch.int32)
    h = _paged_backbone(cfg, params, x, cache, block_tables, qpos, wvalid,
                        lengths, attention, None)
    count("verify_calls")
    return _logits(cfg, params, h.reshape(B * K, -1),
                   compute_dtype).reshape(B, K, -1)


def clone_paged_block(cache, src, dst) -> None:
    """Copy-on-write clone of one pool block (prefix caching): block
    ``src``'s pages, every layer's k and v, copied into block ``dst`` in
    place on the current stream, so the chunk that resumes in ``dst``
    (issued after it on the same stream) reads the copy. The source block
    is never written. ``src``, ``dst``: host ints."""
    for name in ("k", "v"):
        cache[name][:, int(dst)].copy_(cache[name][:, int(src)])


# ---------------------------------------------------------------------------
# Slot layout: monolithic prefill, slot decode, slot chunk
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *, device,
               dtype) -> Dict[str, torch.Tensor]:
    """Empty slot cache for ``batch`` rows of ``cache_len`` tokens: with
    attention, k/v ``(L, batch, cache_len + 1, Gs, hd)`` zeros (the last
    column is the scratch column) and pos ``(batch, cache_len + 1)`` int32,
    all -1; with carried state, conv/ssm ``(L, batch, ...)`` zeros."""
    c: Dict[str, torch.Tensor] = {}
    if cfg.uses_attention:
        gs = kv_store_heads(cfg, 1)
        shape = (cfg.num_layers, batch, cache_len + 1, gs, cfg.head_dim)
        c["k"] = torch.zeros(shape, dtype=dtype, device=device)
        c["v"] = torch.zeros(shape, dtype=dtype, device=device)
        c["pos"] = torch.full((batch, cache_len + 1), -1, dtype=torch.int32,
                              device=device)
    if has_state(cfg):
        c.update(_state_leaves(cfg, batch, device=device, dtype=dtype))
    return c


def _attn_branch(cfg, p, xn, positions, is_global, serve: ServeConfig,
                 attention):
    """Self-attention of a whole prompt. xn (B,S,d), positions (S,).
    Returns (out (B,S,d), k, v) with k, v (B,S,Hkv,hd) un-repeated.

    On the card the flash kernel takes the un-repeated k/v (GQA by
    index); it has no softcap, so a softcapped config raises rather than
    lose it. On the CPU: kv repeated, then ``full_attention`` or, above
    ``attn_chunk_threshold``, ``chunked_attention``, as the reference."""
    q, k, v = L.project_qkv(p, xn, cfg, positions)
    # per-layer window: 0 disables the window clause on global layers
    window = ((0 if is_global else cfg.swa_window) if cfg.swa_window > 0
              else None)
    if xn.device.type == "cuda":
        if cfg.logit_softcap > 0:
            raise NotImplementedError(
                f"{cfg.name}: logit_softcap={cfg.logit_softcap}, but the "
                "flash kernel has no softcap (as on the TPU); monolithic "
                "prefill of a softcapped config is not ported to the card")
        ctx = attention(q, k, v, causal=True, window=window or 0)
    else:
        kf = L.repeat_kv(k, cfg.num_heads)
        vf = L.repeat_kv(v, cfg.num_heads)
        if xn.shape[1] > serve.attn_chunk_threshold:
            ctx = L.chunked_attention(
                q, kf, vf, q_pos=positions, k_pos=positions, causal=True,
                window=window, softcap=cfg.logit_softcap,
                chunk_q=serve.attn_chunk,
                chunk_k=serve.attn_chunk_kv or serve.attn_chunk)
        else:
            ctx = L.full_attention(q, kf, vf, q_pos=positions,
                                   k_pos=positions, causal=True,
                                   window=window, softcap=cfg.logit_softcap)
    return L.attn_output(p, ctx, xn.dtype), k, v


def block_forward(cfg, p, x, positions, is_global, serve, attention,
                  scan):
    """One block over a whole sequence: returns (x, k, v, state) — k, v
    None without attention, the carried state None without an SSM."""
    xn = L.apply_norm(x, p["ln1"], cfg)
    a_out = s_out = k = v = state = None
    if cfg.uses_attention:
        a_out, k, v = _attn_branch(cfg, p["attn"], xn, positions, is_global,
                                   serve, attention)
    if has_state(cfg):
        s_out, state = mamba.ssm_apply(p["ssm"], xn, cfg, return_state=True,
                                       scan=scan)
    return _combine(cfg, p, x, a_out, s_out), k, v, state


def _ring_columns(S: int, W: int, device):
    """Where a prompt of S tokens lands in a slot cache of W columns:
    ``(first, cols)`` — tokens ``first..S-1`` go to columns ``cols``. A
    prompt that fits keeps every token at its position (``cols`` a
    slice); a longer one keeps its last W tokens, token ``t`` at column
    ``t % W`` (the ring)."""
    if S <= W:
        return 0, slice(0, S)
    return S - W, torch.remainder(torch.arange(S - W, S, device=device), W)


def backbone(cfg, params, x, positions, serve, cache, attention, scan):
    """The blocks over x (B,S,d) at ``positions`` (S,), as a loop over
    layers; layer i's k/v land in ``cache[...][i]`` at the columns of
    :func:`_ring_columns` and its carried state in
    ``cache["conv"/"ssm"][i]``. Returns the final-normed hidden states
    (B,S,d)."""
    S = x.shape[1]
    if cfg.uses_attention:
        first, cols = _ring_columns(S, cache["k"].shape[2] - 1, x.device)
    h = x
    for i, (p_l, flag) in enumerate(zip(params["blocks"], layer_flags(cfg))):
        h, k, v, state = block_forward(cfg, p_l, h, positions, flag, serve,
                                       attention, scan)
        if k is not None:
            gs = cache["k"].shape[3]
            cache["k"][i][:, cols] = L.repeat_kv(k[:, first:], gs).to(
                cache["k"].dtype)
            cache["v"][i][:, cols] = L.repeat_kv(v[:, first:], gs).to(
                cache["v"].dtype)
        if state is not None:
            for name, t in state.items():
                cache[name][i] = t.to(cache[name].dtype)
    return L.apply_norm(h, params["final_norm"], cfg)


def prefill(cfg, params, tokens, cache_len: int, *, compute_dtype, serve,
            attention=flash_ops.flash_attention, scan=ssd_ops.ssd_scan,
            patch_embeds=None):
    """Run whole prompts: tokens (B,S) int -> (last-position logits (B,Vp)
    float32, slot cache of ``cache_len`` tokens holding the prompts and
    their carried state). A prompt longer than ``cache_len`` keeps its
    last ``cache_len`` entries, rotated onto the ring (its attention still
    runs over the whole prompt). With the patch_stub frontend,
    ``patch_embeds`` (B, F, d) are prepended: the sequence is F + S long
    and its positions run over all of it."""
    dev = tokens.device
    x = embed_tokens(cfg, params, tokens, compute_dtype)
    if cfg.frontend == "patch_stub":
        x = torch.cat([patch_embeds.to(dev, compute_dtype), x], dim=1)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=dev)
    cache = init_cache(cfg, B, cache_len, device=dev, dtype=compute_dtype)
    hidden = backbone(cfg, params, x, positions, serve, cache, attention,
                      scan)
    if cfg.uses_attention:
        first, cols = _ring_columns(S, cache_len, dev)
        cache["pos"][:, cols] = positions[first:].to(torch.int32)
    count("prefill_calls")
    return _logits(cfg, params, hidden[:, -1], compute_dtype), cache


def _masked_group_attention(cfg, p, q, keys, values, okay, out_dtype):
    """Grouped attention of the cached paths: grouped scores, softcap,
    additive NEG_INF mask, softmax, context, output projection.

    q (B,C,H,hd); keys/values (B,T,Gs,hd); okay (B,C,T)."""
    B, C = q.shape[0], q.shape[1]
    gs = keys.shape[2]
    R = cfg.num_heads // gs
    qg = q.reshape(B, C, gs, R, cfg.head_dim)
    s = torch.einsum("bqgrk,btgk->bgrqt", qg, keys).float()
    s = s / math.sqrt(cfg.head_dim)
    if cfg.logit_softcap > 0:
        s = cfg.logit_softcap * torch.tanh(s / cfg.logit_softcap)
    bias = torch.where(okay, 0.0, L.NEG_INF).float()
    s = s + bias[:, None, None]
    prob = torch.softmax(s, dim=-1).to(out_dtype)
    ctx = torch.einsum("bgrqt,btgk->bqgrk", prob, values)
    ctx = ctx.reshape(B, C, cfg.num_heads, cfg.head_dim)
    return L.attn_output(p, ctx, out_dtype)


def _cached_attn(cfg, p, xn, k_cache, v_cache, kpos, qpos, rows, wcol,
                 is_global):
    """Attention for query tokens against (and into) one layer's slot
    cache — the shared core of slot decode and slot chunks.

    xn (B,C,d); k_cache/v_cache (B,W+1,Gs,hd), written in place at
    ``(rows, wcol)``; kpos (B,W+1) the positions after this step's
    writes; qpos (B,C) the queries' absolute positions. Queries attend
    over the whole updated cache, causally masked on the stored
    positions — earlier chunks of the same prompt are cache entries."""
    gs = k_cache.shape[2]
    q, k, v = L.project_qkv(p, xn, cfg, qpos)
    # rows is every row (the callers' arange) and wcol aims padding at the
    # scratch column W: nothing is out of range
    k_cache[rows, wcol] = L.repeat_kv(k, gs).to(k_cache.dtype)  # lint: ok[scatter-drop]
    v_cache[rows, wcol] = L.repeat_kv(v, gs).to(v_cache.dtype)  # lint: ok[scatter-drop]
    kp = kpos[:, None, :]
    okay = (kp >= 0) & (kp <= qpos[:, :, None])             # (B, C, W+1)
    if cfg.swa_window > 0 and not is_global:
        okay = okay & (kp > qpos[:, :, None] - cfg.swa_window)
    return _masked_group_attention(cfg, p, q, k_cache, v_cache, okay,
                                   xn.dtype)


def _slot_backbone(cfg, params, x, cache, qpos, valid, scan, chunk=None):
    """The blocks over the slot cache (in place). Valid queries write
    column ``qpos % W`` and store ``qpos``; the others write the scratch
    column ``W`` and store -1. The position row is shared by the layers,
    so it is written once, before them. The carried state advances per
    row: in decode (``chunk`` None) parked rows keep theirs; in a chunk,
    ``chunk = (pos0, n_valid)``, rows at ``pos0 == 0`` start from zeros."""
    B = x.shape[0]
    if cfg.uses_attention:
        W = cache["pos"].shape[1] - 1
        rows = torch.arange(B, device=x.device)[:, None]
        wcol = torch.where(valid, torch.remainder(qpos, W), W)
        cache["pos"][rows, wcol] = torch.where(valid, qpos, -1).to(
            torch.int32)
        kpos = cache["pos"].long()
    h = x
    for i, (p_l, flag) in enumerate(zip(params["blocks"], layer_flags(cfg))):
        xn = L.apply_norm(h, p_l["ln1"], cfg)
        a_out = s_out = None
        if cfg.uses_attention:
            a_out = _cached_attn(cfg, p_l["attn"], xn, cache["k"][i],
                                 cache["v"][i], kpos, qpos, rows, wcol, flag)
        if has_state(cfg):
            leaves = {k: cache[k][i] for k in ("conv", "ssm")}
            if chunk is None:
                s_out, st = _ssm_decode(cfg, p_l, xn, leaves, qpos[:, 0] >= 0)
            else:
                s_out, st = _ssm_chunk(cfg, p_l, xn, leaves, *chunk, scan)
            for k, v in st.items():
                leaves[k].copy_(v)
        h = _combine(cfg, p_l, h, a_out, s_out)
    return L.apply_norm(h, params["final_norm"], cfg)


def decode_step(cfg, params, cache, tokens, positions, *, compute_dtype):
    """Batched one-token decode over a slot cache: tokens (B,1) int,
    positions (B,) int (one per cache row) -> logits (B,Vp) float32;
    ``cache`` is updated in place. A negative (parked) position writes
    nothing visible, keeps its row's carried state, and yields a garbage
    row the engine discards."""
    x = embed_tokens(cfg, params, tokens, compute_dtype)
    qpos = positions.long()[:, None]                  # (B, 1)
    h = _slot_backbone(cfg, params, x, cache, qpos, qpos >= 0, None)
    return _logits(cfg, params, h[:, 0], compute_dtype)


def prefill_chunk(cfg, params, cache, tokens, pos0, n_valid, *,
                  compute_dtype, scan=ssd_ops.ssd_scan):
    """Fixed-shape chunked prompt deposit into slot-cache rows: tokens
    (B,C) int, pos0 / n_valid (B,) int -> logits at each row's last valid
    position (B,Vp) float32; ``cache`` is updated in place. Padding
    positions (``j >= n_valid``) write no visible entry, draw no attention
    weight from valid queries and leave the carried state as it was."""
    B, C = tokens.shape
    dev = tokens.device
    x = embed_tokens(cfg, params, tokens, compute_dtype)
    j = torch.arange(C, device=dev)[None, :]
    qpos = pos0.long()[:, None] + j
    h = _slot_backbone(cfg, params, x, cache, qpos,
                       j < n_valid.long()[:, None], scan,
                       chunk=(pos0.to(dev), n_valid))
    count("chunk_calls")
    last = (n_valid.long() - 1).clamp(0, C - 1)
    hidden = h[torch.arange(B, device=dev), last]
    return _logits(cfg, params, hidden, compute_dtype)


def init_lm_params(cfg: ModelConfig, generator: torch.Generator, device,
                   dtype) -> Dict[str, Any]:
    """Parameters with the reference's init scheme (truncated-normal
    fan-in weights, 0.02 embedding, unit (or zero unit-offset) norms, zero
    q/k/v biases, unit q/k norms, the SSM's and the experts' own
    schemes), drawn from ``generator`` — the scheme, not the reference's
    bits."""
    d = cfg.d_model

    def norm():
        return L.init_norm(cfg, device, dtype)

    params: Dict[str, Any] = {
        "embed": L.embed_init((cfg.padded_vocab, d), generator, device,
                              dtype),
        "final_norm": norm(),
        "blocks": [],
    }
    for _ in range(cfg.num_layers):
        blk: Dict[str, Any] = {"ln1": norm()}
        if cfg.uses_attention:
            blk["attn"] = L.init_attention(cfg, generator, device, dtype)
        if has_state(cfg):
            blk["ssm"] = mamba.init_ssm(cfg, generator, device, dtype)
        if cfg.block == BLOCK_HYBRID:
            # per-branch output norms before the average (hymba)
            blk["attn_out_norm"] = torch.ones((d,), dtype=dtype,
                                              device=device)
            blk["ssm_out_norm"] = torch.ones((d,), dtype=dtype,
                                             device=device)
        if cfg.block in (BLOCK_DENSE, BLOCK_HYBRID):
            blk["ln2"] = norm()
            blk["mlp"] = L.init_mlp(cfg, generator, device, dtype)
        if cfg.block == BLOCK_MOE:
            blk["ln2"] = norm()
            blk["moe"] = moe.init_moe(cfg, generator, device, dtype)
        params["blocks"].append(blk)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init((d, cfg.padded_vocab), d, generator,
                                         device, dtype)
    return params


# ---------------------------------------------------------------------------
# Training: full causal forward + chunked cross-entropy
# ---------------------------------------------------------------------------


def _train_attn(cfg, p, xn, positions, is_global, knobs):
    """Causal self-attention of training: kv repeated, then the plain
    ``full_attention`` or, above ``attn_chunk_threshold``, the plain
    ``chunked_attention`` — on both devices, as the reference's training
    computes it. Never the flash kernel: it has no backward."""
    q, k, v = L.project_qkv(p, xn, cfg, positions)
    window = ((0 if is_global else cfg.swa_window) if cfg.swa_window > 0
              else None)
    kf = L.repeat_kv(k, cfg.num_heads)
    vf = L.repeat_kv(v, cfg.num_heads)
    if xn.shape[1] > knobs["attn_chunk_threshold"]:
        ctx = L.chunked_attention(
            q, kf, vf, q_pos=positions, k_pos=positions, causal=True,
            window=window, softcap=cfg.logit_softcap,
            chunk_q=knobs["attn_chunk"],
            chunk_k=knobs["attn_chunk_kv"] or knobs["attn_chunk"])
    else:
        ctx = L.full_attention(q, kf, vf, q_pos=positions, k_pos=positions,
                               causal=True, window=window,
                               softcap=cfg.logit_softcap)
    return L.attn_output(p, ctx, xn.dtype)


def train_block(cfg, p, h, positions, is_global, knobs):
    """One block of the training forward: (h, aux). The SSM runs the
    model's plain chunked scan (``mamba.ssd_chunked``) and the MoE FFN
    training's capacity-bounded routing (``moe.moe_apply``), whose losses
    are the aux."""
    xn = L.apply_norm(h, p["ln1"], cfg)
    a_out = s_out = None
    if cfg.uses_attention:
        a_out = _train_attn(cfg, p["attn"], xn, positions, is_global, knobs)
    if has_state(cfg):
        s_out = mamba.ssm_apply(p["ssm"], xn, cfg, scan=ssd_chunked_scan)
    h = _residual(cfg, p, h, a_out, s_out)
    aux: Dict[str, torch.Tensor] = {}
    if cfg.block in (BLOCK_DENSE, BLOCK_HYBRID):
        h = h + L.mlp_apply(p["mlp"], L.apply_norm(h, p["ln2"], cfg), cfg)
    elif cfg.block == BLOCK_MOE:
        m_out, aux = moe.moe_apply(p["moe"], L.apply_norm(h, p["ln2"], cfg),
                                   cfg)
        h = h + m_out
    return h, aux


def remat_call(fn, *args, remat: bool):
    """``fn(*args)``, recomputed in the backward when ``remat`` (the
    reference's ``jax.checkpoint`` of a scanned block): non-reentrant
    ``torch.utils.checkpoint``, so closed-over parameters get their
    gradients."""
    if remat:
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def train_backbone(cfg, params, x, positions, knobs):
    """The blocks over x (B,S,d), one checkpointed call a layer when
    ``knobs["remat"]``: (final-normed hidden, aux means over the
    layers)."""
    auxs: Dict[str, List[torch.Tensor]] = {}
    h = x
    for p_l, flag in zip(params["blocks"], layer_flags(cfg)):
        def body(h_in, p_l=p_l, flag=flag):
            return train_block(cfg, p_l, h_in, positions, flag, knobs)
        h, aux = remat_call(body, h, remat=knobs["remat"])
        for k, v in aux.items():
            auxs.setdefault(k, []).append(v)
    aux = {k: torch.stack(v).mean() for k, v in auxs.items()}
    return L.apply_norm(h, params["final_norm"], cfg), aux


def make_train_loss(cfg: ModelConfig, knobs):
    """``train_loss(params, batch) -> (loss, metrics)``: the reference's
    full causal forward and chunked cross-entropy, under autograd.

    ``batch``: ``tokens`` and ``labels`` (B, S) int tensors (a negative
    label is masked), plus ``patch_embeds`` (B, F, d) with the patch_stub
    frontend: they are prepended, positions run over the whole sequence,
    and the patch positions are masked in the loss. The MoE family adds
    0.01 x the load-balance loss and 1e-3 x the router z-loss; metrics
    carry ``loss`` and the MoE aux means.

    The attention is the port's plain ``full_attention`` (or
    ``chunked_attention`` above ``attn_chunk_threshold``) on both
    devices, and the SSM scan is ``mamba.ssd_chunked``, as in the
    reference's training: the hand-written flash and scan kernels have
    no backward, so training never reaches them (this is not a fallback:
    no kernel exists for this path). ``knobs["remat"]`` recomputes each
    block in the backward."""
    compute_dtype = L.dtype_of(knobs["compute_dtype"])

    def train_loss(params, batch):
        tokens = batch["tokens"]
        x = embed_tokens(cfg, params, tokens, compute_dtype)
        labels = batch["labels"].long()
        if cfg.frontend == "patch_stub":
            pe = batch["patch_embeds"].to(x.device, compute_dtype)
            x = torch.cat([pe, x], dim=1)
            pad = torch.full((labels.shape[0], pe.shape[1]), -1,
                             dtype=labels.dtype, device=labels.device)
            labels = torch.cat([pad, labels], dim=1)
        positions = torch.arange(x.shape[1], device=x.device)
        hidden, aux = train_backbone(cfg, params, x, positions, knobs)
        valid = labels >= 0
        loss_sum, n_valid = L.chunked_cross_entropy(
            hidden, lm_head_weight(cfg, params).to(compute_dtype),
            labels.clamp(min=0), valid=valid, vocab_size=cfg.vocab_size,
            chunk=knobs["loss_chunk"])
        loss = loss_sum / n_valid.clamp(min=1.0)
        if "moe_lb_loss" in aux:
            loss = loss + 0.01 * aux["moe_lb_loss"] + 1e-3 * aux["moe_z_loss"]
        return loss, {"loss": loss, **aux}

    return train_loss
