"""Model registry of the port: build a ``Model`` bundle from a ModelConfig.

The bundle carries plain functions closed over the config, the device,
the dtypes and the serving knobs, for both KV layouts (slot and paged),
with the paged layout's copy-on-write block clone (prefix caching) and
k-token verify (speculative decoding) where the family's capabilities
allow them. Every family of the reference registry builds: dense, MoE,
SSM, hybrid, the patch_stub VLM (monolithic prefill and slot decode
only) and the encoder-decoder (its own module, :mod:`encdec`: no slot
chunk; the encoder runs as a pre-chunk at paged admission). A path a
family's structure forbids is None in the bundle. :func:`cache_len_for`
sizes a ring-buffer cache.

Training: ``Model.train_loss(params, batch) -> (loss, metrics)`` under
autograd, with the reference's knobs from the ``TrainConfig`` handed to
:func:`build_model`; :func:`batch_spec` gives
the shapes and dtypes of a train batch, :func:`make_synthetic_batch` a
random one.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.config import (BLOCK_HYBRID, BLOCK_SSM, ModelConfig,
                                ServeConfig, ShapeConfig, TrainConfig)
from repro_torch.device import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.layers import dtype_of


class Capabilities(NamedTuple):
    """Structural serving capabilities of a model family (the reference's
    ``registry.Capabilities``). ``reason`` says, for anything False, why
    the structure forbids it; engines raise it verbatim."""
    chunked_prefill: bool = True
    paged_decode: bool = True
    slot_chunk: bool = True
    carried_state: bool = False
    state_leaves: tuple = ()
    prefix_cache: bool = True
    kv_migration: bool = True
    encoder_prechunk: bool = False
    chunk_multiple: int = 1
    speculative: bool = True
    reason: str = ""


def derive_capabilities(cfg: ModelConfig) -> Capabilities:
    """Map config structure to serving capabilities (the reference's,
    branch for branch)."""
    if cfg.frontend == "patch_stub":
        return Capabilities(
            chunked_prefill=False, paged_decode=False, slot_chunk=False,
            prefix_cache=False, kv_migration=False, speculative=False,
            reason="patch_stub modality frontend prepends frontend tokens "
                   "that have no chunked/paged deposit path")
    if cfg.is_encoder_decoder:
        return Capabilities(
            slot_chunk=False, carried_state=True,
            state_leaves=("cross_k", "cross_v"),
            prefix_cache=False, kv_migration=False, encoder_prechunk=True,
            speculative=False,
            reason="carried cross-attention state is per-request, not in "
                   "KV blocks: prefix caching and KV-block migration "
                   "would silently drop it, and speculative rollback "
                   "cannot rewind it by a length decrement")
    if cfg.block in (BLOCK_SSM, BLOCK_HYBRID):
        return Capabilities(
            carried_state=True, state_leaves=("conv", "ssm"),
            prefix_cache=False, kv_migration=False,
            chunk_multiple=cfg.ssm_chunk, speculative=False,
            reason="recurrent carried state is per-request, not in KV "
                   "blocks: prefix caching and KV-block migration would "
                   "silently drop it; chunk boundaries must fall on "
                   "ssm_chunk multiples for bit-exact scan resume; "
                   "speculative rollback cannot rewind carried state "
                   "advanced through rejected draft tokens")
    return Capabilities()


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable[[int], Any]
    # slot layout: monolithic prefill, slot decode, slot chunk (None when
    # capabilities.slot_chunk is False). ``prefill(params, tokens,
    # cache_len, **inputs)`` takes the frontend's inputs by keyword:
    # ``patch_embeds`` (patch_stub) or ``frames`` (encoder-decoder)
    init_cache: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]
    prefill_chunk: Optional[Callable[..., Any]]
    # paged layout — None when capabilities.paged_decode is False
    init_paged_cache: Optional[Callable[..., Any]]
    decode_step_paged: Optional[Callable[..., Any]]
    prefill_chunk_paged: Optional[Callable[..., Any]]
    # copy-on-write block clone (prefix caching) — None when
    # capabilities.prefix_cache is False
    clone_paged_block: Optional[Callable[..., Any]]
    # k-token teacher-forced verify (speculative decoding) — None when
    # capabilities.speculative is False
    verify_step_paged: Optional[Callable[..., Any]]
    # encoder-decoder only: the encoder pass as a pre-chunk at paged
    # admission, ``encode_prechunk(params, cache, frames, rows)``
    encode_prechunk: Optional[Callable[..., Any]]
    capabilities: Capabilities
    device: torch.device
    dtype: torch.dtype              # compute (and KV cache) dtype
    # training: ``train_loss(params, batch) -> (loss, metrics)``, closed
    # over the reference's knobs (``_knobs``)
    train_loss: Callable[..., Any]


def _knobs(train: TrainConfig, serve: ServeConfig) -> Dict[str, Any]:
    return {
        "compute_dtype": train.compute_dtype,
        "param_dtype": train.param_dtype,
        "loss_chunk": train.loss_chunk,
        "attn_chunk_threshold": train.attn_chunk_threshold,
        "attn_chunk": train.attn_chunk,
        "attn_chunk_kv": train.attn_chunk_kv,
        "remat": train.remat,
        "ring_buffer": serve.ring_buffer,
    }


def build_model(cfg: ModelConfig, serve: Optional[ServeConfig] = None, *,
                device="cuda", train: Optional[TrainConfig] = None
                ) -> Model:
    """Build the bundle on ``device`` (default: the card; raises when no
    card is present unless ``device="cpu"``). ``train`` sets the
    parameter dtype of ``init`` and the knobs of ``train_loss``; without
    it both follow ``serve`` (its dtypes and attention chunking)."""
    dev = resolve_device(device)
    serve = serve or ServeConfig()
    if train is None:
        train = TrainConfig(param_dtype=serve.param_dtype,
                            compute_dtype=serve.compute_dtype,
                            attn_chunk_threshold=serve.attn_chunk_threshold,
                            attn_chunk=serve.attn_chunk,
                            attn_chunk_kv=serve.attn_chunk_kv)
    knobs = _knobs(train, serve)
    caps = derive_capabilities(cfg)
    pdt = dtype_of(train.param_dtype)
    cdt = dtype_of(serve.compute_dtype)
    mod = encdec if cfg.is_encoder_decoder else transformer

    def init(seed: int):
        """Parameters from a seeded ``torch.Generator`` on the device."""
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        if cfg.is_encoder_decoder:
            return encdec.init_encdec_params(cfg, gen, dev, pdt)
        return transformer.init_lm_params(cfg, gen, dev, pdt)

    def init_cache(batch: int, cache_len: int, dtype=None):
        return mod.init_cache(cfg, batch, cache_len, device=dev,
                              dtype=dtype or cdt)

    def init_paged_cache(num_blocks: int, block_size: int, dtype=None,
                         num_rows: int = 0):
        return mod.init_paged_cache(cfg, num_blocks, block_size, device=dev,
                                    dtype=dtype or cdt, num_rows=num_rows)

    def step(name):
        return functools.partial(getattr(mod, name), cfg, compute_dtype=cdt)

    paged = caps.paged_decode
    return Model(
        cfg=cfg,
        init=init,
        init_cache=init_cache,
        prefill=functools.partial(mod.prefill, cfg, compute_dtype=cdt,
                                  serve=serve),
        decode_step=step("decode_step"),
        prefill_chunk=step("prefill_chunk") if caps.slot_chunk else None,
        init_paged_cache=init_paged_cache if paged else None,
        decode_step_paged=step("decode_step_paged") if paged else None,
        prefill_chunk_paged=step("prefill_chunk_paged") if paged else None,
        clone_paged_block=(transformer.clone_paged_block
                           if paged and caps.prefix_cache else None),
        verify_step_paged=(step("verify_step_paged")
                           if paged and caps.speculative else None),
        encode_prechunk=(functools.partial(encdec.encode_prechunk, cfg,
                                           compute_dtype=cdt, serve=serve)
                         if caps.encoder_prechunk else None),
        capabilities=caps,
        device=dev,
        dtype=cdt,
        train_loss=mod.make_train_loss(cfg, knobs))


def cache_len_for(cfg: ModelConfig, shape: ShapeConfig,
                  serve: ServeConfig) -> int:
    """KV-cache capacity for a decode cell: ring-buffer mode bounds it at
    the sliding window."""
    if serve.ring_buffer and cfg.swa_window > 0:
        return min(shape.seq_len, cfg.swa_window)
    return shape.seq_len


# ---------------------------------------------------------------------------
# Workload inputs
# ---------------------------------------------------------------------------

class TensorSpec(NamedTuple):
    """Shape and dtype of one input (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def batch_spec(cfg: ModelConfig, shape: ShapeConfig,
               compute_dtype: str = "bfloat16") -> Dict[str, TensorSpec]:
    """Specs of the *data* inputs of a train or prefill step: ``tokens``
    and ``labels`` (B, S) int32, plus ``frames`` (B, encoder_seq, d) for
    the encoder-decoder or ``patch_embeds`` (B, F, d) for the patch_stub
    frontend (whose text is then S - F tokens)."""
    B, S = shape.global_batch, shape.seq_len
    cdt = dtype_of(compute_dtype)
    i32 = torch.int32
    if cfg.is_encoder_decoder:
        return {"frames": TensorSpec((B, cfg.encoder_seq, cfg.d_model), cdt),
                "tokens": TensorSpec((B, S), i32),
                "labels": TensorSpec((B, S), i32)}
    if cfg.frontend == "patch_stub":
        F = cfg.num_frontend_tokens
        return {"tokens": TensorSpec((B, S - F), i32),
                "labels": TensorSpec((B, S - F), i32),
                "patch_embeds": TensorSpec((B, F, cfg.d_model), cdt)}
    return {"tokens": TensorSpec((B, S), i32),
            "labels": TensorSpec((B, S), i32)}


def make_synthetic_batch(cfg: ModelConfig, shape_or_batch, seq_len=None,
                         seed: int = 0, compute_dtype: str = "bfloat16",
                         device="cuda") -> Dict[str, torch.Tensor]:
    """A random batch matching :func:`batch_spec`, drawn on ``device``
    from a seeded ``torch.Generator``: tokens and labels uniform over the
    vocabulary, frames and patch embeddings standard normal (the
    reference's distributions, not its bits)."""
    if isinstance(shape_or_batch, ShapeConfig):
        shape = shape_or_batch
    else:
        shape = ShapeConfig("synthetic", seq_len, shape_or_batch, "train")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    out = {}
    for name, spec in batch_spec(cfg, shape, compute_dtype).items():
        if spec.dtype == torch.int32:
            out[name] = torch.randint(0, cfg.vocab_size, spec.shape,
                                      generator=gen, device=dev,
                                      dtype=torch.int32)
        else:
            out[name] = torch.randn(spec.shape, generator=gen, device=dev,
                                    dtype=torch.float32).to(spec.dtype)
    return out
