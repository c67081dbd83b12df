"""Model registry of the port: build a ``Model`` bundle from a ModelConfig.

The bundle carries plain functions closed over the config, the device,
the dtypes and the serving knobs, for both KV layouts (slot and paged),
with the paged layout's copy-on-write block clone (prefix caching) and
k-token verify (speculative decoding) where the family's capabilities
allow them. The port serves the dense, SSM and hybrid families; MoE and
encoder-decoder models raise, naming the slice of the port that brings
them. :func:`cache_len_for` sizes a ring-buffer cache.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.config import (BLOCK_DENSE, BLOCK_HYBRID, BLOCK_MOE,
                                BLOCK_SSM, ModelConfig, ServeConfig,
                                ShapeConfig)
from repro_torch.device import resolve_device
from repro_torch.models import transformer
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


_LATER_FAMILIES = {
    BLOCK_MOE: "the model-families slice (MoE, dropless routing)",
}


def derive_capabilities(cfg: ModelConfig) -> Capabilities:
    """Map config structure to serving capabilities (the reference's, for
    the families the port serves)."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            "encoder-decoder models arrive with the model-families slice of "
            "the port")
    if cfg.frontend == "patch_stub":
        raise NotImplementedError(
            "the patch_stub frontend arrives with the dense-family slice of "
            "the port")
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
    if cfg.block != BLOCK_DENSE:
        raise NotImplementedError(
            f"block family {cfg.block!r} arrives with "
            f"{_LATER_FAMILIES.get(cfg.block, 'a later slice')} of the port")
    return Capabilities()


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable[[int], Any]
    # slot layout: monolithic prefill, slot decode, slot chunk
    init_cache: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]
    prefill_chunk: Callable[..., Any]
    # paged layout
    init_paged_cache: Callable[..., Any]
    decode_step_paged: Callable[..., Any]
    prefill_chunk_paged: Callable[..., Any]
    # copy-on-write block clone (prefix caching) — None when
    # capabilities.prefix_cache is False
    clone_paged_block: Optional[Callable[..., Any]]
    # k-token teacher-forced verify (speculative decoding) — None when
    # capabilities.speculative is False
    verify_step_paged: Optional[Callable[..., Any]]
    capabilities: Capabilities
    device: torch.device
    dtype: torch.dtype              # compute (and KV cache) dtype


def build_model(cfg: ModelConfig, serve: Optional[ServeConfig] = None, *,
                device="cuda") -> Model:
    """Build the bundle on ``device`` (default: the card; raises when no
    card is present unless ``device="cpu"``)."""
    dev = resolve_device(device)
    serve = serve or ServeConfig()
    caps = derive_capabilities(cfg)
    pdt = dtype_of(serve.param_dtype)
    cdt = dtype_of(serve.compute_dtype)

    def init(seed: int):
        """Parameters from a seeded ``torch.Generator`` on the device."""
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        return transformer.init_lm_params(cfg, gen, dev, pdt)

    def init_cache(batch: int, cache_len: int, dtype=None):
        return transformer.init_cache(cfg, batch, cache_len, device=dev,
                                      dtype=dtype or cdt)

    def init_paged_cache(num_blocks: int, block_size: int, dtype=None,
                         num_rows: int = 0):
        return transformer.init_paged_cache(cfg, num_blocks, block_size,
                                            device=dev, dtype=dtype or cdt,
                                            num_rows=num_rows)

    return Model(
        cfg=cfg,
        init=init,
        init_cache=init_cache,
        prefill=functools.partial(transformer.prefill, cfg,
                                  compute_dtype=cdt, serve=serve),
        decode_step=functools.partial(transformer.decode_step, cfg,
                                      compute_dtype=cdt),
        prefill_chunk=functools.partial(transformer.prefill_chunk, cfg,
                                        compute_dtype=cdt),
        init_paged_cache=init_paged_cache,
        decode_step_paged=functools.partial(
            transformer.decode_step_paged, cfg, compute_dtype=cdt),
        prefill_chunk_paged=functools.partial(
            transformer.prefill_chunk_paged, cfg, compute_dtype=cdt),
        clone_paged_block=(transformer.clone_paged_block
                           if caps.prefix_cache else None),
        verify_step_paged=(functools.partial(
            transformer.verify_step_paged, cfg, compute_dtype=cdt)
                           if caps.speculative else None),
        capabilities=caps,
        device=dev,
        dtype=cdt)


def cache_len_for(cfg: ModelConfig, shape: ShapeConfig,
                  serve: ServeConfig) -> int:
    """KV-cache capacity for a decode cell: ring-buffer mode bounds it at
    the sliding window."""
    if serve.ring_buffer and cfg.swa_window > 0:
        return min(shape.seq_len, cfg.swa_window)
    return shape.seq_len
