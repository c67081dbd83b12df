"""Parameter and cache bridge from the JAX reference to the port.

``jax.random`` init cannot be reproduced in PyTorch, so the tests make
both sides compute the same function by moving the reference's
parameters (and, for the cached steps, its slot cache) over, as numpy
arrays. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.config import (BLOCK_DENSE, BLOCK_HYBRID, BLOCK_SSM,
                                ModelConfig)

#: the SSM leaves of a block (``models/mamba.py:init_ssm``)
_SSM_LEAVES = ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias",
               "gate_norm", "out_proj")
#: leaves the port keeps in float32 whatever the parameter dtype, as the
#: reference does
_F32_LEAVES = ("A_log", "D", "dt_bias")


def _t(a, device, dtype) -> torch.Tensor:
    # np.array copies: the reference's arrays are read-only views
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        device=device, dtype=dtype)


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, *,
                      device="cpu", dtype=torch.float32) -> Dict[str, Any]:
    """The reference's parameter pytree (numpy leaves) -> the port's, for
    the dense, SSM and hybrid families.

    In the reference tree ``embed`` is ``(Vp, d)``, ``final_norm.w`` a norm
    weight, and ``blocks.*`` is stacked on a leading ``L`` axis:
    ``ln1.w``; with attention ``attn.{wq (d,H,hd), wk/wv (d,Hkv,hd), wo
    (H,hd,d)}``; with an SSM ``ssm.{in_proj, conv_w, conv_b, A_log, D,
    dt_bias, gate_norm, out_proj}`` (``A_log``, ``D`` and ``dt_bias``
    float32); the hybrid block's ``attn_out_norm`` and ``ssm_out_norm``
    (bare ``(d,)`` weights); and for the dense and hybrid blocks ``ln2.w``
    and ``mlp.{w_gate, w_up (d,f), w_down (f,d)}``. The port keeps the
    same leaves and layouts, with ``blocks`` a list of per-layer dicts."""
    if cfg.block not in (BLOCK_DENSE, BLOCK_SSM, BLOCK_HYBRID):
        raise NotImplementedError(f"block family {cfg.block!r} is not "
                                  "ported")
    blocks = tree["blocks"]
    out: Dict[str, Any] = {
        "embed": _t(tree["embed"], device, dtype),
        "final_norm": {"w": _t(tree["final_norm"]["w"], device, dtype)},
        "blocks": [],
    }
    for i in range(cfg.num_layers):
        blk: Dict[str, Any] = {
            "ln1": {"w": _t(blocks["ln1"]["w"][i], device, dtype)}}
        if "attn" in blocks:
            blk["attn"] = {k: _t(blocks["attn"][k][i], device, dtype)
                           for k in ("wq", "wk", "wv", "wo")}
        if "ssm" in blocks:
            blk["ssm"] = {k: _t(blocks["ssm"][k][i], device,
                                torch.float32 if k in _F32_LEAVES else dtype)
                          for k in _SSM_LEAVES}
        for k in ("attn_out_norm", "ssm_out_norm"):
            if k in blocks:
                blk[k] = _t(blocks[k][i], device, dtype)
        if "mlp" in blocks:
            blk["ln2"] = {"w": _t(blocks["ln2"]["w"][i], device, dtype)}
            blk["mlp"] = {k: _t(blocks["mlp"][k][i], device, dtype)
                          for k in ("w_gate", "w_up", "w_down")}
        out["blocks"].append(blk)
    if "lm_head" in tree:
        out["lm_head"] = _t(tree["lm_head"], device, dtype)
    return out


def slot_cache_from_numpy(cache: Dict[str, Any], *, device="cpu",
                          dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The reference's slot cache (numpy leaves) -> the port's.

    The reference's cache of ``B`` rows holds ``k``/``v`` ``(L, B, W, Gs,
    hd)`` and one position row per layer, ``pos`` ``(L, W)``, shared by the
    rows. The port's adds the scratch column (zeros in k/v, -1 in pos) and
    keeps one position row per cache row: ``pos`` ``(B, W + 1)``. Every
    layer of a reference cache holds the same positions; a cache whose
    layers differ is refused. The carried-state leaves ``conv`` ``(L, B,
    k-1, conv_dim)`` and ``ssm`` ``(L, B, h, p, n)`` (float32) carry over
    as they are; an attention-free cache has no k/v/pos."""
    out = {}
    if "conv" in cache:
        out["conv"] = _t(cache["conv"], device, dtype)
        out["ssm"] = _t(cache["ssm"], device, torch.float32)
    if "k" not in cache:
        return out
    pos = np.asarray(cache["pos"])
    if not (pos == pos[0]).all():
        raise ValueError("the reference cache's layers hold different "
                         "positions")
    k = np.asarray(cache["k"], np.float32)
    L_, B, W, gs, hd = k.shape
    for name in ("k", "v"):
        buf = np.zeros((L_, B, W + 1, gs, hd), np.float32)
        buf[:, :, :W] = np.asarray(cache[name], np.float32)
        out[name] = torch.from_numpy(buf).to(device=device, dtype=dtype)
    rows = np.full((B, W + 1), -1, np.int32)
    rows[:, :W] = pos[0]
    out["pos"] = torch.from_numpy(rows).to(device)
    return out
