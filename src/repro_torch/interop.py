"""Parameter and cache bridge between the JAX reference and the port.

``jax.random`` init cannot be reproduced in PyTorch, so the tests make
both sides compute the same function by moving the reference's
parameters (and, for the cached steps, its slot cache) over, as numpy
arrays. The other direction (:func:`tree_to_numpy`) carries the port's
parameters or gradients back as the reference's stacked tree, so they
compare leaf by leaf.

The reference stacks each layer's leaves on a leading ``L`` axis; the
port keeps a list of per-layer dicts. :func:`named_leaves` walks a port
tree in the reference's flat leaf order — dict keys sorted, a
NamedTuple by its fields, a layer stack as its ``(L, ...)`` leaves,
layer-major — naming each leaf by the reference's tree path. The flat
optimizer vector (``train.explicit.flatten_tree``), the checkpoint's
names and :func:`tree_leaves` all follow it. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple

import numpy as np
import torch

from repro_torch.config import ModelConfig

#: leaves the port keeps in float32 whatever the parameter dtype, as the
#: reference does (the SSM's decay, skip and step bias; the MoE router)
_F32_LEAVES = ("A_log", "D", "dt_bias", "router")


def _t(a, device, dtype) -> torch.Tensor:
    # np.array copies: the reference's arrays are read-only views
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        device=device, dtype=dtype)


def _layer(tree, i, device, dtype):
    """Layer ``i`` of a stacked (L, ...) subtree: the same nesting, each
    leaf's slice ``[i]`` as a tensor (float32 leaves stay float32)."""
    if isinstance(tree, dict):
        return {k: (_layer(v, i, device, torch.float32)
                    if k in _F32_LEAVES else _layer(v, i, device, dtype))
                for k, v in tree.items()}
    return _t(tree[i], device, dtype)


def _leaves(tree, device, dtype):
    """An unstacked subtree (a norm's ``w``/``b``) as tensors."""
    if isinstance(tree, dict):
        return {k: _leaves(v, device, dtype) for k, v in tree.items()}
    return _t(tree, device, dtype)


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, *,
                      device="cpu", dtype=torch.float32) -> Dict[str, Any]:
    """The reference's parameter pytree (numpy leaves) -> the port's, for
    every family.

    Decoder-only: ``embed`` ``(Vp, d)``, ``final_norm`` (``w``, and ``b``
    for a LayerNorm), optional ``lm_head`` ``(d, Vp)``, and ``blocks.*``
    stacked on a leading ``L`` axis: ``ln1``; with attention
    ``attn.{wq (d,H,hd), wk/wv (d,Hkv,hd), wo (H,hd,d)}`` plus ``bq (H,hd)``,
    ``bk``/``bv (Hkv,hd)`` with ``qkv_bias`` and ``q_norm``/``k_norm
    (hd,)`` with ``qk_norm``; with an SSM ``ssm.{in_proj, conv_w, conv_b,
    A_log, D, dt_bias, gate_norm, out_proj}`` (``A_log``, ``D`` and
    ``dt_bias`` float32); the hybrid block's ``attn_out_norm`` and
    ``ssm_out_norm``; ``ln2`` and ``mlp.{w_gate, w_up (d,f), w_down
    (f,d)}`` (dense, hybrid) or ``moe.{router (d,E) float32, w_gate/w_up
    (E,d,f), w_down (E,f,d)}`` (MoE). Encoder-decoder: ``embed``,
    ``dec_pos (max_pos, d)``, stacked ``enc_blocks`` (ln1, attn, ln2,
    mlp) and ``dec_blocks`` (the same plus ``ln_x`` and ``xattn``),
    ``enc_norm``, ``final_norm`` and ``lm_head``. The port keeps the same
    leaves and layouts, with each stack a list of per-layer dicts."""
    out: Dict[str, Any] = {}
    stacks = (("enc_blocks", cfg.num_encoder_layers),
              ("dec_blocks", cfg.num_layers)) if cfg.is_encoder_decoder \
        else (("blocks", cfg.num_layers),)
    for name, n in stacks:
        out[name] = [_layer(tree[name], i, device, dtype) for i in range(n)]
    for name in ("embed", "dec_pos", "lm_head", "final_norm", "enc_norm"):
        if name in tree:
            out[name] = _leaves(tree[name], device, dtype)
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
    as they are, as do an encoder-decoder's ``cross_k``/``cross_v`` ``(L,
    B, encoder_seq, Hkv, hd)``; an attention-free cache has no
    k/v/pos."""
    out = {}
    if "conv" in cache:
        out["conv"] = _t(cache["conv"], device, dtype)
        out["ssm"] = _t(cache["ssm"], device, torch.float32)
    for name in ("cross_k", "cross_v"):
        if name in cache:
            out[name] = _t(cache[name], device, dtype)
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


# ---------------------------------------------------------------------------
# The port's trees in the reference's leaf order
# ---------------------------------------------------------------------------

#: tree keys whose value is a layer stack: the reference's stacked
#: ``(L, ...)`` subtree, the port's list of per-layer dicts
STACKED_KEYS = ("blocks", "enc_blocks", "dec_blocks")


class Leaf(NamedTuple):
    """One leaf of the reference's tree: its path name, the port's
    tensors that make it (one per layer for a stacked leaf, else one),
    and whether it is stacked."""
    name: str
    tensors: List[torch.Tensor]
    stacked: bool


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """(name, child) of a dict (keys sorted), a NamedTuple (fields in
    order) or a list/tuple (indices), in the reference's order."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f, getattr(node, f)) for f in node._fields]
    return [(str(i), v) for i, v in enumerate(node)]


# The walks are module-level functions that take ``out``: a nested
# function that calls itself is a function <-> cell reference cycle,
# which would keep ``out`` (every tensor of the tree) alive until the
# cyclic collector runs.
def _walk_stack(layers, node, path, sub, out: List[Leaf]) -> None:
    """Append to ``out`` the leaves of a layer stack: each path ``sub``
    of layer 0's subtree ``node``, gathered across the layers."""
    if isinstance(node, (dict, list, tuple)):
        for k, v in _children(node):
            _walk_stack(layers, v, path, sub + (k,), out)
    elif node is not None:
        ts = []
        for layer in layers:
            for k in sub:
                layer = layer[int(k) if isinstance(layer, (list, tuple))
                              else k]
            ts.append(layer)
        out.append(Leaf("/".join(path + sub), ts, True))


def _walk(node, path, out: List[Leaf]) -> None:
    """Append to ``out`` the leaves of ``node`` at ``path``."""
    if node is None:
        return
    if isinstance(node, (dict, list, tuple)):
        for k, v in _children(node):
            if (k in STACKED_KEYS and isinstance(node, dict)
                    and isinstance(v, list) and v):
                _walk_stack(v, v[0], path + (k,), (), out)
            else:
                _walk(v, path + (k,), out)
    else:
        out.append(Leaf("/".join(path), [node], False))


def named_leaves(tree) -> List[Leaf]:
    """Every leaf of a port tree (dicts, NamedTuples, lists, tensors;
    None is an empty subtree) in the reference's flat order."""
    out: List[Leaf] = []
    _walk(tree, (), out)
    return out


def tree_leaves(tree) -> List[torch.Tensor]:
    """The port's tensors of a tree in the reference's flat order (a
    stacked leaf's layers in turn)."""
    return [t for leaf in named_leaves(tree) for t in leaf.tensors]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the tensors of ``tree`` (and the matching tensors of
    ``rest``), keeping the structure; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(template, leaves: List[torch.Tensor]):
    """``template``'s structure with its tensors replaced, in the order of
    :func:`tree_leaves`, by ``leaves`` (every tensor of ``template`` a
    distinct object)."""
    old = tree_leaves(template)
    if len(old) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves for a tree of {len(old)}")
    new = {id(t): n for t, n in zip(old, leaves)}
    return tree_map(lambda t: new[id(t)], template)


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.numpy()


def tree_to_numpy(tree) -> Dict[str, Any]:
    """A port tree (parameters or gradients) -> the reference's nested
    dict of numpy arrays: each layer stack as stacked ``(L, ...)`` leaves,
    bfloat16 widened to float32 (numpy has no bfloat16)."""
    out: Dict[str, Any] = {}
    for leaf in named_leaves(tree):
        arr = (np.stack([_numpy(t) for t in leaf.tensors]) if leaf.stacked
               else _numpy(leaf.tensors[0]))
        node = out
        *head, last = leaf.name.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = arr
    return out
