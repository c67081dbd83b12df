"""Sharding rules: ``core.compat.P`` spec trees for params, caches and
batches — the port of ``src/repro/dist/sharding.py``, rule for rule.

One place owns the mapping from (ModelConfig, MeshConfig) to layout:

  * tensor parallelism (Megatron-style): attention heads, MLP hidden dim
    and the vocab dim over ``mesh_cfg.model_axes``;
  * FSDP / ZeRO: the remaining large dim of each weight over
    ``mesh_cfg.batch_axes`` (optimizer state mirrors it — see
    ``train/trainer.py`` ``state_pspecs``);
  * MoE expert weights additionally shard the expert dim over the batch
    axes (``moe_fsdp``);
  * batches shard their leading dim over process axes x batch axes in
    process-major order — the unified-rank order of the threadcomm layer.

Every rule is guarded by divisibility, and keys off leaf names. The
trees follow the port's layout: a layer stack is a list of per-layer
dicts, so a rule applies to a layer's own (unstacked) leaf; the slot
cache keeps the reference's stacked ``(L, B, ...)`` leaves. There is no
NamedSharding on one card: the region (``core.compat.shard_map``) reads
the batch spec, splitting dim 0 only; the parameter and cache specs are
data (what the reference would lay out on a mesh of devices).
"""

from __future__ import annotations

import math
from typing import Any, Tuple

from repro_torch.config import MeshConfig, ModelConfig
from repro_torch.core.compat import P


def _axis_sizes(mesh_cfg: MeshConfig) -> dict:
    return dict(zip(mesh_cfg.axis_names, mesh_cfg.shape))


def _axes_prod(mesh_cfg: MeshConfig, axes: Tuple[str, ...]) -> int:
    sizes = _axis_sizes(mesh_cfg)
    return math.prod(sizes[a] for a in axes) if axes else 1


def _axes_or_none(axes: Tuple[str, ...]):
    """A spec entry: tuple for multi-axis dims, name for one, None for
    zero."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def batch_axes(mesh_cfg: MeshConfig):
    """Mesh axes of the batch dim: process-major over (process_axes,
    batch_axes) — the unified-rank order."""
    return _axes_or_none(tuple(mesh_cfg.process_axes)
                         + tuple(mesh_cfg.batch_axes))


def batch_pspec(mesh_cfg: MeshConfig) -> P:
    """Spec for data batches: leading dim over the full data-parallel
    domain (slow process axes major, fast batch axes minor)."""
    ax = batch_axes(mesh_cfg)
    return P() if ax is None else P(ax)


def _map_with_names(fn, tree, names=()):
    """``fn(names, leaf)`` over the tensors of a port tree; ``names`` is
    the path of dict keys down to the leaf (list indices skipped, so a
    layer's leaf sees the reference's stacked path)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_names(fn, v, names + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_names(fn, v, names) for v in tree)
    return fn(names, tree)


# name -> (tp_dim, fsdp_dim) in the unstacked leaf shape; fsdp_dim None
# means the leaf never FSDP-shards (biases, norms, small vectors)
_DENSE_RULES = {
    "wq": (1, 0), "wk": (1, 0), "wv": (1, 0),   # (d, H, hd): heads on TP
    "wo": (0, 2),                                # (H, hd, d)
    "bq": (0, None), "bk": (0, None), "bv": (0, None),   # (H, hd)
    "w_gate": (1, 0), "w_up": (1, 0),            # (d, f): hidden on TP
    "w_down": (0, 1),                            # (f, d)
    "embed": (0, 1),                             # (V, d): vocab-parallel
    "lm_head": (1, 0),                           # (d, V)
    "dec_pos": (None, 1),                        # (maxpos, d)
    "in_proj": (1, 0),                           # (d, 2di+2n+h)
    "out_proj": (0, 1),                          # (di, d)
}
# MoE expert weights carry a leading expert dim: (E, d, f) / (E, f, d)
_MOE_RULES = {
    "w_gate": (2, 1), "w_up": (2, 1),
    "w_down": (1, 2),
}


def param_pspecs(cfg: ModelConfig, mesh_cfg: MeshConfig, params: Any,
                 *, moe_fsdp: bool = True, fsdp: bool = True):
    """Spec tree matching ``params`` (the port's tree of tensors): TP over
    ``model_axes``; FSDP over ``batch_axes`` when enabled and divisible;
    MoE experts over the batch axes when ``moe_fsdp``. Anything unmatched
    is replicated. A layer's leaf is ruled on its own shape (the
    reference's stacked leaf less its L dim)."""
    tp_axes = tuple(mesh_cfg.model_axes)
    dp_axes = tuple(mesh_cfg.batch_axes)
    tp = _axes_prod(mesh_cfg, tp_axes)
    dp = _axes_prod(mesh_cfg, dp_axes)

    def spec_for(names, leaf) -> P:
        name = names[-1] if names else ""
        shape = tuple(leaf.shape)
        moe = "moe" in names[:-1]
        rule = (_MOE_RULES if moe else _DENSE_RULES).get(name)
        if rule is None:
            return P()
        tp_dim, fsdp_dim = rule
        entries = [None] * len(shape)
        if (tp_dim is not None and tp > 1 and tp_dim < len(shape)
                and shape[tp_dim] % tp == 0):
            entries[tp_dim] = _axes_or_none(tp_axes)
        if (fsdp and fsdp_dim is not None and dp > 1
                and fsdp_dim < len(shape) and shape[fsdp_dim] % dp == 0):
            entries[fsdp_dim] = _axes_or_none(dp_axes)
        # MoE expert dim over the batch axes (expert parallelism as FSDP)
        if (moe and moe_fsdp and dp > 1 and shape and shape[0] % dp == 0
                and entries[0] is None):
            entries[0] = _axes_or_none(dp_axes)
        while entries and entries[-1] is None:
            entries.pop()
        return P(*entries)

    return _map_with_names(spec_for, params)


def cache_pspecs(cfg: ModelConfig, mesh_cfg: MeshConfig, cache: Any):
    """Specs for a stacked (L, B, ...) slot-cache tree: the batch dim over
    the data-parallel domain, kv heads over TP when they divide; the
    position rows are replicated."""
    tp_axes = tuple(mesh_cfg.model_axes)
    tp = _axes_prod(mesh_cfg, tp_axes)
    dp_all = tuple(mesh_cfg.process_axes) + tuple(mesh_cfg.batch_axes)
    dp = _axes_prod(mesh_cfg, dp_all)
    b_ax = _axes_or_none(dp_all)

    def spec_for(names, leaf) -> P:
        name = names[-1]
        shape = tuple(leaf.shape)
        if name == "pos" or len(shape) < 2:
            return P()
        entries = [None] * len(shape)
        if dp > 1 and shape[1] % dp == 0:
            entries[1] = b_ax
        # kv / state head dims: (L, B, S, G, hd) or (L, B, H, p, n)
        head_dim = {"k": 3, "v": 3, "cross_k": 3, "cross_v": 3,
                    "ssm": 2}.get(name)
        if (head_dim is not None and tp > 1 and head_dim < len(shape)
                and shape[head_dim] % tp == 0):
            entries[head_dim] = _axes_or_none(tp_axes)
        while entries and entries[-1] is None:
            entries.pop()
        return P(*entries)

    return _map_with_names(spec_for, cache)
