"""AdamW on the port's parameter trees, mixed-precision aware: the port of
``src/repro/optim/adamw.py``, term for term.

State keeps float32 first/second moments plus a float32 master copy of
the parameters when any parameter is not float32 (bf16 models). Every
state leaf mirrors the parameter tree (dicts, with per-layer lists).
These are plain tensor functions, not ``torch.optim``: the update is the
reference's arithmetic, leaf by leaf.

The update is in place: the reference's step donates its state, so the
port writes each leaf's new moments, master and parameter into the
tensors it was given (computed out of place, then copied), and a bf16
model never holds two copies of its optimizer state.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.interop import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor   # 0-d int32
    m: Any
    v: Any
    master: Any          # float32 master params (None if the model is f32)


def adamw_init(params) -> AdamWState:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    leaves = tree_leaves(params)
    needs_master = any(p.dtype != torch.float32 for p in leaves)
    master = (tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                       params) if needs_master else None)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
        m=zeros, v=tree_map(torch.clone, zeros), master=master)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares."""
    sums = [g.float().square().sum() for g in tree_leaves(tree)]
    return torch.sqrt(torch.stack(sums).sum())


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr, beta1=0.9,
                 beta2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=1.0):
    """One AdamW step, in place (see the module docstring). Returns
    (params, new_state, metrics) with the same tensors updated."""
    gnorm = global_norm(grads)
    scale = (torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
             if grad_clip > 0 else torch.ones_like(gnorm))
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - beta1 ** t
    bc2 = 1.0 - beta2 ** t
    lr_t = torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)

    flat_g = tree_leaves(grads)
    flat_m, flat_v = tree_leaves(state.m), tree_leaves(state.v)
    flat_p = tree_leaves(params)
    flat_master = (tree_leaves(state.master) if state.master is not None
                   else [None] * len(flat_p))
    for g, m, v, p, master in zip(flat_g, flat_m, flat_v, flat_p,
                                  flat_master):
        g = g.float() * scale
        m.copy_(beta1 * m + (1 - beta1) * g)
        v.copy_(beta2 * v + (1 - beta2) * g.square())
        mhat = m / bc1
        vhat = v / bc2
        base = master if master is not None else p.float()
        new = base - lr_t * (mhat / (torch.sqrt(vhat) + eps)
                             + weight_decay * base)
        if master is not None:
            master.copy_(new)
        p.copy_(new.to(p.dtype))
    new_state = AdamWState(step=step, m=state.m, v=state.v,
                           master=state.master)
    return params, new_state, {"grad_norm": gnorm, "lr": lr_t}
