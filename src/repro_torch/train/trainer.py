"""Trainer of the port: the train step with its three gradient-sync
modes — the port of ``src/repro/train/trainer.py``.

  grad_sync="spmd"        one step on the global batch. The reference
                          jits it over a mesh and XLA inserts the
                          collectives; on one card there is nothing to
                          insert, so with or without a mesh it is the
                          same step, and XLA's collectives have no
                          counterpart here.
  grad_sync="threadcomm"  the explicit trainer over the unified ``Comm``
                          API (``train/explicit.py``): the root
                          ThreadComm's thread_comm / process_comm compose
                          the paper's two-level gradient sync, run as one
                          rank-stacked program over the mesh.
  grad_sync="flat"        the rank-unaware baseline: one root-comm
                          allreduce of the whole flat gradient.

Gradients come from autograd (``torch.autograd.grad`` of
``model.train_loss``); the optimizer is ``optim.adamw_update``, in place
(the reference's step donates its state). ``checkpoint.py`` snapshots
(params, opt, data step) atomically and restores onto any mesh.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.config import MeshConfig, ModelConfig, TrainConfig
from repro_torch.core.compat import P
from repro_torch.dist.sharding import param_pspecs
from repro_torch.interop import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule


class TrainState(NamedTuple):
    params: Any
    opt: Any


def init_train_state(model, seed: int) -> TrainState:
    """Parameters from ``model.init(seed)`` and a fresh AdamW state."""
    params = model.init(seed)
    return TrainState(params=params, opt=adamw_init(params))


def state_pspecs(cfg: ModelConfig, mesh_cfg: MeshConfig, state: TrainState,
                 moe_fsdp: bool = True, fsdp: bool = True):
    """Optimizer state mirrors parameter sharding (ZeRO via FSDP specs)."""
    pspec = param_pspecs(cfg, mesh_cfg, state.params, moe_fsdp=moe_fsdp,
                         fsdp=fsdp)
    return TrainState(
        params=pspec,
        opt=type(state.opt)(step=P(), m=pspec, v=pspec,
                            master=None if state.opt.master is None
                            else pspec))


def value_and_grad(loss_fn, params, batch):
    """(loss, metrics, grads) of ``loss_fn(params, batch)``: the
    parameters enter as detached leaves (no copy) that require grad;
    ``grads`` has the parameters' structure and dtypes."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, tree_leaves(live))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(live, list(grads))


def make_train_step(model, mesh_cfg: MeshConfig, tcfg: TrainConfig,
                    mesh=None):
    """The train step ``step(state, batch) -> (state, metrics)``; batch
    values are tensors on the model's device. With ``mesh`` and
    ``grad_sync`` "threadcomm" or "flat", the explicit trainer
    (``train/explicit.py``); otherwise the one-card step (see the module
    docstring)."""
    lr_fn = cosine_schedule(tcfg.learning_rate, tcfg.warmup_steps,
                            tcfg.total_steps)

    def loss_and_grads(params, batch):
        k = tcfg.microbatches
        if k <= 1:
            return value_and_grad(model.train_loss, params, batch)
        # gradient accumulation over k microbatches: grads accumulate in
        # float32, activations live one microbatch at a time
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        losses, metricss = [], []
        for i in range(k):
            mb = {n: v.reshape(k, v.shape[0] // k, *v.shape[1:])[i]
                  for n, v in batch.items()}
            loss, metrics, grads = value_and_grad(model.train_loss, params,
                                                  mb)
            for a, g in zip(tree_leaves(acc), tree_leaves(grads)):
                a.add_(g.float())
            losses.append(loss)
            metricss.append(metrics)
        grads = tree_map(lambda g: g / k, acc)
        metrics = {n: torch.stack([m[n] for m in metricss]).mean()
                   for n in metricss[0]}
        return torch.stack(losses).mean(), metrics, grads

    if tcfg.grad_sync in ("threadcomm", "flat") and mesh is not None:
        from repro_torch.train.explicit import make_explicit_train_step
        return make_explicit_train_step(model, mesh_cfg, tcfg, mesh)

    def step_fn(state: TrainState, batch):
        _, metrics, grads = loss_and_grads(state.params, batch)
        lr = lr_fn(state.opt.step)
        new_params, new_opt, om = adamw_update(
            grads, state.opt, state.params, lr=lr, beta1=tcfg.beta1,
            beta2=tcfg.beta2, eps=tcfg.eps, weight_decay=tcfg.weight_decay,
            grad_clip=tcfg.grad_clip)
        return TrainState(new_params, new_opt), {**metrics, **om}

    return step_fn


def make_eval_step(model, mesh_cfg: MeshConfig, mesh=None):
    """``eval_step(params, batch) -> metrics``, without gradients."""

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = model.train_loss(params, batch)
        return metrics

    return eval_step
