"""Explicit (threadcomm) trainer: the paper's technique as a training
feature, expressed through the unified ``Comm`` API — the port of
``src/repro/train/explicit.py``.

The step runs as ONE rank-stacked program over the whole mesh
(``core.compat.shard_map``): every (pod, data, model) coordinate is a
rank, every per-rank value carries a leading rank dimension R, and the
model axis is redundant compute, as in the reference's whole-mesh-manual
branch. Each rank computes its gradient on its batch shard with
autograd, in a loop over the ranks (one card runs them in turn anyway),
into one flat float32 vector a rank, ``(R, plen)``.

Gradient sync is the paper's two-level hierarchical schedule, built from
the root comm's derived sub-communicators and fused with a ZeRO-1 flat
optimizer::

    flat_g   = concat(all grad leaves)               # (R, plen) float32
    shard    = thread_comm.reduce_scatter(flat_g)    # fast domain
    with comm.stream("grad"):                        # slow domain, 1/M of
        req  = process_comm.iallreduce(shard)        #   the bytes, on the
    shard    = req.wait()                            #   "grad" CommStream
    shard'   = AdamW(shard)                          # state lives as shards
    params   = unflatten(thread_comm.allgather(shard'))   # fast domain

On the card the "grad" stream is a CUDA stream: entering it makes it
wait for the current stream, which produced ``shard``; ``req.wait()``
makes the current stream wait for the allreduce before the update reads
it. With ``grad_comm_dtype="bfloat16"`` the slow-domain allreduce is the
wire-dtype schedule of ``core.collectives`` (one msgq message round per
recursive-doubling round: one round at two processes); in float32 it is
the native sum.

grad_sync="flat" keeps the same state layout but reduces the FULL flat
vector over the root comm (process x thread) before slicing — the
rank-unaware MPI-everywhere baseline.

The flat order is the reference's leaf order (``interop.named_leaves``:
sorted keys, a layer stack as its (L, ...) leaves, layer-major), so
``opt.master``/``m``/``v`` are element for element the reference's. The
step donates its state, as the reference's jit does (``donate_argnums``):
the optimizer shards are updated in place in the region's copies.

A ``P()`` output of the region takes rank 0's value, unchecked; the step
therefore measures how far every rank's new parameters stand from rank
0's and reports it as the metric ``params_rank_spread`` (0 when the sync
gave every rank the same update; the bf16 wire does not: each rank adds
its own float32 shard to its peer's bfloat16 copy, as in the reference).

The root comm is activated in service mode (``comm.start()`` without a
``with``): the trainer is a long-lived parallel region.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.config import MeshConfig, TrainConfig
from repro_torch.core.comm import threadcomm_init
from repro_torch.core.compat import P, rank_view, shard_map
from repro_torch.dist.sharding import batch_pspec
from repro_torch.interop import tree_leaves, tree_unflatten
from repro_torch.optim import cosine_schedule


class FlatAdamState(NamedTuple):
    step: torch.Tensor    # 0-d int32
    m: torch.Tensor       # (padded_len,) float32: the thread shards
    v: torch.Tensor
    master: torch.Tensor  # float32 master


class ExplicitTrainState(NamedTuple):
    params: Any           # model dtype, replicated over the ranks
    opt: FlatAdamState


def flatten_tree(tree) -> torch.Tensor:
    """Every leaf, float32, concatenated in the reference's flat order."""
    return torch.cat([t.reshape(-1).float() for t in tree_leaves(tree)])


def unflatten_like(flat: torch.Tensor, tree, dtype_from_tree: bool = True):
    """``flat`` cut into ``tree``'s leaves (the reference's order), each
    cast to its leaf's dtype unless ``dtype_from_tree`` is False."""
    out, off = [], 0
    for t in tree_leaves(tree):
        n = t.numel()
        piece = flat[off:off + n].reshape(t.shape)
        out.append(piece.to(t.dtype) if dtype_from_tree else piece)
        off += n
    return tree_unflatten(tree, out)


def padded_len(tree, dp: int) -> int:
    n = sum(t.numel() for t in tree_leaves(tree))
    return ((n + dp - 1) // dp) * dp


def init_explicit_state(model, seed: int, dp: int) -> ExplicitTrainState:
    """Parameters from ``model.init(seed)``; the full flat optimizer
    vectors (the step splits them over the thread axes)."""
    params = model.init(seed)
    plen = padded_len(params, dp)
    flat = flatten_tree(params)
    flat = F.pad(flat, (0, plen - flat.numel()))
    z = torch.zeros((plen,), dtype=torch.float32, device=flat.device)
    return ExplicitTrainState(
        params=params,
        opt=FlatAdamState(step=torch.zeros((), dtype=torch.int32,
                                           device=flat.device),
                          m=z, v=z.clone(), master=flat))


def _rank_grads(model, params_r: List[torch.Tensor], template, batch, R):
    """Each rank's flat float32 gradient and metrics on its batch shard:
    (R rows of the used length, metrics {name: (R,)})."""
    rows, metricss = [], []
    for r in range(R):
        live = [p[r].detach().requires_grad_(True) for p in params_r]
        with torch.enable_grad():
            loss, metrics = model.train_loss(
                tree_unflatten(template, live),
                {k: v[r] for k, v in batch.items()})
            grads = torch.autograd.grad(loss, live)
        rows.append(torch.cat([g.reshape(-1).float() for g in grads]))
        del grads
        metricss.append({k: v.detach() for k, v in metrics.items()})
    metrics = {k: torch.stack([m[k] for m in metricss]) for k in metricss[0]}
    return rows, metrics


def make_explicit_train_step(model, mesh_cfg: MeshConfig, tcfg: TrainConfig,
                             mesh):
    """The explicit step ``step(state, batch) -> (state, metrics)`` over
    ``mesh`` (a ``core.compat.Mesh``; see the module docstring). Batch
    values are the global batch (tensors or arrays); metrics are 0-d
    tensors, the mean over the data-parallel ranks."""
    lr_fn = cosine_schedule(tcfg.learning_rate, tcfg.warmup_steps,
                            tcfg.total_steps)
    proc_axes = tuple(mesh_cfg.process_axes)
    thread_axes = tuple(mesh_cfg.batch_axes)

    # the root communicator over the unified DP rank space; thread_comm /
    # process_comm are the derived sub-comms of the two-level schedule.
    # Service-mode activation: the trainer IS the parallel region.
    comm = threadcomm_init(mesh, process_axes=proc_axes,
                           thread_axes=thread_axes)
    comm.start()
    tcomm = comm.thread_comm()
    pcomm = comm.process_comm()
    dp = comm.size
    m_thread = comm.threads_per_process
    wire = torch.bfloat16 if tcfg.grad_comm_dtype == "bfloat16" else None
    shard_spec = P(thread_axes) if thread_axes else P()
    keys: List[str] = []

    @torch.no_grad()
    def inner(template, names, n_b, *args):
        batch = dict(zip(names, args[:n_b]))
        params_r = list(args[n_b:-4])
        step, m, v, master = args[-4:]
        R = step.shape[0]
        rows, metrics = _rank_grads(model, params_r, template, batch, R)
        shard_len = m.shape[1]
        plen = shard_len * m_thread              # global padded length
        flat_g = torch.zeros((R, plen), dtype=torch.float32,
                             device=m.device)
        for r, row in enumerate(rows):
            flat_g[r, :row.numel()] = row
        del rows

        if tcfg.grad_sync == "flat":
            # rank-unaware: full bytes cross every domain, then the slice
            full = comm.allreduce(flat_g)
            del flat_g
            rank = tcomm.local_rank()
            g_shard = full.reshape(R, m_thread, shard_len)[
                torch.arange(R, device=m.device), rank] / dp
            del full
        else:     # "threadcomm": hierarchical two-level via derived comms
            g_shard = (tcomm.reduce_scatter(flat_g) if tcomm.size > 1
                       else flat_g)
            del flat_g
            if pcomm.size > 1:
                # nonblocking slow-domain sync on the "grad" stream; the
                # wire dtype compresses the inter-process bytes
                with comm.stream("grad"):
                    req = pcomm.iallreduce(g_shard, wire_dtype=wire)
                g_shard = req.wait()
            g_shard = g_shard / dp

        # global grad-norm from the shards (for clipping)
        gn2 = g_shard.square().sum(dim=1)
        if tcomm.size > 1:
            gn2 = tcomm.allreduce(gn2)
        gnorm = torch.sqrt(gn2)
        scale = (torch.clamp(tcfg.grad_clip / (gnorm + 1e-9), max=1.0)
                 if tcfg.grad_clip > 0 else torch.ones_like(gnorm))

        # fused flat AdamW on the shard (ZeRO-1), in place in the
        # region's copies of the state (the step donates them)
        new_step = step + 1
        t = new_step.to(torch.float32)
        g = g_shard * rank_view(scale, g_shard)
        del g_shard
        m.copy_(tcfg.beta1 * m + (1 - tcfg.beta1) * g)
        v.copy_(tcfg.beta2 * v + (1 - tcfg.beta2) * g.square())
        del g
        mhat = m / rank_view(1 - tcfg.beta1 ** t, m)
        vhat = v / rank_view(1 - tcfg.beta2 ** t, v)
        lr = lr_fn(step)
        upd = mhat / (torch.sqrt(vhat) + tcfg.eps)
        del mhat, vhat
        master.copy_(master - rank_view(lr, master) * (
            upd + tcfg.weight_decay * master))
        del upd

        # fast-domain allgather of the UPDATED parameters, cast first to
        # the first leaf's dtype (move bf16, not f32)
        cast = master.to(params_r[0].dtype)
        full_new = (tcomm.allgather(cast, tiled=True) if tcomm.size > 1
                    else cast)
        del cast
        spread = torch.zeros((), dtype=torch.float32, device=m.device)
        for r in range(1, R):
            spread = torch.maximum(spread, (full_new[r].float()
                                            - full_new[0].float()
                                            ).abs().max())
        new_params, off = [], 0
        for p in params_r:
            n = p[0].numel()
            new_params.append(full_new[:, off:off + n].float().reshape(
                p.shape).to(p.dtype))
            off += n

        metrics = {**metrics, "grad_norm": gnorm, "lr": lr}
        keys[:] = list(metrics)
        stats = torch.stack([comm.allreduce(metrics[k].float()) / dp
                             for k in keys], dim=1)          # (R, n)
        stats = torch.cat([stats, spread.expand(R, 1)], dim=1)
        return (*new_params, new_step, m, v, master, stats)

    def step(state: ExplicitTrainState, batch):
        template = state.params
        params = tree_leaves(template)
        names = sorted(batch)
        args = [batch[k] for k in names] + params + list(state.opt)
        in_specs = ((batch_pspec(mesh_cfg),) * len(names)
                    + (P(),) * (len(params) + 1) + (shard_spec,) * 3)
        out_specs = ((P(),) * (len(params) + 1) + (shard_spec,) * 3
                     + (P(),))
        out = shard_map(
            lambda *a: inner(template, names, len(names), *a), mesh=mesh,
            in_specs=in_specs, out_specs=out_specs)(*args)
        n = len(params)
        # own storage: a P() output is a view of the gathered (R, plen)
        new_params = tree_unflatten(template, [t.clone() for t in out[:n]])
        new_step, m, v, master, stats = out[n:]
        metrics = {k: stats[i] for i, k in enumerate(keys)}
        metrics["params_rank_spread"] = stats[len(keys)]
        return (ExplicitTrainState(
            params=new_params,
            opt=FlatAdamState(step=new_step, m=m, v=v, master=master)),
            metrics)

    step.comm = comm
    return step
