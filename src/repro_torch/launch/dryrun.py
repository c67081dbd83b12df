"""Multi-pod dry run on ``meta`` tensors — the port of
``src/repro/launch/dryrun.py``.

The reference lowers and compiles each cell (arch x shape x mesh) on 512
placeholder host devices and reads XLA's analyses. The port builds the
same cell's step on the ``meta`` device, so no memory is touched and no
device is needed, and counts it (``roofline/analysis.py``):

* FLOPs under ``FlopCounterMode`` and the peak of live bytes under
  ``LiveBytes``, from traces of the step at a few layers, extrapolated
  linearly to the config's depth (the reference's XLA counts a
  ``lax.scan`` body once; an eager trace of 80 layers of the 64 x 64
  chunk pairs of ``prefill_32k`` would take minutes; a serving step is
  traced at 0 and 1 layers, a train step at 1 and 2): every layer of a
  config has one structure, so the count is exactly linear in the depth
  (whisper's encoder and decoder depths apart). A train step is traced
  at one device's microbatch, a serving step at one sequence; the FLOPs
  scale exactly with the batch (every sequence, and every MoE routing
  group of training, is counted alike). The live temporaries of a train
  step are fitted in the depth (each layer adds its saved input and its
  gradient) and divided over the model axes as the cell's layout shards
  them (``temp_bytes``); a serving step's layers reuse one layer's
  working set, so its traced peak is scaled to the device's sequences
  and divided over the model axes, its attention share (traced alone)
  only where the heads divide them;
* argument bytes per device from the spec trees of ``dist/sharding.py``
  and ``train/trainer.py``;
* collectives modelled from the same specs and the cell's layout (FSDP
  gathers, gradient reduce-scatters, the tensor-parallel all-reduces,
  or under sequence parallelism their reduce-scatters and all-gathers,
  a serving step's gathers of its replicated logits, the explicit
  trainer's schedule).

The layout is the reference's ``act_mode``: under ``"sp"`` (its
default) a train cell's residual stream is sharded by sequence over the
model axis where the sequence divides it (``sequence_parallel``), under
``"none"`` it is replicated there. ``run_cell`` keeps the reference's
signature, so its artifacts are always ``"sp"``; ``build_cell(...,
act_mode=)`` then ``analyze_cell`` reaches the other layout.

Nothing runs on the card. The cells are the reference's: every
architecture x the four shapes (``long_500k`` only where
``shape_applicable`` allows it) x ``single_pod`` / ``multi_pod``, with
its ``TrainConfig`` choices. The step is the one the reference compiles:
the spmd train step (remat, microbatches), the slot ``prefill`` and
``decode_step``; the models take their plain path off the card, and
prefill's SSD scan is the plain chunked scan (the kernel wrappers raise
on ``meta``). An explicit ``--grad-sync`` traces the same gradient
without remat, as the reference's explicit cell measures it, and models
its schedule.

Run:  PYTHONPATH=src python -m repro_torch.launch.dryrun --smoke \\
          --arch gemma-2b --shape train_4k        # or --all --mesh both
Artifacts land under ``build/dryrun/<mesh>/`` (``REPRO_TORCH_ARTIFACT_DIR``
moves them); ``python -m repro_torch.roofline.report`` renders them.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time
import traceback
from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import (MESHES, SHAPES, ModelConfig, ServeConfig,
                                ShapeConfig, TrainConfig, shape_applicable)
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.core.compat import P
from repro_torch.dist.sharding import batch_pspec, cache_pspecs, param_pspecs
from repro_torch.models import encdec, transformer
from repro_torch.models.layers import dtype_of
from repro_torch.models.registry import (_knobs, batch_spec, build_model,
                                         cache_len_for)
from repro_torch.roofline import analysis as A
from repro_torch.roofline.report import artifact_dir
from repro_torch.train.explicit import ExplicitTrainState, FlatAdamState
from repro_torch.train.trainer import (TrainState, make_train_step,
                                       state_pspecs)

META = torch.device("meta")


# ---------------------------------------------------------------------------
# The cell's trees on meta
# ---------------------------------------------------------------------------

def meta_params(cfg: ModelConfig, dtype: torch.dtype):
    """The model's parameter tree on ``meta``: the init functions' shapes
    and dtypes, no memory (the draws go through a CPU generator, which
    ``meta`` accepts; the model's ``init`` seeds a generator on its own
    device, and ``meta`` has none)."""
    gen = torch.Generator()
    if cfg.is_encoder_decoder:
        return encdec.init_encdec_params(cfg, gen, META, dtype)
    return transformer.init_lm_params(cfg, gen, META, dtype)


def meta_like(tree, dtype=None):
    """A tree of fresh ``meta`` tensors shaped as ``tree``'s."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=dtype or tree.dtype,
                           device=META)
    if isinstance(tree, dict):
        return {k: meta_like(v, dtype) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(meta_like(v, dtype) for v in tree))
    return type(tree)(meta_like(v, dtype) for v in tree)


def meta_batch(cfg: ModelConfig, shape: ShapeConfig, compute_dtype: str):
    return {k: torch.empty(s.shape, dtype=s.dtype, device=META)
            for k, s in batch_spec(cfg, shape, compute_dtype).items()}


def _at_depth(cfg: ModelConfig, depth: Tuple[int, int]) -> ModelConfig:
    """``cfg`` with ``depth = (layers, encoder layers)``."""
    kw = {"num_layers": depth[0]}
    if cfg.is_encoder_decoder:
        kw["num_encoder_layers"] = depth[1]
    return dataclasses.replace(cfg, **kw)


def _strip_batch_axes(spec_tree, batch_dims):
    """Replace the batch-dim axis with None (for shapes whose global batch
    does not divide the dp degree, e.g. long_500k's batch=1)."""
    if isinstance(spec_tree, P):
        parts = list(spec_tree)
        for i in batch_dims:
            if i < len(parts):
                parts[i] = None
        return P(*parts)
    if isinstance(spec_tree, dict):
        return {k: _strip_batch_axes(v, batch_dims)
                for k, v in spec_tree.items()}
    return spec_tree


def sequence_parallel(shape: ShapeConfig, mesh_cfg, act_mode: str) -> bool:
    """Whether a cell's residual stream is sharded by sequence over the
    model axis, as the reference's ``build_cell`` lays it out
    (``src/repro/launch/dryrun.py:120-127``): a train cell under
    ``act_mode="sp"`` with a model axis, a batch that divides the
    data-parallel degree and a sequence that divides the model axis."""
    tp = mesh_cfg.tp
    return (shape.kind == "train" and act_mode == "sp" and tp > 1
            and shape.seq_len % tp == 0
            and shape.global_batch % mesh_cfg.dp == 0)


def train_knobs(cfg: ModelConfig, shape: ShapeConfig, mesh_cfg, *,
                grad_sync: str = "spmd", act_mode: str = "sp",
                shard_mode: str = "2d", extra_train_kwargs=None) -> Dict:
    """The reference's ``TrainConfig`` choices for a cell
    (``src/repro/launch/dryrun.py:79-113``)."""
    tp, dp = mesh_cfg.tp, mesh_cfg.dp
    tkw = dict(param_dtype="bfloat16", compute_dtype="bfloat16",
               remat=True, grad_sync=grad_sync, loss_chunk=512,
               attn_chunk_threshold=2048, attn_chunk=512)
    if shape.kind == "train":
        # microbatch count: keep the remat-saved residual stack (~tokens_sp
        # x d x L x 2B per device) under ~0.5GB
        seq_sp = tp if sequence_parallel(shape, mesh_cfg, act_mode) else 1
        tokens_dev = shape.global_batch * shape.seq_len / dp / seq_sp
        saved = tokens_dev * cfg.d_model * cfg.num_layers * 2
        mb = 1
        while (saved / mb > 0.5e9 and mb < 16
               and shape.global_batch % (2 * mb) == 0
               and (shape.global_batch // (2 * mb)) % dp == 0):
            mb *= 2
        tkw["microbatches"] = mb
        if cfg.d_model >= 6144:
            tkw["loss_chunk"] = 256   # bound CE logits temp on giant d/vocab
        tkw["attn_chunk_kv"] = 2048
    if shard_mode == "dp_only":
        tkw["fsdp"] = False
    tkw.update(extra_train_kwargs or {})
    if grad_sync != "spmd":
        # the explicit trainer's cell: no remat, one microbatch
        tkw.update(remat=False, microbatches=1)
    return tkw


def _mesh_cfg(mesh_name: str, shard_mode: str):
    """The named mesh (``config.MESHES``: the production meshes and the
    test meshes)."""
    mesh_cfg = MESHES[mesh_name]
    if shard_mode == "dp_only":
        # small-model policy: no TP/FSDP, batch over ALL axes, weights
        # replicated
        mesh_cfg = dataclasses.replace(
            mesh_cfg,
            batch_axes=tuple(mesh_cfg.batch_axes) + tuple(mesh_cfg.model_axes),
            model_axes=())
    return mesh_cfg


def trace_batch(cfg: ModelConfig, shape: ShapeConfig, seqs: int) -> int:
    """The sequences a trace runs: a train step's ``seqs`` (one device's
    microbatch), a serving step's one; for MoE training the fewest
    dividing the batch whose tokens fill whole routing groups where
    ``seqs`` do not (every group then routes as in the full batch)."""
    if shape.kind != "train":
        return 1
    G = cfg.moe_group_size
    if not cfg.num_experts or (seqs * shape.seq_len) % G == 0:
        return seqs
    for b in range(1, shape.global_batch + 1):
        if (shape.global_batch % b == 0 and b * shape.seq_len >= G
                and (b * shape.seq_len) % G == 0):
            return b
    return shape.global_batch


def _step(cfg, shape, tcfg, scfg, cache_len, batch):
    """A thunk running the cell's step at ``batch`` sequences on meta."""
    model = build_model(cfg, scfg, device="cpu", train=tcfg)
    pdt = dtype_of(tcfg.param_dtype)
    cdt = dtype_of(tcfg.compute_dtype)
    params = meta_params(cfg, pdt)
    sub = dataclasses.replace(shape, global_batch=batch)
    if shape.kind == "train":
        from repro_torch.optim import adamw_init
        step = make_train_step(model, None, dataclasses.replace(
            tcfg, microbatches=1))
        state = TrainState(params, adamw_init(params))
        data = meta_batch(cfg, sub, tcfg.compute_dtype)
        return lambda: step(state, data)
    if shape.kind == "prefill":
        data = meta_batch(cfg, sub, tcfg.compute_dtype)
        kw = {k: v for k, v in data.items()
              if k in ("frames", "patch_embeds")}
        if transformer.has_state(cfg):
            from repro_torch.kernels.ssd_scan.ref import ssd_chunked_scan
            kw["scan"] = ssd_chunked_scan
        return lambda: model.prefill(params, data["tokens"], cache_len, **kw)
    mod = encdec if cfg.is_encoder_decoder else transformer
    cache = mod.init_cache(cfg, batch, cache_len, device=META, dtype=cdt)
    tok = torch.empty((batch, 1), dtype=torch.int32, device=META)
    pos = torch.empty((batch,), dtype=torch.int32, device=META)
    return lambda: model.decode_step(params, cache, tok, pos)


def depth_fit(points: Dict, key: str, depth) -> float:
    """``key`` at ``depth``, linear in each stack's depth from the base
    trace (``points``: ``{"base": depth, depth: count}``)."""
    base = points["base"]
    v = points[base][key]
    for i in range(len(base)):
        nxt = tuple(d + int(j == i) for j, d in enumerate(base))
        v += (depth[i] - base[i]) * (points[nxt][key] - points[base][key])
    return v


def _attn_steps(cfg: ModelConfig, shape: ShapeConfig, tcfg: TrainConfig,
                scfg: ServeConfig, batch: int):
    """Thunks running one layer's training attention alone on meta at
    ``batch`` sequences, forward and backward, through the model's own
    functions: the projections, the kv repeat, the full or chunked
    attention the knobs pick and the output projection, the gradient
    reaching their input (the weights take none: their gradients belong
    to the layers' part). One thunk for a decoder-only model, three for
    the encoder-decoder (encoder and decoder self-attention, the
    cross-attention), none without attention."""
    if not cfg.num_heads:
        return []
    knobs = _knobs(tcfg, scfg)
    cdt = dtype_of(tcfg.compute_dtype)
    params = meta_params(_at_depth(cfg, (1, 1)), dtype_of(tcfg.param_dtype))

    def x(n):
        return torch.empty((batch, n, cfg.d_model), dtype=cdt, device=META,
                           requires_grad=True)

    def run(fn, *inputs):
        def thunk():
            out = fn(*inputs)
            out.backward(torch.empty_like(out))
        return thunk

    if not cfg.is_encoder_decoder:
        pos = torch.arange(shape.seq_len, device=META)
        return [run(transformer._train_attn, cfg,
                    params["blocks"][0]["attn"], x(shape.seq_len), pos,
                    transformer.layer_flags(cfg)[0], knobs)]
    enc_pos = torch.arange(cfg.encoder_seq, device=META)
    dec_pos = torch.arange(shape.seq_len, device=META)
    dec = params["dec_blocks"][0]
    return [
        run(functools.partial(encdec._train_self_attn, causal=False,
                              knobs=knobs),
            cfg, params["enc_blocks"][0]["attn"], x(cfg.encoder_seq),
            enc_pos),
        run(functools.partial(encdec._train_self_attn, causal=True,
                              knobs=knobs),
            cfg, dec["attn"], x(shape.seq_len), dec_pos),
        run(encdec._train_cross_attn, cfg, dec["xattn"], x(shape.seq_len),
            x(cfg.encoder_seq))]


def _prefill_cross_attn(cfg, p_x, xn, enc_out):
    """A decoder layer's cross-attention in the encoder-decoder's prefill:
    its K/V from the encoder's output, then the attention."""
    return encdec._cross_attn(cfg, p_x, xn, *encdec._cross_kv(cfg, p_x,
                                                               enc_out),
                              None)


def _serve_attn_steps(cfg: ModelConfig, shape: ShapeConfig,
                      tcfg: TrainConfig, scfg: ServeConfig, cache_len,
                      batch: int):
    """Thunks running one layer's serving attention alone on meta at
    ``batch`` sequences, through the functions the cell's step runs
    (the plain path, as everything traced on meta): a prefill's
    projections, full or chunked attention and output projection over the
    prompt; a decode step's projections, cache writes and attention over
    one layer's slot cache of ``cache_len`` (made outside the thunk, as
    the step's cache is its argument). The encoder-decoder adds the
    encoder's self-attention (prefill) and the cross-attention (both). One
    thunk a kind of attention, none without attention."""
    if not cfg.num_heads:
        return []
    cdt = dtype_of(tcfg.compute_dtype)
    params = meta_params(_at_depth(cfg, (1, 1)), dtype_of(tcfg.param_dtype))
    p = params["dec_blocks" if cfg.is_encoder_decoder else "blocks"][0]
    flag = True if cfg.is_encoder_decoder else transformer.layer_flags(cfg)[0]

    def x(n):
        return torch.empty((batch, n, cfg.d_model), dtype=cdt, device=META)

    if shape.kind == "prefill":
        pos = torch.arange(shape.seq_len, device=META)
        if not cfg.is_encoder_decoder:
            return [functools.partial(transformer._attn_branch, cfg,
                                      p["attn"], x(shape.seq_len), pos, flag,
                                      scfg, None)]
        enc_pos = torch.arange(cfg.encoder_seq, device=META)
        enc = x(cfg.encoder_seq)
        return [
            functools.partial(encdec._self_attn, cfg,
                              params["enc_blocks"][0]["attn"], enc, enc_pos,
                              causal=False, serve=scfg, attention=None),
            functools.partial(encdec._self_attn, cfg, p["attn"],
                              x(shape.seq_len), pos, causal=True,
                              serve=scfg, attention=None),
            functools.partial(_prefill_cross_attn, cfg, p["xattn"],
                              x(shape.seq_len), enc)]
    mod = encdec if cfg.is_encoder_decoder else transformer
    cache = mod.init_cache(cfg, batch, cache_len, device=META, dtype=cdt)
    W = cache["pos"].shape[1] - 1
    qpos = torch.zeros((batch, 1), dtype=torch.long, device=META)
    rows = torch.arange(batch, device=META)[:, None]
    wcol = torch.remainder(qpos, W)
    steps = [functools.partial(transformer._cached_attn, cfg, p["attn"],
                               x(1), cache["k"][0], cache["v"][0],
                               cache["pos"].long(), qpos, rows, wcol, flag)]
    if cfg.is_encoder_decoder:
        steps.append(functools.partial(
            encdec._cross_attn, cfg, p["xattn"], x(1), cache["cross_k"][0],
            cache["cross_v"][0], None))
    return steps


@functools.lru_cache(maxsize=None)
def trace_counts(cfg: ModelConfig, shape: ShapeConfig, tcfg: TrainConfig,
                 scfg: ServeConfig, cache_len, batch: int) -> Dict:
    """The step's traces at ``batch`` sequences, at a base depth (0 for a
    serving step; 1 for a train step, whose gradient needs every
    parameter in the graph) and one layer more, each stack apart:
    ``{"base": depth, "batch": batch, depth: count_step(...)}``, and
    ``"attn_peak"``: the largest peak of live bytes of one layer's
    attention traced alone (``_attn_steps`` for a train step,
    ``_serve_attn_steps`` for a serving step), the part of the step's
    working set that the heads shard. A pure function of its
    (frozen) arguments, kept for the process: a cell's trace does not
    depend on its mesh, so a second mesh costs nothing."""
    n = 2 if cfg.is_encoder_decoder else 1
    d0 = 1 if shape.kind == "train" else 0
    base = (d0,) * n
    points = {"base": base, "batch": batch}
    for d in [base] + [tuple(d0 + int(i == j) for j in range(n))
                       for i in range(n)]:
        points[d] = A.count_step(
            _step(_at_depth(cfg, d), shape, tcfg, scfg, cache_len, batch))
    attn = (_attn_steps(cfg, shape, tcfg, scfg, batch)
            if shape.kind == "train" else
            _serve_attn_steps(cfg, shape, tcfg, scfg, cache_len, batch))
    points["attn_peak"] = max([A.peak_bytes(t) for t in attn], default=0)
    return points


def counted_flops(cfg: ModelConfig, shape: ShapeConfig, points) -> int:
    """The step's FLOPs at the config's depth and the cell's batch, from
    the traces: exact, the count being linear in each depth and
    proportional to the sequences."""
    depth = (cfg.num_layers, cfg.num_encoder_layers)
    return round(depth_fit(points, "flops", depth) * shape.global_batch
                 / points["batch"])


def attention_sharded(cfg: ModelConfig, tp: int) -> bool:
    """Whether attention is sharded by heads over ``tp`` devices of the
    model axes: where the heads divide them, the reference's
    ``attn_sharding`` rule (``src/repro/launch/dryrun.py:128-130``); else
    attention stays whole on every device of a model group."""
    return bool(cfg.num_heads) and cfg.num_heads % tp == 0


def temp_bytes(cfg: ModelConfig, shape: ShapeConfig, points, seqs: float,
               *, tp: int, seq_parallel: bool) -> float:
    """Live temporaries a device holds in the step at the config's depth
    for ``seqs`` sequences, over ``tp`` devices of the model axes.

    A train step's peak grows with the depth, so it is fitted in the depth
    at the traced batch, in two parts. The layers' part (each layer's
    slope times its depth) is each layer's saved input and its gradient:
    the residual stream, which the layout shards by sequence over the
    model axes under sequence parallelism and leaves whole on every
    device of a model group otherwise; it is divided by ``tp`` only with
    ``seq_parallel``. The base (the fit at depth 0: a layer's working set
    in the backward, the loss) is the working set of the products that
    Megatron's tensor parallelism shards over the model axes (heads,
    hidden, vocab), divided by ``tp`` in both layouts, except its
    attention share, ``points["attn_peak"]`` (one layer's attention
    traced alone, at most the base). Attention is divided by ``tp`` where
    ``attention_sharded`` (by heads), or else under sequence parallelism
    (by queries: each device attends its own sequence shard of the
    queries to all the keys, context parallelism; the keys and values it
    gathers whole are not counted apart). Otherwise it is whole on every
    device of a model group. A serving step's layers reuse one layer's
    working set, so its peak is the larger traced one, scaled to
    ``seqs``: over ``tp``, except its attention share (one layer's serving
    attention traced alone, at most that peak), divided by ``tp`` only
    where ``attention_sharded``: a serving cell has no sequence
    parallelism."""
    if shape.kind == "train":
        depth = (cfg.num_layers, cfg.num_encoder_layers)
        total = depth_fit(points, "peak_bytes", depth)
        base = depth_fit(points, "peak_bytes", (0,) * len(points["base"]))
        layers = total - base
        attn = min(points["attn_peak"], max(0.0, base))
        attn_tp = tp if attention_sharded(cfg, tp) or seq_parallel else 1
        return max(0.0, (base - attn) / tp + attn / attn_tp
                   + layers / (tp if seq_parallel else 1))
    peak = max(v["peak_bytes"] for k, v in points.items()
               if isinstance(k, tuple))
    attn = min(points.get("attn_peak", 0), peak)
    attn_tp = tp if attention_sharded(cfg, tp) else 1
    return ((peak - attn) / tp + attn / attn_tp) * seqs / points["batch"]


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

def build_cell(arch: str, shape_name: str, mesh_name: str, *,
               smoke: bool = False, grad_sync: str = "spmd",
               act_mode: str = "sp", shard_mode: str = "2d",
               extra_train_kwargs=None):
    """Return ``(trees, knobs, meta)`` for one dry-run cell: the cell's
    full-depth trees on ``meta`` with their spec trees (``trees``), its
    ``TrainConfig`` / ``ServeConfig`` and cache length (``knobs``), and
    the reference's ``meta`` record. ``knobs`` keeps ``act_mode``, the
    residual stream's layout. ``trees`` is None for a skipped cell."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return None, None, {"skipped": why}
    mesh_cfg = _mesh_cfg(mesh_name, shard_mode)
    dp = mesh_cfg.dp
    tcfg = TrainConfig(**train_knobs(
        cfg, shape, mesh_cfg, grad_sync=grad_sync, act_mode=act_mode,
        shard_mode=shard_mode, extra_train_kwargs=extra_train_kwargs))
    scfg = ServeConfig(ring_buffer=shape.name == "long_500k")
    explicit = grad_sync != "spmd"
    batch_div = shape.global_batch % dp == 0
    pdt = dtype_of(tcfg.param_dtype)
    params = meta_params(cfg, pdt)
    p_specs = param_pspecs(cfg, mesh_cfg, params, moe_fsdp=tcfg.moe_fsdp,
                           fsdp=tcfg.fsdp)
    data = meta_batch(cfg, shape, tcfg.compute_dtype)
    b_spec = batch_pspec(mesh_cfg) if batch_div else P()

    meta = {
        "arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
        "kind": shape.kind, "devices": mesh_cfg.num_devices,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "global_batch": shape.global_batch, "seq_len": shape.seq_len,
        "grad_sync": grad_sync,
    }
    trees = {"cfg": cfg, "shape": shape, "mesh_cfg": mesh_cfg,
             "params": params, "p_specs": p_specs, "batch": data,
             "b_specs": {k: b_spec for k in data}}
    knobs = {"tcfg": tcfg, "scfg": scfg, "cache_len": None,
             "act_mode": act_mode}

    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        meta["model_flops_per_device"] = (
            6 * cfg.active_param_count() * tokens / mesh_cfg.num_devices)
        meta["microbatches"] = tcfg.microbatches
        if explicit:
            from repro_torch.train.explicit import padded_len
            plen = padded_len(params, dp)
            flat = torch.empty((plen,), dtype=torch.float32, device=META)
            shard = (P(tuple(mesh_cfg.batch_axes)) if mesh_cfg.batch_axes
                     else P())
            trees["state"] = ExplicitTrainState(
                params, FlatAdamState(torch.empty((), dtype=torch.int32,
                                                  device=META),
                                      flat, meta_like(flat), meta_like(flat)))
            tp_cfg = dataclasses.replace(mesh_cfg, batch_axes=())
            trees["state_specs"] = ExplicitTrainState(
                param_pspecs(cfg, tp_cfg, params),
                FlatAdamState(P(), shard, shard, shard))
            trees["plen"] = plen
        else:
            from repro_torch.optim import AdamWState
            master = (meta_like(params, torch.float32)
                      if pdt != torch.float32 else None)
            trees["state"] = TrainState(params, AdamWState(
                torch.empty((), dtype=torch.int32, device=META),
                meta_like(params, torch.float32),
                meta_like(params, torch.float32), master))
            trees["state_specs"] = state_pspecs(
                cfg, mesh_cfg, trees["state"], moe_fsdp=tcfg.moe_fsdp,
                fsdp=tcfg.fsdp)
        return trees, knobs, meta

    cache_len = cache_len_for(cfg, shape, scfg)
    meta["cache_len"] = cache_len
    knobs["cache_len"] = cache_len
    mod = encdec if cfg.is_encoder_decoder else transformer
    cache = mod.init_cache(cfg, shape.global_batch, cache_len, device=META,
                           dtype=dtype_of(tcfg.compute_dtype))
    c_specs = cache_pspecs(cfg, mesh_cfg, cache)
    if not batch_div:
        c_specs = _strip_batch_axes(c_specs, (1,))
    trees["cache"], trees["c_specs"] = cache, c_specs
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        meta["model_flops_per_device"] = (
            2 * cfg.active_param_count() * tokens / mesh_cfg.num_devices)
        return trees, knobs, meta
    # decode: one new token a row against a seq_len cache
    B = shape.global_batch
    trees["batch"] = {
        "tokens": torch.empty((B, 1), dtype=torch.int32, device=META),
        "positions": torch.empty((B,), dtype=torch.int32, device=META)}
    trees["b_specs"] = {k: b_spec for k in trees["batch"]}
    meta["model_flops_per_device"] = (
        2 * cfg.active_param_count() * B / mesh_cfg.num_devices)
    return trees, knobs, meta


def memory_per_device(trees: Dict, peak_bytes: float) -> Dict:
    """The reference's ``memory_analysis`` fields, per device, from the
    spec trees, with each field's source."""
    mesh_cfg, shape = trees["mesh_cfg"], trees["shape"]
    batch = A.bytes_per_device(trees["batch"], trees["b_specs"], mesh_cfg)
    if shape.kind == "train":
        state = A.bytes_per_device(trees["state"], trees["state_specs"],
                                   mesh_cfg)
        args, out, alias = state + batch, state, state
        src = ("train state and batch over their specs (state_pspecs or "
               "the explicit trainer's shard specs; batch_pspec)")
    else:
        params = A.bytes_per_device(trees["params"], trees["p_specs"],
                                    mesh_cfg)
        cache = A.bytes_per_device(trees["cache"], trees["c_specs"],
                                   mesh_cfg)
        cfg = trees["cfg"]
        logits = shape.global_batch * cfg.padded_vocab * 4   # P(): whole
        if shape.kind == "prefill":
            args, out, alias = params + batch, logits + cache, 0
            src = "params and batch over their specs"
        else:
            args, out, alias = params + cache + batch, logits + cache, cache
            src = ("params, cache (donated: aliased by the output) and "
                   "tokens over their specs")
    return {"argument_size_in_bytes": int(args),
            "output_size_in_bytes": int(out),
            "alias_size_in_bytes": int(alias),
            "temp_size_in_bytes": int(peak_bytes),
            "sources": {
                "argument_size_in_bytes": src,
                "output_size_in_bytes": "the step's outputs over their "
                                        "specs (logits replicated)",
                "alias_size_in_bytes": "donated inputs the outputs reuse",
                "temp_size_in_bytes": "peak live bytes of the traced step "
                                      "(LiveBytes), fitted to the depth and "
                                      "the per-device sequences, over the "
                                      "model axes as the layout shards "
                                      "them (temp_bytes)"}}


def head_leaf(cfg: ModelConfig) -> Tuple[str, int]:
    """The LM head's leaf and the dim of its vocab: ``lm_head`` (d, V), or
    the tied ``embed`` (V, d)."""
    return ("embed", 0) if cfg.tie_embeddings else ("lm_head", 1)


def cell_collectives(trees: Dict, knobs: Dict) -> list:
    """The cell's collectives, modelled from its spec trees in its layout
    (``knobs["act_mode"]``): a serving step also gathers its logits,
    which it returns whole on every device (``P()``)."""
    cfg, shape, mesh_cfg = trees["cfg"], trees["shape"], trees["mesh_cfg"]
    tcfg = knobs["tcfg"]
    batch_div = shape.global_batch % mesh_cfg.dp == 0
    dp_eff = mesh_cfg.dp if batch_div else 1
    train = shape.kind == "train"
    explicit = train and tcfg.grad_sync != "spmd"
    passes = (3 if tcfg.remat else 2) if train else 1
    steps = tcfg.microbatches if train else 1
    seq = 1 if shape.kind == "decode" else shape.seq_len
    act_bytes = (shape.global_batch / dp_eff / steps * seq * cfg.d_model
                 * dtype_of(tcfg.compute_dtype).itemsize)
    if explicit:
        p_specs = trees["state_specs"].params
    else:
        p_specs = trees["p_specs"]
    out = A.fsdp_collectives(trees["params"], p_specs, mesh_cfg,
                             passes=passes, steps=steps,
                             grads=train and not explicit)
    head, vocab_dim = head_leaf(cfg)
    out += A.tp_collectives(
        trees["params"], p_specs, mesh_cfg, act_bytes=act_bytes,
        passes=passes, steps=steps, head=head,
        seq_parallel=sequence_parallel(shape, mesh_cfg, knobs["act_mode"]))
    if explicit:
        out += A.explicit_collectives(
            mesh_cfg, plen=trees["plen"], grad_sync=tcfg.grad_sync,
            param_bytes=dtype_of(tcfg.param_dtype).itemsize,
            wire_bytes=dtype_of(tcfg.grad_comm_dtype).itemsize)
    if not train:
        out += A.logits_collectives(
            p_specs[head], mesh_cfg, head=head,
            vocab_dim=vocab_dim, rows=shape.global_batch // dp_eff,
            vocab=cfg.padded_vocab, batch_sharded=batch_div)
    return out


def run_cell(arch: str, shape_name: str, mesh_name: str, *,
             smoke=False, grad_sync="spmd", shard_mode="2d", verbose=True,
             extra_train_kwargs=None):
    t0 = time.perf_counter()
    trees, knobs, meta = build_cell(
        arch, shape_name, mesh_name, smoke=smoke, grad_sync=grad_sync,
        shard_mode=shard_mode, extra_train_kwargs=extra_train_kwargs)
    meta = dict(meta, shard_mode=shard_mode)
    if trees is None:
        return {"meta": meta}
    t_build = time.perf_counter() - t0
    res = analyze_cell(trees, knobs, meta, verbose=verbose)
    res["timings"] = {"build_s": t_build, **res["timings"]}
    return res


def analyze_cell(trees: Dict, knobs: Dict, meta: Dict, *,
                 verbose: bool = False) -> Dict:
    """``run_cell``'s record of a built cell (``build_cell``'s outputs, in
    whatever layout it was built): the step traced on meta, its counts,
    memory per device and modelled collectives, the analytic terms."""
    cfg, shape, mesh_cfg = trees["cfg"], trees["shape"], trees["mesh_cfg"]
    tcfg = knobs["tcfg"]
    dp_eff = mesh_cfg.dp if shape.global_batch % mesh_cfg.dp == 0 else 1
    seqs_dev = shape.global_batch // dp_eff // (
        tcfg.microbatches if shape.kind == "train" else 1)
    seq_par = sequence_parallel(shape, mesh_cfg, knobs["act_mode"])
    t0 = time.perf_counter()
    points = trace_counts(cfg, shape, tcfg, knobs["scfg"],
                          knobs["cache_len"],
                          trace_batch(cfg, shape, seqs_dev))
    t_trace = time.perf_counter() - t0
    flops = counted_flops(cfg, shape, points)
    peak = temp_bytes(cfg, shape, points, seqs_dev, tp=mesh_cfg.tp,
                      seq_parallel=seq_par)
    traces = [{"depth": list(k), "batch": points["batch"], **v}
              for k, v in points.items() if isinstance(k, tuple)]
    counted = {
        "flops": flops, "flops_per_device": flops / mesh_cfg.num_devices,
        "traces": traces,
        "attn_peak_bytes": points.get("attn_peak"),
        "note": "FlopCounterMode on meta tensors: matmul-class ops only; "
                "traced at a base depth and one layer more (each stack "
                "apart), extrapolated linearly to the depth, at the "
                "traced sequences and scaled to the batch",
    }
    memory = memory_per_device(trees, peak)
    if verbose:
        print({k: v for k, v in memory.items() if k != "sources"})
        print({"flops": flops, "trace_s": t_trace})

    # analytical compute/memory terms (the source of the two terms, as in
    # the reference)
    from repro_torch.roofline.flops import cell_compute_flops, cell_memory_bytes
    comp = cell_compute_flops(cfg, shape)
    memb = cell_memory_bytes(cfg, shape, mesh_cfg,
                             cache_len=meta.get("cache_len"))
    analytic = {
        "computed_flops_per_device": comp["computed"] / mesh_cfg.num_devices,
        "bytes_per_device": memb["bytes"],
        "flops_breakdown": comp, "bytes_breakdown": memb,
    }
    analysis = A.analyze_step(
        counted, memory, cell_collectives(trees, knobs),
        model_flops=meta.get("model_flops_per_device"), analytic=analytic)
    analysis["counted_over_analytic"] = (flops / comp["computed"]
                                         if comp["computed"] else 0.0)
    analysis["seq_parallel"] = seq_par
    return {"meta": meta, "analysis": analysis,
            "timings": {"trace_s": t_trace}}


def artifact_path(arch, shape_name, mesh_name, grad_sync="spmd",
                  shard_mode="2d"):
    tag = "" if grad_sync == "spmd" else f"__{grad_sync}"
    if shard_mode != "2d":
        tag += f"__{shard_mode}"
    d = os.path.join(artifact_dir(), mesh_name)
    return os.path.join(d, f"{arch}__{shape_name}{tag}.json")


def all_cells():
    for arch in ARCH_NAMES:
        for shape_name in ("train_4k", "prefill_32k", "decode_32k",
                           "long_500k"):
            yield arch, shape_name


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description="multi-pod dry run on meta "
                                             "tensors")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single_pod",
                    choices=["single_pod", "multi_pod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--grad-sync", default="spmd",
                    choices=["spmd", "threadcomm", "flat"])
    ap.add_argument("--shard-mode", default="2d", choices=["2d", "dp_only"])
    args = ap.parse_args(argv)

    meshes = (["single_pod", "multi_pod"] if args.mesh == "both"
              else [args.mesh])
    cells = (list(all_cells()) if args.all
             else [(args.arch, args.shape)])
    n_ok = n_skip = n_fail = 0
    for mesh_name in meshes:
        for arch, shape_name in cells:
            path = artifact_path(arch, shape_name, mesh_name, args.grad_sync,
                                 args.shard_mode)
            if os.path.exists(path) and not args.force:
                print(f"[cached] {mesh_name}/{arch}/{shape_name}")
                n_ok += 1
                continue
            print(f"=== {mesh_name} :: {arch} :: {shape_name} "
                  f"(grad_sync={args.grad_sync}) ===", flush=True)
            try:
                res = run_cell(arch, shape_name, mesh_name, smoke=args.smoke,
                               grad_sync=args.grad_sync,
                               shard_mode=args.shard_mode, verbose=False)
            except Exception:
                traceback.print_exc()
                n_fail += 1
                continue
            if "analysis" not in res:
                print(f"[skip] {res['meta'].get('skipped')}")
                n_skip += 1
            else:
                a = res["analysis"]
                terms = a["terms"]
                print(f"[ok] dominant={a['dominant']} "
                      f"compute={terms['compute_s']:.4f}s "
                      f"memory={terms['memory_s']:.4f}s "
                      f"collective={terms['collective_s']:.4f}s "
                      f"fits_hbm={a['fits_hbm']} counted/analytic="
                      f"{a['counted_over_analytic']:.3f} "
                      f"(trace {res['timings']['trace_s']:.1f}s)",
                      flush=True)
                n_ok += 1
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                json.dump(res, f, indent=1, default=str)
    print(f"dryrun done: ok={n_ok} skip={n_skip} fail={n_fail}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
