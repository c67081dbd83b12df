"""Roofline terms of one traced step — the port of
``src/repro/roofline/analysis.py`` on PyTorch's own counters.

Three terms per (arch x shape x mesh), in seconds, per device (the
global form gives the same: numerator and denominator both scale with
the device count):

  compute    = computed_FLOPs_per_device / peak_FLOP/s      (analytical)
  memory     = HBM_bytes_per_device / HBM_bw                (analytical)
  collective = sum of collective operand bytes per device / NVLink bw
               (modelled from the spec trees)

The analytic formulas (``roofline/flops.py``) stay the source of the
compute and memory terms, as in the reference. What XLA gave the
reference, the port takes from elsewhere:

* ``counted`` (the reference's ``hlo_raw``): the matmul-class FLOPs that
  ``torch.utils.flop_counter.FlopCounterMode`` counts in the step traced
  on ``meta`` tensors (``launch/dryrun.py``), a cross-check. Elementwise
  ops count nothing there, as in XLA's cost model of a dot.
* ``memory_analysis``: argument bytes per device from the spec trees
  (each leaf's bytes over the mesh axes its spec shards it on), and the
  temporaries as the peak of live bytes a ``TorchDispatchMode``
  (:class:`LiveBytes`) tallies over the traced step. These are the
  port's counts, not XLA's.
* ``collectives``: the port has no partitioner, so no HLO exists to
  parse. :func:`collective_record` builds the reference's records from
  the spec trees and the residual stream's layout (FSDP gathers,
  gradient reduce-scatters, tensor-parallel all-reduces, or under
  sequence parallelism their reduce-scatters and all-gathers, a serving
  step's gathers of its replicated logits, the explicit trainer's
  schedule), with its ring model of effective bytes; ``source`` says
  "spec". The term is modelled, not observed.
"""

from __future__ import annotations

import math
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.config import MeshConfig
from repro_torch.roofline.hw import H100, HW

_COLL_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute")


def collective_record(op: str, computation: str, operand_bytes: float,
                      group_size: int, trip_multiplier: int = 1,
                      num_groups: Optional[int] = None) -> Dict:
    """One collective site in the format of the reference's
    ``parse_collectives``: operand and output bytes per device, and the
    ring model's effective bytes per device, times the executions."""
    if op not in _COLL_OPS:
        raise ValueError(f"unknown collective {op!r}")
    g = group_size
    if op == "all-gather":
        out_bytes = operand_bytes * g
    elif op == "reduce-scatter":
        out_bytes = operand_bytes / g
    else:
        out_bytes = operand_bytes
    # ring-model effective bytes per device
    if op == "all-reduce":
        eff = 2 * (g - 1) / g * operand_bytes
    elif op == "all-gather":
        eff = (g - 1) * operand_bytes
    elif op in ("reduce-scatter", "all-to-all"):
        eff = (g - 1) / g * operand_bytes
    else:
        eff = operand_bytes
    k = trip_multiplier
    return {
        "op": op, "computation": computation, "trip_multiplier": k,
        "operand_bytes": operand_bytes, "output_bytes": out_bytes,
        "group_size": group_size, "num_groups": num_groups,
        "total_operand_bytes": operand_bytes * k,
        "total_effective_bytes": eff * k,
        "source": "spec",
    }


def summarize_collectives(colls: List[Dict]) -> Dict:
    by_op = defaultdict(lambda: {"sites": 0, "executions": 0,
                                 "operand_bytes": 0.0,
                                 "effective_bytes": 0.0})
    for c in colls:
        rec = by_op[c["op"]]
        rec["sites"] += 1
        rec["executions"] += c["trip_multiplier"]
        rec["operand_bytes"] += c["total_operand_bytes"]
        rec["effective_bytes"] += c["total_effective_bytes"]
    total = {k: sum(r[k] for r in by_op.values())
             for k in ("sites", "executions", "operand_bytes",
                       "effective_bytes")}
    return {"by_op": {k: dict(v) for k, v in by_op.items()}, "total": total}


# ---------------------------------------------------------------------------
# Counting a traced step
# ---------------------------------------------------------------------------

class LiveBytes(TorchDispatchMode):
    """The peak of live bytes of the storages that ops create while the
    mode is on. A storage counts from the op that makes it until its last
    reference (a tensor, a view, autograd's saved copy) is gone, as a
    weak reference to the storage itself sees it; views and in-place
    results add nothing. Storages made before the mode (parameters,
    inputs) never count. The peak is exact at every allocation: ``live``
    counts freed storages until a sweep drops them, so it only ever
    overstates, and it is swept whenever it would raise the peak (a weak
    reference keeps a storage's address from being reused while it is
    held)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._refs: List = []       # [(StorageWeakRef, nbytes, key)]
        self._keys = set()

    def _sweep(self):
        kept = []
        for ref, n, key in self._refs:
            if ref.expired():
                self.live -= n
                self._keys.discard(key)
            else:
                kept.append((ref, n, key))
        self._refs = kept

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func._schema.is_mutable:
            return out
        for t in _pytree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st._cdata in self._keys:
                continue
            self._keys.add(st._cdata)
            self._refs.append((StorageWeakRef(st), st.nbytes(), st._cdata))
            self.live += st.nbytes()
        if self.live > self.peak:
            self._sweep()
            self.peak = max(self.peak, self.live)
        return out


def peak_bytes(fn: Callable[[], object]) -> int:
    """The peak of live bytes of ``fn`` (a step on ``meta`` tensors), as
    :func:`count_step` counts it, without counting its FLOPs."""
    with LiveBytes() as lb:
        fn()
    return int(lb.peak)


def count_step(fn: Callable[[], object]) -> Dict:
    """Run ``fn`` (a step on ``meta`` tensors) under FlopCounterMode and
    :class:`LiveBytes`: its matmul-class FLOPs, the peak of the live bytes
    its ops created, and the seconds the trace took."""
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc, LiveBytes() as lb:
        fn()
    return {"flops": int(fc.get_total_flops()), "peak_bytes": int(lb.peak),
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# Spec trees: bytes per device and modelled collectives
# ---------------------------------------------------------------------------

def spec_leaves(tree, specs, names=()):
    """(path names, tensor, spec) of every leaf of ``tree`` beside its
    spec tree (list indices skipped from the path, as the sharding rules
    see it). A spec of None (an absent subtree) yields nothing."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [(names, tree, specs)]
    if isinstance(tree, dict):
        return [x for k in tree
                for x in spec_leaves(tree[k], specs[k], names + (str(k),))]
    if hasattr(tree, "_fields"):
        return [x for f in tree._fields
                for x in spec_leaves(getattr(tree, f), getattr(specs, f),
                                     names + (f,))]
    return [x for t, s in zip(tree, specs)
            for x in spec_leaves(t, s, names)]


def spec_axes(spec) -> List[str]:
    """The mesh axes a spec shards over (every entry, flattened)."""
    out = []
    for e in spec if spec is not None else ():
        if e is None:
            continue
        out.extend([e] if isinstance(e, str) else list(e))
    return out


def axes_size(mesh_cfg: MeshConfig, axes) -> int:
    return math.prod(mesh_cfg.axis_size(a) for a in axes)


def leaf_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def bytes_per_device(tree, specs, mesh_cfg: MeshConfig) -> float:
    """Bytes one device holds of ``tree`` laid out by ``specs``: each
    leaf's bytes over the product of the mesh axes its spec names."""
    return sum(leaf_bytes(t) / axes_size(mesh_cfg, spec_axes(s))
               for _, t, s in spec_leaves(tree, specs))


def fsdp_collectives(params, specs, mesh_cfg: MeshConfig, *, passes: int,
                     steps: int = 1, grads: bool = False) -> List[Dict]:
    """The FSDP traffic of a parameter tree laid out by ``specs``: one
    all-gather of each leaf sharded over the batch axes per pass (the
    forward, the backward and the remat recompute: ``passes``), and with
    ``grads`` its gradient's reduce-scatter once (a leaf replicated over
    the batch axes all-reduces its gradient instead), each ``steps``
    times (microbatches). A layer stack's leaves are one site, executed
    once a layer."""
    dp_axes = tuple(mesh_cfg.batch_axes)
    dp = axes_size(mesh_cfg, dp_axes)
    sites: Dict[str, Dict] = {}
    for names, t, s in spec_leaves(params, specs):
        axes = spec_axes(s)
        gathered = [a for a in axes if a in dp_axes]
        site = "/".join(names)
        rec = sites.setdefault(site, {"n": 0, "bytes": leaf_bytes(t),
                                      "axes": axes, "g": gathered})
        rec["n"] += 1
    out = []
    for site, rec in sites.items():
        shard = rec["bytes"] / axes_size(mesh_cfg, rec["axes"])
        g = axes_size(mesh_cfg, rec["g"])
        if rec["g"]:
            out.append(collective_record(
                "all-gather", f"fsdp:{site}", shard, g,
                rec["n"] * passes * steps, num_groups=mesh_cfg.num_devices
                // g))
        if grads and dp > 1:
            if rec["g"]:
                out.append(collective_record(
                    "reduce-scatter", f"grad:{site}", shard * g, g,
                    rec["n"] * steps, num_groups=mesh_cfg.num_devices // g))
            else:
                out.append(collective_record(
                    "all-reduce", f"grad:{site}", shard, dp,
                    rec["n"] * steps, num_groups=mesh_cfg.num_devices // dp))
    return out


def tp_collectives(params, specs, mesh_cfg: MeshConfig, *, act_bytes: float,
                   passes: int, steps: int = 1, seq_parallel: bool = False,
                   head: Optional[str] = None) -> List[Dict]:
    """Megatron's tensor-parallel collectives of the residual stream
    (``act_bytes`` a device, whole sequence), per pass (the backward's
    input gradients and the recompute repeat them) and microbatch
    (``steps``), at each row-parallel product whose weight the spec
    shards over the model axes (``wo``, ``w_down``, ``out_proj``) and at
    the vocab-parallel embedding lookup (``embed``).

    With the residual replicated over the model axes, each of those ends
    in an all-reduce of the residual. With it sharded by sequence over
    them (``seq_parallel``: Megatron sequence parallelism), each ends in
    a reduce-scatter of the residual instead (same operand), and every
    row-parallel product's block opens with an all-gather of the
    sequence shard (operand ``act_bytes / tp``; computation
    ``tp:<site>:gather``), as does the LM head ``head`` (its leaf,
    ``lm_head`` or the tied ``embed``) when the spec shards it. In a pass
    either pattern moves the all-reduce's ring bytes."""
    tp_axes = tuple(mesh_cfg.model_axes)
    tp = axes_size(mesh_cfg, tp_axes)
    if tp <= 1:
        return []
    counts: Dict[str, int] = defaultdict(int)
    gathers: Dict[str, int] = defaultdict(int)
    for names, _, s in spec_leaves(params, specs):
        if not any(a in tp_axes for a in spec_axes(s)):
            continue
        site = "/".join(names)
        if names[-1] in ("wo", "w_down", "out_proj", "embed"):
            counts[site] += 1
        if names[-1] in ("wo", "w_down", "out_proj") or site == head:
            gathers[site] += 1
    groups = mesh_cfg.num_devices // tp
    if not seq_parallel:
        return [collective_record("all-reduce", f"tp:{site}", act_bytes, tp,
                                  n * passes * steps, num_groups=groups)
                for site, n in counts.items()]
    out = [collective_record("reduce-scatter", f"tp:{site}", act_bytes, tp,
                             n * passes * steps, num_groups=groups)
           for site, n in counts.items()]
    out += [collective_record("all-gather", f"tp:{site}:gather",
                              act_bytes / tp, tp, n * passes * steps,
                              num_groups=groups)
            for site, n in gathers.items()]
    return out


def logits_collectives(head_spec, mesh_cfg: MeshConfig, *, head: str,
                       vocab_dim: int, rows: int, vocab: int,
                       batch_sharded: bool) -> List[Dict]:
    """The gathers that make a serving step's float32 logits (``rows``
    sequences a device, ``vocab`` wide) whole on every device, once a
    step: the vocab-parallel shards over the model axes that the head
    leaf's spec (``head_spec``; its vocab at ``vocab_dim``) shards them
    on, then, with ``batch_sharded``, the batch shards over the
    data-parallel axes."""
    out = []
    spec = tuple(head_spec)
    entry = spec[vocab_dim] if vocab_dim < len(spec) else None
    g = axes_size(mesh_cfg, [a for a in spec_axes((entry,))
                             if a in tuple(mesh_cfg.model_axes)])
    if g > 1:
        out.append(collective_record(
            "all-gather", f"logits:{head}", rows * vocab // g * 4, g,
            num_groups=mesh_cfg.num_devices // g))
    dp = mesh_cfg.dp
    if batch_sharded and dp > 1:
        out.append(collective_record(
            "all-gather", "logits:batch", rows * vocab * 4, dp,
            num_groups=mesh_cfg.num_devices // dp))
    return out


def explicit_collectives(mesh_cfg: MeshConfig, *, plen: int, grad_sync: str,
                         param_bytes: int, wire_bytes: int = 4,
                         n_metrics: int = 4) -> List[Dict]:
    """The explicit trainer's gradient sync (``train/explicit.py``), per
    device, on a flat vector of ``plen`` parameters (padded to the data
    ranks). threadcomm: the thread comm's reduce-scatter of the float32
    gradient, the process comm's allreduce of the shard (at the wire
    dtype), the thread comm's allreduce of the squared norm and allgather
    of the updated shard at the parameter dtype; flat: one root-comm
    allreduce of the whole gradient, then the same allgather. Both end
    with the metrics' root-comm allreduce."""
    m = axes_size(mesh_cfg, tuple(mesh_cfg.batch_axes))
    n_proc = axes_size(mesh_cfg, tuple(mesh_cfg.process_axes))
    dp = m * n_proc
    shard = plen // m
    out = []
    if grad_sync == "flat":
        out.append(collective_record("all-reduce", "explicit:grad_flat",
                                     4 * plen, dp))
    else:
        if m > 1:
            out.append(collective_record(
                "reduce-scatter", "explicit:thread_reduce_scatter",
                4 * plen, m))
        if n_proc > 1:
            out.append(collective_record(
                "all-reduce", "explicit:process_allreduce",
                wire_bytes * shard, n_proc))
    if m > 1:
        out.append(collective_record("all-reduce", "explicit:grad_norm",
                                     4, m))
        out.append(collective_record(
            "all-gather", "explicit:thread_allgather",
            param_bytes * shard, m))
    out.append(collective_record("all-reduce", "explicit:metrics",
                                 4 * n_metrics, dp))
    return out


# ---------------------------------------------------------------------------
# The analysis record
# ---------------------------------------------------------------------------

def analyze_step(counted: Dict, memory: Dict, colls: List[Dict], *,
                 hw: HW = H100, model_flops: float = None,
                 analytic: Dict = None) -> Dict:
    """Roofline terms + bookkeeping, the keys of the reference's
    ``analyze_compiled`` with ``counted`` in the place of ``hlo_raw``.
    ``counted``: ``flops`` (global, per device under
    ``flops_per_device``) and how they were counted; ``memory``: the
    ``*_size_in_bytes`` fields per device and their sources;
    ``analytic``: ``computed_flops_per_device`` and ``bytes_per_device``
    from ``roofline/flops.py`` (the source of the compute and memory
    terms)."""
    summary = summarize_collectives(colls)
    mem_fields = {k: v for k, v in memory.items()
                  if k.endswith("_in_bytes")}
    live_bytes = (mem_fields.get("argument_size_in_bytes", 0)
                  + mem_fields.get("output_size_in_bytes", 0)
                  + mem_fields.get("temp_size_in_bytes", 0)
                  - mem_fields.get("alias_size_in_bytes", 0))

    flops_dev = (analytic or {}).get("computed_flops_per_device",
                                     counted.get("flops_per_device", 0.0))
    bytes_dev = (analytic or {}).get("bytes_per_device", 0.0)
    t_compute = flops_dev / hw.peak_flops_bf16
    t_memory = bytes_dev / hw.hbm_bw
    t_coll = summary["total"]["operand_bytes"] / hw.nvlink_bw
    t_coll_eff = summary["total"]["effective_bytes"] / hw.nvlink_bw
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll, "collective_eff_s": t_coll_eff}
    dominant = max(("compute_s", "memory_s", "collective_s"),
                   key=lambda k: terms[k])
    bound_s = max(t_compute, t_memory, t_coll)
    result = {
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "counted": counted,
        "collectives": summary,
        "collective_source": "spec",
        "memory_analysis": memory,
        "live_bytes_per_device": live_bytes,
        "fits_hbm": live_bytes <= hw.hbm_bytes,
        "terms": terms,
        "dominant": dominant,
        "roofline_bound_s": bound_s,
        "hw": hw.name,
    }
    if analytic:
        result["analytic"] = analytic
    if model_flops:
        result["model_flops_per_device"] = model_flops
        result["useful_flops_ratio"] = (model_flops / flops_dev
                                        if flops_dev else 0.0)
        result["mfu_at_bound"] = (model_flops / hw.peak_flops_bf16 / bound_s
                                  if bound_s else 0.0)
    return result
