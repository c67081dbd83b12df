"""The port's dry run (``repro_torch.launch.dryrun``) on ``meta``
tensors: the reference test's three cells at smoke size, the depth and
batch extrapolation of the FLOP count against whole traces, the counted
FLOPs against the analytic formula per cell, the argument bytes against
the reference's spec sums, and the modelled collectives against bytes
worked out by hand."""

import dataclasses
import math

import jax
import pytest
from jax.sharding import PartitionSpec as JP

from repro.config import MESHES as JMESHES
from repro.config import ServeConfig as JServeConfig
from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.dist.sharding import param_pspecs as jparam_pspecs
from repro.models.registry import build_model as jbuild_model
from repro.train.trainer import init_train_state as jinit_train_state
from repro.train.trainer import state_pspecs as jstate_pspecs
from repro_torch.config import ServeConfig, ShapeConfig, TrainConfig
from repro_torch.configs import ARCH_NAMES, get_smoke_config
from repro_torch.launch import dryrun as D
from repro_torch.roofline import analysis as A

#: the keys of the reference's ``analyze_compiled`` record, with
#: ``counted`` in the place of ``hlo_raw``
REFERENCE_KEYS = {
    "flops_per_device", "bytes_per_device", "collectives",
    "memory_analysis", "live_bytes_per_device", "fits_hbm", "terms",
    "dominant", "roofline_bound_s", "hw", "analytic",
    "model_flops_per_device", "useful_flops_ratio", "mfu_at_bound"}


@pytest.mark.parametrize("cell", [("gemma-2b", "train_4k", "single_pod"),
                                  ("mamba2-370m", "decode_32k", "multi_pod"),
                                  ("olmoe-1b-7b", "train_4k", "multi_pod")])
def test_reference_smoke_cells(cell):
    """``tests/mp_cases.py``'s dry-run cells through the port's
    ``run_cell``: every key of the reference's analysis, a positive
    compute term, and the memory fields with their sources."""
    res = D.run_cell(*cell, smoke=True, verbose=False)
    a = res["analysis"]
    assert REFERENCE_KEYS <= set(a) and "hlo_raw" not in a
    assert a["terms"]["compute_s"] > 0
    assert a["hw"] == "h100-sxm5-80gb"
    assert a["collective_source"] == "spec"
    mem = a["memory_analysis"]
    for k in ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes"):
        assert mem[k] >= 0 and k in mem["sources"]
    assert a["counted"]["flops"] > 0
    assert res["timings"]["trace_s"] > 0


def _small(arch, kind):
    """A 3-layer smoke config (3 encoder layers for whisper) and a short
    shape of ``kind``."""
    cfg = get_smoke_config(arch)
    kw = {"num_layers": 3}
    if cfg.is_encoder_decoder:
        kw["num_encoder_layers"] = 3
    cfg = dataclasses.replace(cfg, **kw)
    return cfg, ShapeConfig(f"small_{kind}", 64, 4, kind)


@pytest.mark.parametrize("arch,kind", [
    ("gemma-2b", "train"), ("gemma-2b", "prefill"), ("gemma-2b", "decode"),
    ("olmoe-1b-7b", "train"), ("olmoe-1b-7b", "prefill"),
    ("mamba2-370m", "train"), ("mamba2-370m", "prefill"),
    ("whisper-tiny", "train"), ("whisper-tiny", "decode"),
    ("hymba-1.5b", "decode")])
def test_extrapolation_equals_the_whole_trace(arch, kind):
    """The FLOPs extrapolated from the base-depth and one-layer-deeper
    traces at fewer sequences equal the whole step's trace at 3 layers
    and the full batch, exactly (flop counts are integers)."""
    cfg, shape = _small(arch, kind)
    mesh_cfg = D.MESHES["test8"]
    tcfg = TrainConfig(**D.train_knobs(cfg, shape, mesh_cfg))
    scfg = ServeConfig()
    cache_len = None if kind == "train" else shape.seq_len
    points = D.trace_counts(cfg, shape, tcfg, scfg, cache_len,
                            D.trace_batch(cfg, shape, 2))
    assert points["batch"] < shape.global_batch
    depths = [k for k in points if isinstance(k, tuple)]
    assert max(max(d) for d in depths) < 3
    whole = A.count_step(D._step(cfg, shape, tcfg, scfg, cache_len,
                                 shape.global_batch))
    assert D.counted_flops(cfg, shape, points) == whole["flops"]


#: counted / analytic per cell at full width, and why it is not 1
RATIO_BANDS = {
    ("gemma-2b", "decode_32k"): (0.999, 1.001,
                                 "one token's products, as the formula"),
    ("gemma-2b", "train_4k"): (0.93, 0.96,
                               "non-reentrant checkpoint stops its "
                               "recompute once the saved tensors are "
                               "back: each block's last product (w_down) "
                               "runs 3x, not the formula's 4x"),
    ("mamba2-370m", "decode_32k"): (0.84, 0.87,
                                    "a one-token step runs the recurrence, "
                                    "not the chunked scan's products"),
    # dropless MoE serving: every expert on every token, where the formula
    # counts top_k (8 of 64): the excess is expected, not a tolerance
    ("olmoe-1b-7b", "decode_32k"): (2.6, 2.8,
                                    "dropless: all 64 experts a token"),
    ("olmoe-1b-7b", "train_4k"): (1.3, 1.4,
                                  "capacity 1.25 x top_k slots an expert "
                                  "and the dispatch/combine products"),
}


@pytest.mark.parametrize("cell", sorted(RATIO_BANDS))
def test_counted_over_analytic_per_cell(cell):
    lo, hi, why = RATIO_BANDS[cell]
    res = D.run_cell(cell[0], cell[1], "single_pod", verbose=False)
    ratio = res["analysis"]["counted_over_analytic"]
    assert lo <= ratio <= hi, (cell, ratio, why)


def _jbytes(tree, specs, mesh_cfg):
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda s: isinstance(s, JP))
    assert len(leaves) == len(spec_leaves)
    total = 0.0
    for leaf, spec in zip(leaves, spec_leaves):
        axes = [a for e in spec if e is not None
                for a in ((e,) if isinstance(e, str) else e)]
        shards = math.prod(mesh_cfg.axis_size(a) for a in axes)
        total += math.prod(leaf.shape) * leaf.dtype.itemsize / shards
    return total


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_argument_bytes_equal_the_reference_spec_sums(arch):
    """Per-device parameter and train-state bytes of the full config on
    both production meshes: the port's spec trees over its meta tensors
    against the reference's ``param_pspecs`` / ``state_pspecs`` over
    ``jax.eval_shape`` of its init, exactly."""
    jcfg = jget_config(arch)
    for mesh_name in ("single_pod", "multi_pod"):
        jmesh = JMESHES[mesh_name]
        trees, _, _ = D.build_cell(arch, "train_4k", mesh_name)
        mesh_cfg = trees["mesh_cfg"]
        jmodel = jbuild_model(jcfg, JTrainConfig(), JServeConfig(),
                              tp=jmesh.tp)
        key = jax.random.PRNGKey(0)
        psds = jax.eval_shape(jmodel.init, key)
        want = _jbytes(psds, jparam_pspecs(jcfg, jmesh, psds), jmesh)
        got = A.bytes_per_device(trees["params"], trees["p_specs"],
                                 mesh_cfg)
        assert got == want, (mesh_name, got, want)
        ssds = jax.eval_shape(lambda k: jinit_train_state(jmodel, k), key)
        want = _jbytes(ssds, jstate_pspecs(jcfg, jmesh, ssds), jmesh)
        got = A.bytes_per_device(trees["state"], trees["state_specs"],
                                 mesh_cfg)
        assert got == want, (mesh_name, got, want)


def test_spec_collectives_by_hand_on_the_test_mesh():
    """gemma-2b's smoke config (2 layers, d 64, 4 x 32 heads, 1 kv head,
    d_ff 128, vocab 256, bf16) training at train_4k on data 2 x model 4,
    remat on (3 passes): the modelled records against hand arithmetic."""
    trees, knobs, _ = D.build_cell("gemma-2b", "train_4k", "test8",
                                   smoke=True)
    recs = {c["computation"]: c
            for c in D.cell_collectives(trees, knobs["tcfg"])}
    bf16 = 2
    # FSDP gathers over data (group 2) of each shard, 3 passes; a layer
    # leaf once a layer (2 layers)
    shard = {"embed": 256 * 64 * bf16 // 8,
             "blocks/attn/wq": 64 * 4 * 32 * bf16 // 8,
             "blocks/attn/wk": 64 * 1 * 32 * bf16 // 2,    # 1 kv head: no TP
             "blocks/attn/wv": 64 * 1 * 32 * bf16 // 2,
             "blocks/attn/wo": 4 * 32 * 64 * bf16 // 8,
             "blocks/mlp/w_gate": 64 * 128 * bf16 // 8,
             "blocks/mlp/w_up": 64 * 128 * bf16 // 8,
             "blocks/mlp/w_down": 128 * 64 * bf16 // 8}
    for site, n in shard.items():
        trips = 3 if site == "embed" else 6
        ag = recs[f"fsdp:{site}"]
        assert (ag["op"], ag["group_size"]) == ("all-gather", 2)
        assert ag["operand_bytes"] == n and ag["trip_multiplier"] == trips
        assert ag["total_effective_bytes"] == n * trips       # (g - 1) x
        rs = recs[f"grad:{site}"]
        assert (rs["op"], rs["group_size"]) == ("reduce-scatter", 2)
        assert rs["operand_bytes"] == 2 * n
        assert rs["trip_multiplier"] == trips // 3
    # replicated norms all-reduce their gradients over data
    for site, trips in (("final_norm/w", 1), ("blocks/ln1/w", 2),
                        ("blocks/ln2/w", 2)):
        ar = recs[f"grad:{site}"]
        assert ar["op"] == "all-reduce" and ar["group_size"] == 2
        assert ar["operand_bytes"] == 64 * bf16
        assert ar["trip_multiplier"] == trips
    # tensor-parallel all-reduces of the residual stream (group 4): 128
    # sequences a data rank x 4096 tokens x d 64, bf16
    act = 256 // 2 * 4096 * 64 * bf16
    for site, trips in (("blocks/attn/wo", 6), ("blocks/mlp/w_down", 6),
                        ("embed", 3)):
        ar = recs[f"tp:{site}"]
        assert ar["op"] == "all-reduce" and ar["group_size"] == 4
        assert ar["operand_bytes"] == act and ar["trip_multiplier"] == trips
        assert ar["total_effective_bytes"] == 2 * 3 / 4 * act * trips
    assert len(recs) == 2 * len(shard) + 3 + 3
    summary = A.summarize_collectives(list(recs.values()))
    assert summary["total"]["operand_bytes"] == (
        sum(n * (3 if s == "embed" else 6) for s, n in shard.items())
        + sum(2 * n * (1 if s == "embed" else 2) for s, n in shard.items())
        + 64 * bf16 * 5 + act * 15)


def test_explicit_schedule_by_hand():
    """The explicit threadcomm trainer's records on the multi-pod mesh
    (2 processes x 16 threads): thread reduce-scatter of the float32
    gradient, process allreduce of a 1/16 shard, the norm and metrics
    allreduces, the allgather of the bf16 shard."""
    trees, knobs, _ = D.build_cell("gemma-2b", "train_4k", "multi_pod",
                                   smoke=True, grad_sync="threadcomm")
    plen = trees["plen"]
    assert plen % 32 == 0
    recs = {c["computation"]: c
            for c in D.cell_collectives(trees, knobs["tcfg"])}
    assert recs["explicit:thread_reduce_scatter"]["operand_bytes"] == \
        4 * plen
    assert recs["explicit:thread_reduce_scatter"]["group_size"] == 16
    assert recs["explicit:process_allreduce"]["operand_bytes"] == \
        4 * plen // 16
    assert recs["explicit:process_allreduce"]["group_size"] == 2
    assert recs["explicit:thread_allgather"]["operand_bytes"] == \
        2 * plen // 16
    assert recs["explicit:metrics"]["group_size"] == 32
    # no FSDP: the explicit state's params carry the TP-only specs
    assert not any(k.startswith(("fsdp:", "grad:")) for k in recs)
    assert knobs["tcfg"].remat is False
