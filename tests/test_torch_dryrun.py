"""The port's dry run (``repro_torch.launch.dryrun``) on ``meta``
tensors: the reference test's three cells at smoke size, the depth and
batch extrapolation of the FLOP count against whole traces, the counted
FLOPs against the analytic formula per cell, the argument bytes against
the reference's spec sums, and the modelled collectives and the
temporaries in both residual layouts against bytes worked out by
hand."""

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
    ("gemma-2b", "train_4k"): (0.945, 0.975,
                               "non-reentrant checkpoint stops its "
                               "recompute once the saved tensors are "
                               "back: each block's last product (w_down) "
                               "runs 3x, not the formula's 4x; the "
                               "chunked attention's checkpointed kv "
                               "blocks run their tile products (q.k, "
                               "p.v) once more in the backward"),
    ("mamba2-370m", "decode_32k"): (0.84, 0.87,
                                    "a one-token step runs the recurrence, "
                                    "not the chunked scan's products"),
    # dropless MoE serving: each token's top_k experts (8 of 64), as the
    # formula counts them, plus the router
    ("olmoe-1b-7b", "decode_32k"): (0.999, 1.001,
                                    "top-k dispatch: 8 experts a token"),
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
    remat on (3 passes), its residual stream replicated over the model
    axis (``act_mode="none"``): the modelled records against hand
    arithmetic."""
    trees, knobs, _ = D.build_cell("gemma-2b", "train_4k", "test8",
                                   smoke=True, act_mode="none")
    recs = {c["computation"]: c
            for c in D.cell_collectives(trees, knobs)}
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
            for c in D.cell_collectives(trees, knobs)}
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


def test_sequence_parallel_collectives_by_hand_on_the_test_mesh():
    """The same cell in the reference's default layout (``act_mode="sp"``:
    4096 tokens divide the model axis of 4): each tensor-parallel
    all-reduce of the residual becomes a reduce-scatter of it (``wo``,
    ``w_down``, the embedding lookup) and an all-gather of its sequence
    shard opens each of those blocks and the tied LM head; the pair
    moves the all-reduce's ring bytes. The FSDP and gradient records do
    not change."""
    sp_trees, sp_knobs, _ = D.build_cell("gemma-2b", "train_4k", "test8",
                                         smoke=True)
    assert sp_knobs["act_mode"] == "sp"
    none_trees, none_knobs, _ = D.build_cell(
        "gemma-2b", "train_4k", "test8", smoke=True, act_mode="none")
    sp = {c["computation"]: c
          for c in D.cell_collectives(sp_trees, sp_knobs)}
    none = {c["computation"]: c
            for c in D.cell_collectives(none_trees, none_knobs)}
    act = 256 // 2 * 4096 * 64 * 2          # a data rank's residual, bf16
    for site, trips in (("blocks/attn/wo", 6), ("blocks/mlp/w_down", 6),
                        ("embed", 3)):
        rs, ag = sp[f"tp:{site}"], sp[f"tp:{site}:gather"]
        assert (rs["op"], rs["operand_bytes"], rs["group_size"],
                rs["trip_multiplier"]) == ("reduce-scatter", act, 4, trips)
        assert rs["output_bytes"] == act // 4
        assert (ag["op"], ag["operand_bytes"], ag["group_size"],
                ag["trip_multiplier"]) == ("all-gather", act // 4, 4, trips)
        assert ag["output_bytes"] == act
        # (g-1)/g x act + (g-1) x act/g == the all-reduce's 2(g-1)/g x act
        assert (rs["total_effective_bytes"] + ag["total_effective_bytes"]
                == none[f"tp:{site}"]["total_effective_bytes"]
                == 2 * 3 / 4 * act * trips)
    assert {k: v for k, v in sp.items() if not k.startswith("tp:")} == {
        k: v for k, v in none.items() if not k.startswith("tp:")}
    assert len(sp) == len(none) + 3
    total = A.summarize_collectives(list(sp.values()))["total"]
    base = A.summarize_collectives(list(none.values()))["total"]
    assert total["operand_bytes"] - base["operand_bytes"] == act // 4 * 15
    # the layout, as the reference's build_cell decides it
    shape, mesh = D.SHAPES["train_4k"], D.MESHES["test8"]
    assert D.sequence_parallel(shape, mesh, "sp")
    assert not D.sequence_parallel(shape, mesh, "none")
    assert not D.sequence_parallel(D.SHAPES["decode_32k"], mesh, "sp")
    assert not D.sequence_parallel(shape, D.MESHES["flat8"], "sp")
    assert not D.sequence_parallel(
        ShapeConfig("odd", 4098, 256, "train"), mesh, "sp")
    assert not D.sequence_parallel(
        ShapeConfig("odd_batch", 4096, 3, "train"), mesh, "sp")


def test_logits_gathers_by_hand_on_the_test_mesh():
    """gemma-2b's smoke decode_32k step on data 2 x model 4 returns its
    (128, 256) float32 logits whole on every device: a data rank's 64
    rows x the tied embedding's 64-wide vocab shard gather over the 4
    model ranks (16,384 B), then its 64 rows x 256 over the 2 data ranks
    (65,536 B), once. mamba2-370m's long_500k (one sequence: the batch
    does not divide dp, so it is not sharded) gathers only the vocab:
    1 x 64 x 4 B."""
    trees, knobs, _ = D.build_cell("gemma-2b", "decode_32k", "test8",
                                   smoke=True)
    recs = {c["computation"]: c for c in D.cell_collectives(trees, knobs)}
    assert ({k for k in recs if k.startswith("logits:")}
            == {"logits:embed", "logits:batch"})
    v, b = recs["logits:embed"], recs["logits:batch"]
    assert (v["op"], v["operand_bytes"], v["group_size"], v["num_groups"],
            v["trip_multiplier"]) == ("all-gather", 16384, 4, 2, 1)
    assert (b["op"], b["operand_bytes"], b["group_size"], b["num_groups"],
            b["trip_multiplier"]) == ("all-gather", 65536, 2, 4, 1)
    assert b["output_bytes"] == 128 * 256 * 4     # memory_per_device's
    # a serving step keeps the all-reduces: one token a row, 64 rows
    act = 128 // 2 * 1 * 64 * 2
    assert recs["tp:blocks/mlp/w_down"]["op"] == "all-reduce"
    assert recs["tp:blocks/mlp/w_down"]["operand_bytes"] == act
    trees, knobs, _ = D.build_cell("mamba2-370m", "long_500k", "test8",
                                   smoke=True)
    recs = {c["computation"]: c for c in D.cell_collectives(trees, knobs)}
    assert "logits:batch" not in recs
    assert recs["logits:embed"]["operand_bytes"] == 1 * 64 * 4


def test_temp_bytes_by_hand_under_both_layouts():
    """A train step traced at 1 and 2 layers (peaks 1,100 and 1,200 B)
    fitted to 5 layers: a base of 1,000 B (the depth-0 fit), 600 B of it
    one layer's attention, and 500 B of layers (saved residuals). Over 4
    model devices (the 4 heads divide them): the base is divided in both
    layouts, the layers only under sequence parallelism. Over 8 (they do
    not): attention is whole without sequence parallelism, split by the
    queries' sequence shard with it. A serving step's larger peak is
    scaled to the sequences, then divided."""
    cfg = dataclasses.replace(get_smoke_config("gemma-2b"), num_layers=5)
    assert D.attention_sharded(cfg, 4) and not D.attention_sharded(cfg, 8)
    train = ShapeConfig("t", 64, 4, "train")
    points = {"base": (1,), "batch": 2, (1,): {"peak_bytes": 1100},
              (2,): {"peak_bytes": 1200}, "attn_peak": 600}
    assert D.temp_bytes(cfg, train, points, 2, tp=4,
                        seq_parallel=True) == 1500 / 4
    assert D.temp_bytes(cfg, train, points, 2, tp=4,
                        seq_parallel=False) == 1000 / 4 + 500
    assert D.temp_bytes(cfg, train, points, 2, tp=1,
                        seq_parallel=False) == 1500
    assert D.temp_bytes(cfg, train, points, 2, tp=8,
                        seq_parallel=False) == 400 / 8 + 600 + 500
    assert D.temp_bytes(cfg, train, points, 2, tp=8,
                        seq_parallel=True) == 1500 / 8
    # the attention share is at most the base
    big = dict(points, attn_peak=4000)
    assert D.temp_bytes(cfg, train, big, 2, tp=8,
                        seq_parallel=False) == 1000 + 500
    decode = ShapeConfig("d", 64, 4, "decode")
    points = {"base": (0,), "batch": 1, (0,): {"peak_bytes": 300},
              (1,): {"peak_bytes": 700}}
    for sp in (True, False):
        assert D.temp_bytes(cfg, decode, points, 6, tp=4,
                            seq_parallel=sp) == 700 * 6 / 4
    # through analyze_cell: the cell's own traces, both layouts
    got = {}
    for mode in ("sp", "none"):
        trees, knobs, meta = D.build_cell("gemma-2b", "train_4k", "test8",
                                          smoke=True, act_mode=mode)
        a = D.analyze_cell(trees, knobs, meta)["analysis"]
        tr = {tuple(t["depth"]): t["peak_bytes"]
              for t in a["counted"]["traces"]}
        layers = 2 * (tr[(2,)] - tr[(1,)])
        base = tr[(1,)] - (tr[(2,)] - tr[(1,)])
        got[mode] = a["memory_analysis"]["temp_size_in_bytes"]
        want = base / 4 + layers / (4 if mode == "sp" else 1)
        assert got[mode] == int(want)
        assert a["seq_parallel"] == (mode == "sp")
    # the saved residual a layer: 128 sequences x 4096 x d 64, bf16
    assert tr[(2,)] - tr[(1,)] == 128 * 4096 * 64 * 2
    assert got["none"] - got["sp"] == int(3 / 4 * 2 * 128 * 4096 * 64 * 2)


def test_serving_temp_bytes_by_hand_follow_the_head_rule():
    """A serving step's peak (700 B, the larger of its traces at one
    sequence), 600 B of it one layer's attention traced alone, scaled to
    6 sequences: over 4 model devices (the 4 heads divide them) all of it
    is divided; over 8 (they do not) only the other 100 B, the attention
    whole on every device of the model group; the share is at most the
    peak."""
    cfg = get_smoke_config("gemma-2b")
    decode = ShapeConfig("d", 64, 4, "decode")
    points = {"base": (0,), "batch": 1, (0,): {"peak_bytes": 300},
              (1,): {"peak_bytes": 700}, "attn_peak": 600}
    for sp in (True, False):
        assert D.temp_bytes(cfg, decode, points, 6, tp=4,
                            seq_parallel=sp) == 700 * 6 / 4
        assert D.temp_bytes(cfg, decode, points, 6, tp=8,
                            seq_parallel=sp) == (100 / 8 + 600) * 6
    big = dict(points, attn_peak=4000)
    assert D.temp_bytes(cfg, decode, big, 6, tp=8,
                        seq_parallel=False) == 700 * 6
