"""The port's training path (``repro_torch.optim``, ``data``, ``dist``,
``train``, ``launch.train`` and the training functions of ``models``)
against the JAX reference on the CPU, in float32.

Inputs are the reference's own: its parameters moved over through
``interop.params_from_numpy``, the synthetic pipeline's batches (numpy,
byte-equal on both sides), other arrays drawn by numpy from a seed.
Gradients come back through ``interop.tree_to_numpy`` and compare leaf by
leaf under the reference's tree paths. Tolerances: the optimizer and the
schedule 1e-6 (elementwise float32 arithmetic in the same order); the
chunked cross-entropy 1e-5 (one chunked sum); a whole model's loss and
gradients 1e-4 relative (float32 matmuls summed in other orders through
a few layers); train steps 1e-5 (Adam normalises each update).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import MeshConfig as JMeshConfig
from repro.config import ServeConfig as JServeConfig
from repro.config import TrainConfig as JTrainConfig
from repro.configs import ARCH_NAMES as JARCH_NAMES
from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import SyntheticPipeline as JPipeline
from repro.models.registry import build_model as jax_build_model
from repro_torch.config import MeshConfig, ServeConfig, TrainConfig
from repro_torch.configs import ARCH_NAMES, get_smoke_config
from repro_torch.data import SyntheticPipeline
from repro_torch.interop import (named_leaves, params_from_numpy,
                                 tree_leaves, tree_map, tree_to_numpy)
from repro_torch.models.registry import build_model

KW = dict(param_dtype="float32", compute_dtype="float32", loss_chunk=16,
          attn_chunk_threshold=64, attn_chunk=16, remat=True)
FAMILIES = ["gemma-2b", "internvl2-76b", "olmoe-1b-7b", "mamba2-370m",
            "hymba-1.5b", "whisper-tiny"]


def close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def both(arch, seed=0, **kw):
    """(reference model, its params, port model, the same params)."""
    tk = {**KW, **kw}
    jmodel = jax_build_model(jax_smoke_config(arch), JTrainConfig(**tk),
                             JServeConfig(), tp=1)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    cfg = get_smoke_config(arch)
    model = build_model(cfg, ServeConfig(), device="cpu",
                        train=TrainConfig(**tk))
    return jmodel, jparams, model, params_from_numpy(np_tree(jparams), cfg)


def batch_for(arch, B=4, S=32, step=0):
    cfg = get_smoke_config(arch)
    if cfg.frontend == "patch_stub":
        S = cfg.num_frontend_tokens + 16
    return SyntheticPipeline(cfg, batch=B, seq_len=S, seed=0).get_batch(step)


def tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def check_tree(got, want, tol):
    """A port tree (tensors) against the reference's (arrays), leaf by
    leaf under the reference's names, relative to each leaf's max."""
    got = tree_to_numpy(got)
    names = [x.name for x in named_leaves(got)]
    assert names == ["/".join(str(p.key) for p in path) for path, _ in
                     jax.tree_util.tree_leaves_with_path(want)]
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            [t.tensors[0] for t in named_leaves(got)]):
        w = np.asarray(w)
        scale = max(1.0, float(np.abs(w).max()))
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g / scale, w / scale, atol=tol, rtol=0,
                                   err_msg=str(path))


# ---------------------------------------------------------------------------
# optimizer and schedule
# ---------------------------------------------------------------------------

def test_cosine_schedule_matches_reference():
    from repro.optim import cosine_schedule as jsched
    from repro_torch.optim import cosine_schedule
    ours, ref = cosine_schedule(3e-3, 10, 100), jsched(3e-3, 10, 100)
    for s in (0, 1, 5, 9, 10, 11, 50, 99, 100, 250):
        close(float(ours(s)), float(ref(s)), 1e-6)
        close(float(ours(torch.tensor(s, dtype=torch.int32))),
              float(ref(jnp.int32(s))), 1e-6)


def _adam_trees(dtype, seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "b": {"w": (11,), "z": (3, 2, 4)}}

    def draw(scale):
        return jax.tree_util.tree_map(
            lambda s: (scale * rng.standard_normal(s)).astype(np.float32),
            shapes, is_leaf=lambda s: isinstance(s, tuple))
    return draw(1.0), [draw(0.3), draw(3.0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 100.0, 0.0])
def test_adamw_update_matches_reference(dtype, clip):
    """Two AdamW steps (the first clipped at clip 1.0), with a float32
    master for a bf16 model; params, moments and master to 1e-6."""
    from repro.optim import adamw_init as jinit
    from repro.optim import adamw_update as jupdate
    from repro_torch.optim import adamw_init, adamw_update
    params, grads = _adam_trees(dtype, 3)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), params)
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(a).to(tdt), params)
    jst, st = jinit(jp), adamw_init(tp)
    assert (st.master is None) == (jst.master is None)
    kw = dict(beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1,
              grad_clip=clip)
    for i, g in enumerate(grads):
        lr = 1e-2 * (i + 1)
        jp, jst, jm = jupdate(jnp_tree(g), jst, jp, lr=lr, **kw)
        tp, st, m = adamw_update(
            jax.tree_util.tree_map(torch.from_numpy, g), st, tp, lr=lr, **kw)
        close(float(m["grad_norm"]), float(jm["grad_norm"]), 1e-6)
        close(float(m["lr"]), float(jm["lr"]), 1e-6)
    assert int(st.step) == int(jst.step) == 2
    for ours, ref in ((tp, jp), (st.m, jst.m), (st.v, jst.v)) + (
            ((st.master, jst.master),) if st.master is not None else ()):
        for a, b in zip(tree_leaves(ours), jax.tree_util.tree_leaves(ref)):
            close(a.float().numpy(), np.asarray(b, np.float32), 1e-6)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_pipeline_batches_byte_equal(arch):
    assert tuple(ARCH_NAMES) == tuple(JARCH_NAMES)
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    S = cfg.num_frontend_tokens + 12 if cfg.frontend == "patch_stub" else 12
    ours = SyntheticPipeline(cfg, batch=4, seq_len=S, seed=3)
    ref = JPipeline(jcfg, batch=4, seq_len=S, seed=3)
    for step in (0, 7):
        a, b = ours.get_batch(step), ref.get_batch(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes(), k
        for k, v in ours.shard_slice(step, 1, 2).items():
            assert v.tobytes() == ref.shard_slice(step, 1, 2)[k].tobytes()
    assert ours.state_dict(5) == ref.state_dict(5)
    again = SyntheticPipeline.from_state(cfg, 4, S, ours.state_dict(5))
    assert again.get_batch(2)["tokens"].tobytes() == \
        ours.get_batch(2)["tokens"].tobytes()


@pytest.mark.parametrize("arch", FAMILIES)
def test_batch_spec_and_synthetic_batch_match_reference(arch):
    """Names, shapes and dtypes of a train batch against the reference's
    ``batch_spec``; a synthetic batch fits its spec, tokens in the
    vocabulary, and is the same for the same seed."""
    from repro.config import ShapeConfig as JShapeConfig
    from repro.models.registry import batch_spec as jspec
    from repro.models.registry import make_synthetic_batch as jbatch
    from repro_torch.config import ShapeConfig
    from repro_torch.models.registry import batch_spec, make_synthetic_batch
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    S = cfg.num_frontend_tokens + 8 if cfg.frontend == "patch_stub" else 8
    ours = batch_spec(cfg, ShapeConfig("t", S, 3, "train"), "float32")
    ref = jspec(jcfg, JShapeConfig("t", S, 3, "train"), "float32")
    assert sorted(ours) == sorted(ref)
    for k, spec in ours.items():
        assert spec.shape == ref[k].shape, k
        assert str(spec.dtype).split(".")[-1] == str(ref[k].dtype), k
    b = make_synthetic_batch(cfg, 3, S, seed=2, compute_dtype="float32",
                             device="cpu")
    jb = jbatch(jcfg, 3, S, seed=2, compute_dtype="float32")
    again = make_synthetic_batch(cfg, 3, S, seed=2, compute_dtype="float32",
                                 device="cpu")
    for k, spec in ours.items():
        assert tuple(b[k].shape) == spec.shape == jb[k].shape, k
        assert b[k].dtype == spec.dtype and torch.equal(b[k], again[k]), k
        if spec.dtype == torch.int32:
            assert 0 <= int(b[k].min()) and int(b[k].max()) < cfg.vocab_size


# ---------------------------------------------------------------------------
# losses and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,chunk", [(32, 16), (40, 16), (8, 64)])
def test_chunked_cross_entropy_value_and_grad(S, chunk):
    """Ragged tails, masked labels and a padded vocabulary (250 of 256)."""
    from repro.models.layers import chunked_cross_entropy as jce
    from repro_torch.models.layers import chunked_cross_entropy
    rng = np.random.default_rng(S)
    B, d, Vp, V = 2, 24, 256, 250
    h = rng.standard_normal((B, S, d)).astype(np.float32)
    w = (0.2 * rng.standard_normal((d, Vp))).astype(np.float32)
    lbl = rng.integers(0, V, (B, S)).astype(np.int32)
    ok = rng.random((B, S)) > 0.2

    def jf(h, w):
        s, n = jce(h, w, jnp.asarray(lbl), valid=jnp.asarray(ok),
                   vocab_size=V, chunk=chunk)
        return s / n, (s, n)
    (jl, (js, jn)), (jgh, jgw) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    s, n = chunked_cross_entropy(th, tw, torch.from_numpy(lbl),
                                 valid=torch.from_numpy(ok), vocab_size=V,
                                 chunk=chunk)
    gh, gw = torch.autograd.grad(s / n, (th, tw))
    close(float(s.detach()), float(js), 1e-5)
    assert float(n) == float(jn) == ok.sum()
    close(gh.numpy(), np.asarray(jgh), 1e-5)
    close(gw.numpy(), np.asarray(jgw), 1e-5)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_loss_and_grads_match_reference(arch):
    """Every family's smoke config (dense, patch_stub, MoE with capacity
    drops, SSM, hybrid, enc-dec) with remat on: loss, aux metrics and
    every gradient leaf."""
    from repro_torch.train.trainer import value_and_grad
    jmodel, jparams, model, params = both(arch)
    b = batch_for(arch)
    (jl, jmet), jg = jax.value_and_grad(jmodel.train_loss, has_aux=True)(
        jparams, jnp_tree(b))
    loss, met, grads = value_and_grad(model.train_loss, params, tbatch(b))
    assert sorted(met) == sorted(jmet)
    for k in met:
        close(float(met[k]), float(jmet[k]), 1e-4)
    if arch == "olmoe-1b-7b":
        assert float(met["moe_dropped"]) > 0
    check_tree(grads, jg, 1e-4)


def test_moe_routing_drops_match_reference():
    """Capacity-bounded routing of one group with heavy drops: the kept
    entries' outputs and the aux terms, with tied router scores."""
    from repro.models.moe import moe_apply as jmoe
    from repro_torch.models.moe import moe_apply
    jmodel, jparams, model, params = both("olmoe-1b-7b")
    p = params["blocks"][0]["moe"]
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"]["moe"])
    cfg = get_smoke_config("olmoe-1b-7b")
    x = np.random.default_rng(1).standard_normal(
        (3, 50, cfg.d_model)).astype(np.float32)
    x[:, 10:20] = x[:, :1]                      # tied tokens, tied scores
    out, aux = moe_apply(p, torch.from_numpy(x), cfg)
    jout, jaux = jmoe(jp, jnp.asarray(x), cfg)
    close(out.numpy(), np.asarray(jout), 1e-5)
    for k in aux:
        close(float(aux[k]), float(jaux[k]), 1e-6)
    assert float(aux["moe_dropped"]) > 0


# ---------------------------------------------------------------------------
# the one-card step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 2])
def test_spmd_steps_match_reference(microbatches):
    """3 steps of yi-9b's smoke config: losses, gradient norms, params
    and the optimizer state."""
    from repro.train.trainer import init_train_state as jinit
    from repro.train.trainer import make_train_step as jmake
    from repro_torch.optim import adamw_init
    from repro_torch.train.trainer import TrainState, make_train_step
    kw = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10,
              microbatches=microbatches, remat=False)
    jmodel, _, model, _ = both("yi-9b", **kw)
    jcfg = JTrainConfig(**{**KW, **kw})
    jstate = jinit(jmodel, jax.random.PRNGKey(0))
    params = params_from_numpy(np_tree(jstate.params), model.cfg)
    state = TrainState(params, adamw_init(params))
    mesh_cfg = MeshConfig(shape=(1,), axis_names=("data",))
    jstep = jax.jit(jmake(jmodel, JMeshConfig((1,), ("data",)), jcfg))
    step = make_train_step(model, mesh_cfg, TrainConfig(**{**KW, **kw}))
    pipe = SyntheticPipeline(model.cfg, batch=8, seq_len=16, seed=0)
    for i in range(3):
        b = pipe.get_batch(i)
        jstate, jm = jstep(jstate, jnp_tree(b))
        state, m = step(state, tbatch(b))
        for k in ("loss", "grad_norm", "lr"):
            close(float(m[k]), float(jm[k]), 1e-5)
    check_tree(state.params, jstate.params, 1e-5)
    check_tree(state.opt.m, jstate.opt.m, 1e-5)
    check_tree(state.opt.v, jstate.opt.v, 1e-5)


def test_eval_step_is_the_loss_without_gradients():
    from repro_torch.train.trainer import make_eval_step
    _, _, model, params = both("gemma-2b")
    b = tbatch(batch_for("gemma-2b"))
    met = make_eval_step(model, MeshConfig((1,), ("data",)))(params, b)
    loss, _ = model.train_loss(params, b)
    assert float(met["loss"]) == float(loss)
    assert not met["loss"].requires_grad


# ---------------------------------------------------------------------------
# sharding specs and the mesh
# ---------------------------------------------------------------------------

def spec_leaves(tree, path=()):
    """(name, [specs]) of a port spec tree in the reference's order: a
    ``P`` is a leaf (it subclasses tuple), a layer list one stacked leaf
    a name."""
    from repro_torch.core.compat import P
    if isinstance(tree, P):
        return [("/".join(path), [tree])]
    if isinstance(tree, list):
        per = [dict(spec_leaves(t, path)) for t in tree]
        return [(k, [s for d in per for s in d[k]]) for k in per[0]]
    return [x for k in sorted(tree) for x in spec_leaves(tree[k],
                                                          path + (k,))]


@pytest.mark.parametrize("arch", ["gemma-2b", "olmoe-1b-7b", "hymba-1.5b",
                                  "whisper-tiny"])
def test_param_and_cache_pspecs_match_reference(arch):
    """The reference's spec of a stacked leaf less its L entry is the
    port's spec of every layer's leaf."""
    from repro.dist.sharding import cache_pspecs as jcache
    from repro.dist.sharding import param_pspecs as jspecs
    from repro_torch.dist.sharding import (batch_pspec, cache_pspecs,
                                           param_pspecs)
    jmodel, jparams, model, params = both(arch)
    for shape, names in (((2, 4), ("data", "model")),
                         ((2, 2, 2), ("pod", "data", "model"))):
        proc = ("pod",) if "pod" in names else ()
        mc = MeshConfig(shape, names, process_axes=proc)
        jmc = JMeshConfig(shape, names, process_axes=proc)
        for fsdp in (True, False):
            ours = param_pspecs(model.cfg, mc, params, fsdp=fsdp)
            ref = jspecs(jmodel.cfg, jmc, jparams, fsdp=fsdp)
            refs = jax.tree_util.tree_leaves_with_path(
                ref, is_leaf=lambda s: isinstance(
                    s, jax.sharding.PartitionSpec))
            mine = spec_leaves(ours)
            assert len(mine) == len(refs)
            for (name, specs), (path, spec) in zip(mine, refs):
                assert name == "/".join(str(p.key) for p in path)
                want = tuple(spec)
                if len(specs) > 1 or name.split("/")[0].endswith("blocks"):
                    want = want[1:]            # the stacked L entry
                want = want if any(want) else ()
                for got in specs:              # every layer the same spec
                    assert tuple(got) == want, (name, got, spec)
        assert tuple(batch_pspec(mc)) == tuple(
            __import__("repro.dist.sharding", fromlist=["x"]).batch_pspec(
                jmc))
        if not model.cfg.is_encoder_decoder:
            cache = model.init_cache(4, 8)
            jc = jmodel.init_cache(4, 8)
            ours = cache_pspecs(model.cfg, mc, cache)
            ref = jcache(jmodel.cfg, jmc, jc)
            for k in ours:
                if k != "pos":
                    assert tuple(ours[k]) == tuple(ref[k]), k


def test_mesh_from_config_on_the_cpu():
    from repro_torch.launch.mesh import (make_mesh_from_config,
                                         production_mesh_config)
    mesh = make_mesh_from_config(MeshConfig((2, 2, 2),
                                            ("pod", "data", "model")),
                                 device="cpu")
    assert mesh.shape == {"pod": 2, "data": 2, "model": 2}
    assert mesh.device.type == "cpu"
    assert production_mesh_config(multi_pod=True).dp == 32
    assert production_mesh_config().tp == 16


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _state(dtype="float32", seed=0):
    from repro_torch.train.trainer import init_train_state
    cfg = get_smoke_config("hymba-1.5b")
    model = build_model(cfg, ServeConfig(), device="cpu",
                        train=TrainConfig(param_dtype=dtype,
                                          compute_dtype=dtype))
    return init_train_state(model, seed)


def _equal_trees(a, b):
    la, lb = named_leaves(a), named_leaves(b)
    assert [x.name for x in la] == [x.name for x in lb]
    for x, y in zip(la, lb):
        for s, t in zip(x.tensors, y.tensors):
            assert s.dtype == t.dtype and torch.equal(s, t), x.name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_roundtrip(tmp_path, dtype):
    """A bf16 state (with its f32 master) and an f32 one (no master)."""
    from repro_torch.train import checkpoint as ckpt
    state = _state(dtype)
    ckpt.save(str(tmp_path), 7, state, extra={"seed": 0, "step": 7})
    out, step, extra = ckpt.restore(str(tmp_path),
                                    tree_map(torch.zeros_like, _state(
                                        dtype, seed=1)))
    assert step == 7 and extra == {"seed": 0, "step": 7}
    _equal_trees(out, state)
    with np.load(tmp_path / "step_00000007" / "arrays.npz") as z:
        assert z["params/blocks/attn/wq"].shape[0] == \
            get_smoke_config("hymba-1.5b").num_layers


def test_checkpoint_keep_async_and_atomic(tmp_path):
    from repro_torch.train import checkpoint as ckpt
    state = _state()
    for s in range(1, 6):
        t = ckpt.save(str(tmp_path), s, state, keep=2, async_save=True)
        t.join()
    assert sorted(os.listdir(tmp_path)) == ["step_00000004", "step_00000005"]
    # a half-written step (a killed job's tmp dir) is never picked
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert ckpt.latest_step(str(tmp_path / "nowhere")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "nowhere"), state)


def test_checkpoint_refuses_shape_mismatch_and_missing_leaf(tmp_path):
    from repro_torch.train import checkpoint as ckpt
    state = _state()
    ckpt.save(str(tmp_path), 1, state)
    bad = tree_map(torch.zeros_like, state)
    bad.params["embed"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(str(tmp_path), bad)
    extra = tree_map(torch.zeros_like, state)
    extra.params["final_norm"]["extra"] = torch.zeros(2)
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore(str(tmp_path), extra)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """The other direction of the explicit tests' reference-written
    checkpoint: the reference restores the port's TrainState."""
    from repro.train import checkpoint as jckpt
    from repro.train.trainer import init_train_state as jinit
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import init_train_state
    jmodel, _, model, _ = both("olmoe-1b-7b")
    state = init_train_state(model, 4)
    ckpt.save(str(tmp_path), 3, state)
    jstate, step, _ = jckpt.restore(str(tmp_path),
                                    jinit(jmodel, jax.random.PRNGKey(0)))
    assert step == 3
    check_tree(state.params, jstate.params, 0.0)
    check_tree(state.opt.v, jstate.opt.v, 0.0)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launch_train_smoke_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --smoke --device cpu`` for 2
    steps, checkpointing each, on the default one-device mesh and on a
    (2, 2, 1) threadcomm mesh; then a resume of the latter runs the
    third."""
    from repro_torch.launch import train
    for mesh, sync in (("1", "spmd"), ("2,2,1", "threadcomm")):
        args = ["--arch", "gemma-2b", "--smoke", "--device", "cpu",
                "--batch", "4", "--seq", "16", "--ckpt-dir",
                str(tmp_path / sync), "--ckpt-every", "1", "--mesh", mesh,
                "--grad-sync", sync]
        train.main(args + ["--steps", "2"])
        out = capsys.readouterr().out
        assert "arch=gemma-smoke" in out and "step     1 loss" in out
        assert out.strip().endswith("done.")
    tmp_path = tmp_path / "threadcomm"
    res = train.run_train("gemma-2b", smoke=True, device="cpu", batch=4,
                          seq=16, steps=3, ckpt_dir=str(tmp_path),
                          resume=True, mesh="2,2,1",
                          grad_sync="threadcomm", log=lambda s: None)
    assert res["start"] == 2 and len(res["losses"]) == 1
    assert np.isfinite(res["losses"]).all()
