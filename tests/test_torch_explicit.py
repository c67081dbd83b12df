"""The port's explicit threadcomm trainer (``repro_torch.train.explicit``)
against the JAX reference's, on the mesh (pod 2, data 2, model 2).

The reference runs once, in ONE subprocess with 8 fake host devices (this
file run as ``python -m tests.test_torch_explicit OUT.npz``): from its
own ``init`` it takes 3 steps of the yi-9b smoke config in each mode —
``threadcomm`` (reduce_scatter on thread_comm, iallreduce on
process_comm inside the "grad" stream), ``flat`` (one root allreduce)
and ``threadcomm`` with the bfloat16 wire — on the synthetic pipeline's
batches, and it writes a checkpoint of its one-device spmd state. The
port starts from the same parameters (moved through ``interop``) and
takes the same steps on one rank-stacked program. Held equal: the
losses and gradient norms of every step, the parameters, and the flat
optimizer vectors ``master``/``m``/``v`` element for element (the port's
flat order is the reference's), after the first step and after the
last. Both sides sum in float32 in other orders: rtol = atol = 1e-5, the
reference's own tolerance for its collectives. The step counter exactly.

The bf16 wire after step 1 is the exception, and the reason is the
reference's: each rank adds its own float32 shard to its peer's bfloat16
copy, so the two processes' optimizer states part (at step 1 their
parameters still agree: Adam's first update is the gradient's sign).
The reference declares the state replicated but keeps each device's
own copy from step to step, so its processes run apart; the port's
region returns rank 0's (process 0's) state each step, and re-replicates
it. After step 1 the port is held to the reference's process-0 view
within the spread of the reference's own replicas (both measured here),
and its losses to the reference's within 1e-4, the bound of the
reference's grad-sync parity case (``tests/mp_cases.py``).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "yi-9b"
MESH = ((2, 2, 2), ("pod", "data", "model"))
BATCH, SEQ, STEPS = 8, 16, 3
MODES = {"threadcomm": ("threadcomm", "float32"),
         "flat": ("flat", "float32"),
         "bf16_wire": ("threadcomm", "bfloat16")}
TOL = 1e-5


def train_kw(mode, wire):
    return dict(param_dtype="float32", compute_dtype="float32",
                loss_chunk=16, attn_chunk_threshold=64, remat=False,
                grad_sync=mode, grad_comm_dtype=wire, learning_rate=1e-2,
                warmup_steps=1, total_steps=10)


# ---------------------------------------------------------------------------
# the reference side: runs with 8 fake host devices, in a subprocess
# ---------------------------------------------------------------------------

def replica_spread(arr) -> float:
    """Largest difference between two devices' copies of one shard of a
    jax Array (0 when its replicas agree)."""
    by_index = {}
    for sh in arr.addressable_shards:
        key = tuple((s.start, s.stop) for s in sh.index)
        by_index.setdefault(key, []).append(np.asarray(sh.data))
    return max(float(np.abs(c - cs[0]).max()) for cs in by_index.values()
               for c in cs)


def reference_outputs(ckpt_dir):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro.config import MeshConfig, ServeConfig, TrainConfig
    from repro.configs import get_smoke_config
    from repro.core.compat import make_mesh
    from repro.data import SyntheticPipeline
    from repro.dist.sharding import batch_pspec
    from repro.models.registry import build_model
    from repro.train import checkpoint as ckpt
    from repro.train.explicit import flatten_tree, init_explicit_state
    from repro.train.trainer import init_train_state, make_train_step

    cfg = get_smoke_config(ARCH)
    mesh_cfg = MeshConfig(shape=MESH[0], axis_names=MESH[1],
                          process_axes=("pod",))
    mesh = make_mesh(*MESH)
    pipe = SyntheticPipeline(cfg, batch=BATCH, seq_len=SEQ, seed=0)
    b_shard = NamedSharding(mesh, batch_pspec(mesh_cfg))
    out = {}
    for tag, (mode, wire) in MODES.items():
        tcfg = TrainConfig(**train_kw(mode, wire))
        model = build_model(cfg, tcfg, ServeConfig(), tp=2)
        state = init_explicit_state(model, jax.random.PRNGKey(0), dp=4)
        if "params0" not in out:
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                    state.params):
                name = "/".join(str(p.key) for p in path)
                out[f"p0/{name}"] = np.asarray(leaf)
        step = make_train_step(model, mesh_cfg, tcfg, mesh=mesh)
        losses, norms = [], []
        for i in range(STEPS):
            batch = {k: jax.device_put(jnp.asarray(v), b_shard)
                     for k, v in pipe.get_batch(i).items()}
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            if i in (0, STEPS - 1):
                at = f"{tag}/{i + 1}"
                out[f"{at}/params"] = np.asarray(flatten_tree(state.params))
                for k in ("master", "m", "v", "step"):
                    out[f"{at}/{k}"] = np.asarray(getattr(state.opt, k))
                out[f"{at}/replica_spread"] = np.array(max(
                    replica_spread(a) for a in jax.tree_util.tree_leaves(
                        (state.params, state.opt.master))))
        out[f"{tag}/loss"] = np.array(losses)
        out[f"{tag}/grad_norm"] = np.array(norms)
    # a checkpoint of the one-device spmd state, for the port to restore
    tcfg = TrainConfig(**train_kw("spmd", "float32"))
    model = build_model(cfg, tcfg, ServeConfig(), tp=1)
    state = init_train_state(model, jax.random.PRNGKey(1))
    step = jax.jit(make_train_step(model, mesh_cfg, tcfg))
    state, _ = step(state, {k: jnp.asarray(v)
                            for k, v in pipe.get_batch(0).items()})
    ckpt.save(ckpt_dir, 1, state, extra={"writer": "reference"})
    out["params0"] = np.zeros(())
    return out


# ---------------------------------------------------------------------------
# the port side
# ---------------------------------------------------------------------------

def nested(flat, prefix):
    """{"p0/a/b": x} -> {"a": {"b": x}}."""
    tree = {}
    for k, v in flat.items():
        if not k.startswith(prefix + "/"):
            continue
        node = tree
        *head, last = k[len(prefix) + 1:].split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("explicit")
    path = d / "reference.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src"), ROOT,
                    os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-m", "tests.test_torch_explicit",
                           str(path), str(d / "ckpt")], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(path) as z:
        out = dict(z)
    out["ckpt_dir"] = str(d / "ckpt")
    return out


def port_run(reference, tag, mesh_shape=MESH[0]):
    from repro_torch.config import MeshConfig, ServeConfig, TrainConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.compat import make_mesh
    from repro_torch.data import SyntheticPipeline
    from repro_torch.interop import params_from_numpy
    from repro_torch.models.registry import build_model
    from repro_torch.train.explicit import (ExplicitTrainState,
                                            FlatAdamState, flatten_tree,
                                            padded_len)
    from repro_torch.train.trainer import make_train_step

    mode, wire = MODES[tag]
    cfg = get_smoke_config(ARCH)
    mesh_cfg = MeshConfig(shape=mesh_shape, axis_names=MESH[1],
                          process_axes=("pod",))
    mesh = make_mesh(mesh_shape, MESH[1], device="cpu")
    tcfg = TrainConfig(**train_kw(mode, wire))
    model = build_model(cfg, ServeConfig(), device="cpu", train=tcfg)
    params = params_from_numpy(nested(reference, "p0"), cfg)
    plen = padded_len(params, mesh_cfg.dp)
    flat = flatten_tree(params)
    state = ExplicitTrainState(params=params, opt=FlatAdamState(
        step=torch.zeros((), dtype=torch.int32),
        m=torch.zeros(plen), v=torch.zeros(plen),
        master=torch.nn.functional.pad(flat, (0, plen - flat.numel()))))
    step = make_train_step(model, mesh_cfg, tcfg, mesh=mesh)
    pipe = SyntheticPipeline(cfg, batch=BATCH, seq_len=SEQ, seed=0)
    metrics, states = [], {}
    for i in range(STEPS):
        state, met = step(state, {k: torch.from_numpy(v) for k, v in
                                  pipe.get_batch(i).items()})
        metrics.append(met)
        if i in (0, STEPS - 1):
            states[i + 1] = snapshot(state)
    step.comm.finish()
    return state, metrics, states


def snapshot(state):
    from repro_torch.train.explicit import flatten_tree
    return {"params": flatten_tree(state.params).numpy(),
            **{k: getattr(state.opt, k).clone().numpy()
               for k in ("master", "m", "v", "step")}}


@pytest.fixture(scope="module")
def port(reference):
    return {tag: port_run(reference, tag) for tag in MODES}


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("tag", list(MODES))
def test_losses_and_norms_match_reference(reference, port, tag):
    _, metrics, _ = port[tag]
    got = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    n = 1 if tag == "bf16_wire" else STEPS
    close(got[:n], reference[f"{tag}/loss"][:n])
    close(norms[:n], reference[f"{tag}/grad_norm"][:n])
    np.testing.assert_allclose(got, reference[f"{tag}/loss"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("tag", list(MODES))
@pytest.mark.parametrize("at", [1, STEPS])
def test_params_and_flat_state_match_reference(reference, port, tag, at):
    states = port[tag][2]
    spread = float(reference[f"{tag}/{at}/replica_spread"])
    for k in ("params", "master", "m", "v"):
        got, want = states[at][k], reference[f"{tag}/{at}/{k}"]
        assert got.shape == want.shape
        if tag == "bf16_wire" and at > 1:
            assert np.abs(got - want).max() <= spread, k
        else:
            close(got, want)
    assert int(states[at]["step"]) == int(reference[f"{tag}/{at}/step"]) \
        == at


@pytest.mark.parametrize("tag", list(MODES))
def test_reference_replicas(reference, tag):
    """The reference's own replicas of the state: equal in float32 at
    every step and in bf16 at step 1; apart in bf16 after it."""
    for at in (1, STEPS):
        spread = float(reference[f"{tag}/{at}/replica_spread"])
        if tag == "bf16_wire" and at > 1:
            assert spread > 0
        else:
            assert spread == 0.0


@pytest.mark.parametrize("tag", list(MODES))
def test_every_rank_holds_the_same_params(port, tag):
    """A P() output of the region takes rank 0's params; the step reports
    how far every rank's stand from them. The float32 syncs give every
    rank the same update; the bf16 wire adds each rank's own float32
    shard to its peer's bfloat16 copy (the reference's schedule), so the
    two processes part."""
    _, metrics, _ = port[tag]
    spread = max(float(m["params_rank_spread"]) for m in metrics)
    if tag == "bf16_wire":
        assert spread > 0
    else:
        assert spread == 0.0


def test_bf16_wire_stays_near_float32(port):
    """The reference's own bound (``tests/mp_cases.py``): 2e-2."""
    a = [float(m["loss"]) for m in port["bf16_wire"][1]]
    b = [float(m["loss"]) for m in port["threadcomm"][1]]
    assert a != b
    np.testing.assert_allclose(a, b, rtol=2e-2, atol=2e-2)


def test_bf16_wire_runs_msgq_rounds(reference):
    """The bf16-wire slow-domain allreduce is one msgq message round a
    step at two processes (a plain-version call on the CPU); the float32
    schedules run none."""
    from repro_torch.kernels.msgq import ops as msgq
    msgq.reset_counters()
    port_run(reference, "threadcomm")
    assert msgq.ref_calls == 0
    port_run(reference, "bf16_wire")
    assert msgq.ref_calls == STEPS


def test_elastic_remesh_continues_the_run(reference, port, tmp_path):
    """The threadcomm state checkpointed on (2, 2, 2) restores onto
    (1, 4, 2) — another process/thread split, the same dp — and one more
    step there equals that step on the original mesh to float32
    rounding."""
    from repro_torch.config import MeshConfig, ServeConfig, TrainConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.compat import make_mesh
    from repro_torch.data import SyntheticPipeline
    from repro_torch.interop import tree_map
    from repro_torch.models.registry import build_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.explicit import flatten_tree
    from repro_torch.train.trainer import make_train_step

    state = port["threadcomm"][0]
    ckpt.save(str(tmp_path), STEPS, state)
    cfg = get_smoke_config(ARCH)
    tcfg = TrainConfig(**train_kw("threadcomm", "float32"))
    model = build_model(cfg, ServeConfig(), device="cpu", train=tcfg)
    batch = {k: torch.from_numpy(v) for k, v in SyntheticPipeline(
        cfg, batch=BATCH, seq_len=SEQ, seed=0).get_batch(STEPS).items()}
    outs = []
    for shape in (MESH[0], (1, 4, 2)):
        template = tree_map(torch.zeros_like, state)
        restored, at, _ = ckpt.restore(str(tmp_path), template)
        assert at == STEPS
        mesh_cfg = MeshConfig(shape=shape, axis_names=MESH[1],
                              process_axes=("pod",))
        step = make_train_step(model, mesh_cfg, tcfg,
                               mesh=make_mesh(shape, MESH[1], device="cpu"))
        new, met = step(restored, batch)
        step.comm.finish()
        outs.append((float(met["loss"]), flatten_tree(new.params).numpy(),
                     new.opt.master.numpy()))
    close(outs[0][0], outs[1][0])
    close(outs[0][1], outs[1][1])
    close(outs[0][2], outs[1][2])


def test_reference_checkpoint_restores_in_the_port(reference):
    """A checkpoint the reference wrote (its one-device spmd state after
    one step) restores into the port's TrainState leaf for leaf."""
    from repro_torch.config import ServeConfig, TrainConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.interop import tree_to_numpy
    from repro_torch.models.registry import build_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import init_train_state

    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, ServeConfig(), device="cpu",
                        train=TrainConfig(**train_kw("spmd", "float32")))
    template = init_train_state(model, 5)
    state, at, extra = ckpt.restore(reference["ckpt_dir"], template)
    assert at == 1 and extra == {"writer": "reference"}
    assert int(state.opt.step) == 1 and state.opt.master is None
    with np.load(os.path.join(reference["ckpt_dir"], "step_00000001",
                              "arrays.npz")) as z:
        for part in ("params", "opt/m", "opt/v"):
            tree = {"params": state.params, "opt/m": state.opt.m,
                    "opt/v": state.opt.v}[part]

            def walk(node, prefix):
                for k, v in node.items():
                    if isinstance(v, dict):
                        walk(v, f"{prefix}/{k}")
                    else:
                        np.testing.assert_array_equal(v, z[f"{prefix}/{k}"])
            walk(tree_to_numpy(tree), part)


if __name__ == "__main__":
    np.savez(sys.argv[1], **reference_outputs(sys.argv[2]))
