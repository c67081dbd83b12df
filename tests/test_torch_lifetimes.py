"""Every path of the port frees what it made when it returns, without the
cyclic garbage collector (CPU, smoke configs, float32).

A tensor that a finished call leaves in a reference cycle lives on until
the collector runs: a train step's gradients held that way are one copy
of the parameters on the card. :func:`cyclic_tensors` runs a callable
once to warm it (first-call caches, lazy imports), collects, then runs it
again with the collector disabled and, under ``gc.DEBUG_SAVEALL``,
returns the tensors the collector finds unreachable. Each case holds
that list empty: the paths of the train step (remat on and off, one and
two microbatches, the chunked attention), the explicit ``threadcomm`` and
``flat`` steps, the optimizer alone, checkpoints, the engines' arms, the
serving fabric and one ``tc.run`` collective. A first step in a fresh
process is checked in a subprocess: it alone shows a cycle a lazy import
makes inside the step, since this process has made every import already.

Run:  PYTHONPATH=src python -m pytest tests/test_torch_lifetimes.py -q
"""

import gc
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.config import MeshConfig, ServeConfig, TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.models.registry import build_model, make_synthetic_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

F32 = dict(param_dtype="float32", compute_dtype="float32")


def cyclic_tensors(fn):
    """``fn()`` run once to warm it, then once more with the collector
    disabled: the (type, shape) of every tensor that second call left in
    reference cycles (empty when it freed all it made)."""
    fn()
    gc.collect()
    was_enabled, flags = gc.isenabled(), gc.get_debug()
    gc.disable()
    try:
        fn()
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        found = [(type(o).__name__, tuple(o.shape)) for o in gc.garbage
                 if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(flags)
        gc.garbage.clear()
        if was_enabled:
            gc.enable()
    return found


def model_for(arch="gemma-2b", **train_kw):
    tcfg = TrainConfig(**{**F32, "loss_chunk": 16, **train_kw})
    model = build_model(get_smoke_config(arch), ServeConfig(**F32),
                        device="cpu", train=tcfg)
    return model, tcfg


def batch(cfg, B=4, S=32, seed=0):
    return make_synthetic_batch(cfg, B, seq_len=S, seed=seed,
                                compute_dtype="float32", device="cpu")


def stepper(step, state, batches):
    """A callable that takes one step of ``step`` from the state it
    keeps, on the next of ``batches`` in turn."""
    box = {"state": state, "i": 0}

    def one():
        b = batches[box["i"] % len(batches)]
        box["i"] += 1
        box["state"], _ = step(box["state"], b)
    return one


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat, microbatches, S", [
    (False, 1, 32), (True, 1, 32), (True, 2, 32),
    # above attn_chunk_threshold: the chunked attention, its kv blocks
    # under checkpoint
    (True, 1, 80), (False, 2, 80)])
def test_spmd_train_step_leaves_no_cycle(remat, microbatches, S):
    from repro_torch.train.trainer import init_train_state, make_train_step
    model, tcfg = model_for(remat=remat, microbatches=microbatches,
                            attn_chunk_threshold=64, attn_chunk=16,
                            attn_chunk_kv=32, learning_rate=1e-3,
                            warmup_steps=1, total_steps=10)
    step = make_train_step(model, MeshConfig((1,), ("data",)), tcfg)
    batches = [batch(model.cfg, S=S, seed=i) for i in range(2)]
    one = stepper(step, init_train_state(model, 0), batches)
    assert cyclic_tensors(one) == []


@pytest.mark.parametrize("grad_sync", ["threadcomm", "flat"])
def test_explicit_train_step_leaves_no_cycle(grad_sync):
    from repro_torch.core.compat import make_mesh
    from repro_torch.train.explicit import init_explicit_state
    from repro_torch.train.trainer import make_train_step
    shape, names = (2, 2, 1), ("pod", "data", "model")
    model, tcfg = model_for("yi-9b", remat=False, grad_sync=grad_sync,
                            learning_rate=1e-3, warmup_steps=1,
                            total_steps=10)
    mesh_cfg = MeshConfig(shape=shape, axis_names=names,
                          process_axes=("pod",))
    step = make_train_step(model, mesh_cfg, tcfg,
                           mesh=make_mesh(shape, names, device="cpu"))
    batches = [batch(model.cfg, B=8, S=16, seed=i) for i in range(2)]
    try:
        one = stepper(step, init_explicit_state(model, 0, dp=4), batches)
        assert cyclic_tensors(one) == []
    finally:
        step.comm.finish()


def test_adamw_update_leaves_no_cycle():
    """Fresh gradients each call, as a step makes them: the update must
    not keep them."""
    from repro_torch.interop import tree_map
    from repro_torch.optim import adamw_init, adamw_update
    model, _ = model_for(param_dtype="bfloat16")
    params = model.init(0)
    state = adamw_init(params)

    def update():
        grads = tree_map(lambda p: torch.full_like(p, 1e-3), params)
        adamw_update(grads, state, params, lr=1e-3)
    assert cyclic_tensors(update) == []


def test_checkpoint_save_and_restore_leave_no_cycle(tmp_path):
    """A state saved, then restored into a fresh template, both dropped
    by the caller: neither may outlive the call."""
    from repro_torch.interop import tree_map
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import init_train_state
    model, _ = model_for("hymba-1.5b", param_dtype="bfloat16")
    state = init_train_state(model, 0)

    def save_restore():
        ckpt.save(str(tmp_path), 1, tree_map(torch.clone, state), keep=1)
        ckpt.restore(str(tmp_path), tree_map(torch.zeros_like, state))
    assert cyclic_tensors(save_restore) == []


def test_a_fresh_process_first_train_step_leaves_no_cycle():
    """The process's first step, with every import the step's modules
    make at import time and none since: a cycle the step's own first
    calls make (a lazy import inside it) shows only here."""
    code = """
import gc, sys
import torch
from repro_torch.config import MeshConfig, ServeConfig, TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.models.registry import build_model, make_synthetic_batch
from repro_torch.train.trainer import init_train_state, make_train_step
f32 = dict(param_dtype="float32", compute_dtype="float32")
tcfg = TrainConfig(**f32, loss_chunk=16, remat=True)
model = build_model(get_smoke_config("gemma-2b"), ServeConfig(**f32),
                    device="cpu", train=tcfg)
step = make_train_step(model, MeshConfig((1,), ("data",)), tcfg)
state = init_train_state(model, 0)
b = make_synthetic_batch(model.cfg, 4, seq_len=32, seed=0,
                         compute_dtype="float32", device="cpu")
gc.collect()
gc.disable()
state, _ = step(state, b)
gc.set_debug(gc.DEBUG_SAVEALL)
gc.collect()
print([tuple(o.shape) for o in gc.garbage if isinstance(o, torch.Tensor)])
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def prompts(vocab, n=3, lens=(12, 20), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(1, lens[i % len(lens)])).astype(
        np.int32) for i in range(n)]


def drain(driveable, vocab, max_new=4):
    from repro_torch.serve import ServeRequest
    for rid, toks in enumerate(prompts(vocab)):
        driveable.submit(ServeRequest(rid=rid, batch={"tokens": toks},
                                      max_new_tokens=max_new), 0.0)
    steps = 0
    while not driveable.idle:
        driveable.step(0.0)
        steps += 1
        assert steps < 500, "failed to drain"


ENGINE_KW = dict(cache_len=40, num_slots=2, prefill_chunk=8,
                 max_prefill_per_step=2, device="cpu")
ARMS = {
    "paged": dict(kv_layout="paged", block_size=8),
    "slot": dict(kv_layout="slot"),
    "speculative": dict(kv_layout="paged", block_size=8, speculate=2),
    "prefix": dict(kv_layout="paged", block_size=8, prefix_cache=True),
}


@pytest.fixture(scope="module")
def gemma():
    model, _ = model_for(remat=False)
    return model, model.init(0)


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_continuous_engine_drive_leaves_no_cycle(gemma, arm):
    from repro_torch.serve import ContinuousEngine
    model, params = gemma

    def drive():
        eng = ContinuousEngine(model, params, **ENGINE_KW, **ARMS[arm])
        drain(eng, model.cfg.vocab_size)
    assert cyclic_tensors(drive) == []


def test_static_engine_generate_leaves_no_cycle(gemma):
    from repro_torch.serve import StaticEngine
    model, params = gemma
    toks = np.concatenate(prompts(model.cfg.vocab_size, n=2, lens=(16,)))

    def generate():
        StaticEngine(model, params, cache_len=32, device="cpu").generate(
            {"tokens": toks}, 4)
    assert cyclic_tensors(generate) == []


def test_replicated_fabric_drive_leaves_no_cycle(gemma):
    from repro_torch.serve import ServingFabric
    model, params = gemma

    def drive():
        fab = ServingFabric(model, params, placement="replicated", ranks=2,
                            cache_len=40, slots_per_rank=2, prefill_chunk=8,
                            max_prefill_per_step=2, block_size=8,
                            device="cpu")
        try:
            drain(fab, model.cfg.vocab_size)
        finally:
            fab.close(strict=True)
    assert cyclic_tensors(drive) == []


def test_threadcomm_allreduce_leaves_no_cycle():
    from repro_torch.core.comm import threadcomm_init
    from repro_torch.core.compat import make_mesh
    tc = threadcomm_init(make_mesh((2, 4), ("proc", "thread"), device="cpu"),
                         process_axes=("proc",), thread_axes=("thread",))
    x = torch.arange(8.0 * 64).reshape(8, 64)
    with tc.start():
        assert cyclic_tensors(lambda: tc.run(tc.allreduce, x)) == []
    tc.free()
