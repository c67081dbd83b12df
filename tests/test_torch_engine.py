"""Port serving layer vs the JAX reference: the paged continuous engine,
the cell-queue scheduler, and the port's import and device rules.

The engine test drives the port's ``ContinuousEngine`` and the
reference's ``ContinuousEngine(kv_layout="paged")`` with the same
parameters (moved over through ``interop.params_from_numpy``) through
the same mixed-length Poisson trace, step by step: both must admit the
same requests at the same step, hold the same block tables after every
step, and emit identical greedy tokens. Float32 on the CPU.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.config import ServeConfig as JServeConfig
from repro.config import TrainConfig
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.registry import build_model as jax_build_model
from repro.serve import ContinuousEngine as JaxEngine
from repro.serve import ServeRequest as JaxRequest
from repro.serve.scheduler import CellQueueScheduler as JaxScheduler
from repro.serve.scheduler import make_trace as jax_make_trace
from repro_torch.config import ServeConfig
from repro_torch.configs import get_smoke_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.paged_attention import ops
from repro_torch.models.registry import build_model
from repro_torch.serve import (CellQueueScheduler, ContinuousEngine,
                               ServeRequest, SlotError, make_trace)

ROOT = Path(__file__).resolve().parents[1]
TRAIN = TrainConfig(param_dtype="float32", compute_dtype="float32",
                    loss_chunk=16, attn_chunk_threshold=64, attn_chunk=16,
                    remat=False)
F32 = ServeConfig(param_dtype="float32", compute_dtype="float32")
ENGINE_KW = dict(cache_len=28, num_slots=3, prefill_chunk=8, block_size=4,
                 num_blocks=14, max_prefill_per_step=2)


@pytest.fixture(scope="module")
def bundles():
    jcfg = jax_smoke_config("gemma-2b")
    jmodel = jax_build_model(jcfg, TRAIN, JServeConfig(), tp=1)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config("gemma-2b")
    model = build_model(cfg, F32, device="cpu")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               cfg)
    return jmodel, jparams, model, params


def _trace(n=10):
    kw = dict(prompt_len=(5, 19), max_new=(2, 9), rate=400.0, seed=0)
    trace = make_trace(n, **kw)
    # the reference's entries restricted to the port's fields (the
    # reference also carries a per-entry temperature)
    assert len(trace) == len(jax_make_trace(n, **kw)) == n
    assert [vars(e) for e in trace] == [
        {k: vars(j)[k] for k in vars(e)}
        for e, j in zip(trace, jax_make_trace(n, **kw))]
    return trace


def _requests(cls, trace, vocab, temperature=0.0, seed=0):
    out = []
    for rid, e in enumerate(trace):
        tok = np.random.default_rng(100 + rid).integers(
            0, vocab, size=(1, e.prompt_len)).astype(np.int32)
        out.append(cls(rid=rid, batch={"tokens": tok},
                       max_new_tokens=e.max_new, temperature=temperature,
                       seed=seed, arrival=e.arrival))
    return out


def _drive(eng, reqs, steps_per_s=2000.0):
    """Deterministic replay: request i is submitted before the step whose
    index reaches its arrival; returns per-step (tables, admitted rids,
    finished rids)."""
    log, i, step = [], 0, 0
    pending = sorted(reqs, key=lambda r: r.arrival)
    while i < len(pending) or not eng.idle:
        while i < len(pending) and pending[i].arrival * steps_per_s <= step:
            eng.submit(pending[i], float(step))
            i += 1
        done = eng.step(float(step))
        admitted = sorted(r.rid for r in reqs if r.admit_time == step)
        log.append((eng.kv._tables.copy(), admitted,
                    sorted(r.rid for r in done)))
        step += 1
        assert step < 1000
    return log


def test_engine_token_identical_to_reference(bundles):
    jmodel, jparams, model, params = bundles
    trace = _trace()
    vocab = model.cfg.vocab_size
    jreqs = _requests(JaxRequest, trace, vocab)
    treqs = _requests(ServeRequest, trace, vocab)
    jeng = JaxEngine(jmodel, jparams, kv_layout="paged", **ENGINE_KW)
    teng = ContinuousEngine(model, params, kv_layout="paged", device="cpu",
                            **ENGINE_KW)
    jlog, tlog = _drive(jeng, jreqs), _drive(teng, treqs)
    assert len(jlog) == len(tlog)
    for (jt, ja, jf), (tt, ta, tf) in zip(jlog, tlog):
        assert np.array_equal(jt, tt)          # same block tables
        assert ja == ta                        # same admission order
        assert jf == tf
    for j, t in zip(jreqs, treqs):
        assert j.generated == t.generated == t.max_new_tokens
        assert np.array_equal(j.output, t.output)
        assert j.prefill_chunks == t.prefill_chunks
    assert teng.scheduler.n_block_deferrals == jeng.scheduler.n_block_deferrals
    assert teng.scheduler.n_block_deferrals > 0    # the pool gated admission
    tk, jk = teng.kv_accounting(), jeng.kv_accounting()
    for key in ("kv_capacity_tokens", "kv_reserved_over_resident",
                "peak_concurrent"):
        assert tk[key] == pytest.approx(jk[key])


def test_scheduler_classes_and_costs_match_reference():
    trace = _trace(12)
    vocab = 256
    for kw in (dict(num_cells=4, prefill_chunk_bytes=32, block_bytes=16),
               dict(num_cells=8), dict(num_cells=2, cell_size=16)):
        ts, js = CellQueueScheduler(**kw), JaxScheduler(**kw)
        treqs = _requests(ServeRequest, trace, vocab)
        jreqs = _requests(JaxRequest, trace, vocab)
        tq = [ts.submit(r, r.arrival) for r in treqs]
        jq = [js.submit(r, r.arrival) for r in jreqs]
        assert tq == jq
        for t, j in zip(treqs, jreqs):
            assert (t.protocol, t.cells, t.nbytes) == (j.protocol, j.cells,
                                                       j.nbytes)
            assert t.admit_cost_s == j.admit_cost_s
        assert ts.modeled_admit_cost_s == js.modeled_admit_cost_s
        order_t = [r.rid for r in ts.admit(0.0, 100)]
        order_j = [r.rid for r in js.admit(0.0, 100)]
        assert order_t == order_j


def test_temperature_is_deterministic_within_the_port(bundles):
    _, _, model, params = bundles
    prompt = {"tokens": np.random.default_rng(7).integers(
        0, model.cfg.vocab_size, size=(3, 8)).astype(np.int32)}
    kw = dict(cache_len=24, num_slots=3, prefill_chunk=4, block_size=8,
              kv_layout="paged", device="cpu")
    a = ContinuousEngine(model, params, **kw).generate(
        prompt, 10, temperature=0.7, seed=3)
    b = ContinuousEngine(model, params, **kw).generate(
        prompt, 10, temperature=0.7, seed=3)
    c = ContinuousEngine(model, params, **kw).generate(
        prompt, 10, temperature=0.7, seed=4)
    greedy = ContinuousEngine(model, params, **kw).generate(prompt, 10)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert not np.array_equal(a, greedy)


def test_engine_eos_reset_and_capacity(bundles):
    _, _, model, params = bundles
    prompt = {"tokens": np.random.default_rng(8).integers(
        0, model.cfg.vocab_size, size=(2, 8)).astype(np.int32)}
    kw = dict(cache_len=40, num_slots=2, prefill_chunk=4, block_size=8,
              kv_layout="paged", device="cpu")
    ref = ContinuousEngine(model, params, **kw).generate(prompt, 16)
    eos = int(ref[0, 3])
    eng = ContinuousEngine(model, params, eos_id=eos, **kw)
    out = eng.generate(prompt, 16)
    hit = np.flatnonzero(out[0] == eos)
    assert hit.size and (out[0, int(hit[0]):] == eos).all()
    assert eng.kv.num_live == 0
    assert eng.kv.num_free_blocks == eng.kv.pool.num_blocks
    eng.reset()
    assert eng.peak_live == 0 and eng.scheduler.num_waiting == 0
    big = ServeRequest(rid=9, batch={"tokens": prompt["tokens"][:1]},
                       max_new_tokens=60)
    with pytest.raises(ValueError, match="admittable capacity"):
        eng.submit(big)
    with pytest.raises(SlotError, match="double free"):
        eng.kv.free(0)


def test_counts_plain_attention_calls_on_cpu(bundles):
    _, _, model, params = bundles
    ops.reset_counters()
    prompt = {"tokens": np.zeros((1, 6), np.int32)}
    ContinuousEngine(model, params, cache_len=16, num_slots=1,
                     prefill_chunk=4, block_size=4, kv_layout="paged",
                     device="cpu").generate(prompt, 3)
    L = model.cfg.num_layers
    # 2 chunk dispatches + 2 decode steps, one attention call per layer
    assert ops.counters() == {"decode_launches": 0, "mq_launches": 0,
                              "ref_calls": 4 * L}


def test_unported_paths_raise_naming_the_slice(bundles):
    """Every path of the reference's engine is ported: the serving
    fabric's roles build, and refuse what the reference's refuse with its
    ValueErrors (an unknown role; a prefill rank on the slot layout).
    Prefix caching, speculation, ring buffers, another dense config as
    the drafter and every registry config build and run. A drafter of
    another vocabulary (every full-width pair) raises the engine's
    ValueError, the reference's words."""
    _, _, model, params = bundles
    kw = dict(cache_len=16, num_slots=1, device="cpu")
    with pytest.raises(ValueError, match="unknown role 'router'"):
        ContinuousEngine(model, params, role="router", **kw)
    with pytest.raises(ValueError, match="requires kv_layout='paged'"):
        ContinuousEngine(model, params, kv_layout="slot", role="prefill",
                         **kw)
    for role in ("prefill", "decode"):
        assert ContinuousEngine(model, params, kv_layout="paged",
                                role=role, **kw).role == role
    for extra in (dict(kv_layout="paged", prefix_cache=True),
                  dict(kv_layout="paged", speculate=2)):
        ContinuousEngine(model, params, **kw, **extra)
    cfg = get_smoke_config("gemma-2b")
    build_model(cfg, ServeConfig(param_dtype="float32",
                                 compute_dtype="float32", ring_buffer=True),
                device="cpu")
    from repro_torch.launch import serve as launch
    # qwen3-smoke shares gemma-smoke's vocabulary (256): it drafts
    res = launch.run_traffic(smoke=True, device="cpu", engine="continuous",
                             requests=2, slots=2, parity_check=False,
                             chunk_compare=False, prefix_compare=False,
                             spec_compare=True,
                             draft_arch="qwen3-14b", max_new=(3, 6))
    assert res["draft_arch"] == "qwen3-14b"
    assert res["spec_token_identical_trace"]
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    assert vars(get_config("olmoe-1b-7b")) == vars(
        jax_get_config("olmoe-1b-7b"))
    # full width: gemma-2b (vocab 256000) and yi-9b (64000) — the engine
    # refuses the pair before any parameter is read
    gemma = build_model(get_config("gemma-2b"), F32, device="cpu")
    yi = build_model(get_config("yi-9b"), F32, device="cpu")
    with pytest.raises(ValueError, match="drafter vocab 64000 != target "
                                         "vocab 256000"):
        ContinuousEngine(gemma, {}, kv_layout="paged", prefill_chunk=8,
                         block_size=4, speculate=2, draft_model=yi,
                         draft_params={}, **kw)


def test_entry_points_raise_without_a_card(bundles, monkeypatch):
    """Without ``device=`` the entry points ask for the card; with no card
    they raise instead of falling back to the CPU."""
    _, _, model, params = bundles
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("gemma-2b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg, F32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousEngine(model, params, cache_len=16, num_slots=1)
    from repro_torch.launch import serve as launch
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--smoke", "--requests", "1"])


def test_launch_serve_cpu_smoke(tmp_path):
    """The launcher end to end on the CPU at the smoke config: every
    request finishes with in-vocab tokens and the JSON carries its
    fields."""
    from repro_torch.launch import serve as launch
    out = tmp_path / "serve.json"
    launch.main(["--smoke", "--device", "cpu", "--requests", "4",
                 "--slots", "2", "--prompt-len", "16,40", "--max-new-hi",
                 "8", "--no-prefix-compare", "--no-spec-compare", "--json",
                 str(out)])
    res = json.loads(out.read_text())
    assert res["backend"] == "torch" and res["device"]["name"] == "cpu"
    assert res["prefill_compiles"] is None
    assert res["continuous"]["n"] == 4.0
    assert res["kernels"]["ref_calls"] > 0
    assert res["kernels"]["decode_launches"] == 0
    for toks in res["outputs"]:
        assert toks and all(0 <= t < 256 for t in toks)
    for key in ("continuous_tok_s", "ttft_p50_ms", "ttft_p95_ms",
                "torch_version", "cuda_version"):
        assert key in res


#: the training slice's packages, the analysis package, the roofline and
#: the examples, which both import-rule checks must see
TRAINING_PACKAGES = ("optim", "data", "dist", "train", "analysis",
                     "roofline", "examples")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("package", TRAINING_PACKAGES)
def test_import_rule_covers_the_training_packages(package):
    """The walk of the sources reaches every training package (and the
    analysis, roofline and examples packages), its ``__init__`` and at
    least one module."""
    files = [p for p in _port_files() if p.parent.name == package
             and p.parent.parent.name == "repro_torch"]
    names = {p.name for p in files}
    assert "__init__.py" in names and len(names) >= 2, names


def test_port_sources_import_no_jax_triton_or_reference():
    """Every import statement of the port and of chip_smoke.py, including
    those inside functions."""
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "triton", "repro"):
                    bad.append(f"{path.name}:{node.lineno} {n}")
    assert bad == []


def test_importing_the_port_loads_no_jax_or_reference():
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"spec = importlib.util.spec_from_file_location('chip_smoke', "
        f"{str(ROOT / 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'triton', 'repro'))\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
        "assert not bad, bad\n"
        f"for p in {TRAINING_PACKAGES!r}:\n"
        "    assert 'repro_torch.' + p in sys.modules, p\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15
