"""Port static engine, slot-layout continuous engine and traffic runner vs
the JAX reference's.

Both sides serve the gemma-2b smoke config with the same parameters
(moved over through ``interop.params_from_numpy``) in float32 on the CPU.
The engines are driven step by step through the same trace: they must
admit the same requests at the same step, finish the same ones, and emit
identical greedy tokens, on the chunked and the monolithic path.
``drive_static``'s bucketing and its errors are held against the
reference's with a recording stub engine, and a tiny ``run_traffic``
against the reference's on the same trace and prompts.
"""

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
from repro.serve import StaticEngine as JaxStatic
from repro_torch.config import ServeConfig
from repro_torch.configs import get_smoke_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import transformer
from repro_torch.models.registry import build_model
from repro_torch.serve import (ContinuousEngine, LeaseLeakWarning,
                               ServeRequest, SlotError, StaticEngine,
                               make_trace)

TRAIN = TrainConfig(param_dtype="float32", compute_dtype="float32",
                    loss_chunk=16, attn_chunk_threshold=64, attn_chunk=16,
                    remat=False)
F32 = ServeConfig(param_dtype="float32", compute_dtype="float32",
                  attn_chunk_threshold=64, attn_chunk=16)


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


def _prompt(B, S, seed):
    return {"tokens": np.random.default_rng(seed).integers(
        0, 256, size=(B, S)).astype(np.int32)}


@pytest.mark.parametrize("B,S,max_new,eos_col", [(3, 24, 8, None),
                                                 (2, 70, 6, None),
                                                 (4, 9, 10, 3)])
def test_static_engine_token_identical_to_reference(bundles, B, S, max_new,
                                                    eos_col):
    """Greedy static generation; S=70 takes the chunked attention path on
    both sides; ``eos_col`` makes row 0's token at that column the EOS
    (done-masking and the early exit)."""
    jmodel, jparams, model, params = bundles
    prompt = _prompt(B, S, seed=S)
    cache_len = S + max_new
    eos = -1
    if eos_col is not None:
        eos = int(JaxStatic(jmodel, jparams, cache_len=cache_len).generate(
            prompt, max_new)[0, eos_col])
    ref = JaxStatic(jmodel, jparams, cache_len=cache_len,
                    eos_id=eos).generate(prompt, max_new)
    transformer.reset_counters()
    out = StaticEngine(model, params, cache_len=cache_len, eos_id=eos,
                       device="cpu").generate(prompt, max_new)
    assert np.array_equal(out, ref)
    assert transformer.prefill_calls == 1


def test_static_engine_per_row_temperature(bundles):
    """A mixed-temperature batch: greedy rows equal the all-greedy run,
    sampled rows are deterministic in the seed and move with it, and a
    temperature vector of the wrong shape raises."""
    _, _, model, params = bundles
    prompt = _prompt(3, 8, seed=11)
    eng = StaticEngine(model, params, cache_len=20, device="cpu")
    temps = np.array([0.0, 0.8, 0.0], np.float32)
    greedy = eng.generate(prompt, 10)
    a = eng.generate(prompt, 10, temperature=temps, seed=3)
    b = eng.generate(prompt, 10, temperature=temps, seed=3)
    c = eng.generate(prompt, 10, temperature=temps, seed=4)
    assert np.array_equal(a, b)
    assert np.array_equal(a[[0, 2]], greedy[[0, 2]])
    assert not np.array_equal(a[1], c[1])
    with pytest.raises(ValueError, match="temperature"):
        eng.generate(prompt, 4, temperature=np.zeros(2, np.float32))


def _requests(cls, trace, temperature=0.0, seed=0):
    out = []
    for rid, e in enumerate(trace):
        tok = np.random.default_rng(200 + rid).integers(
            0, 256, size=(1, e.prompt_len)).astype(np.int32)
        out.append(cls(rid=rid, batch={"tokens": tok},
                       max_new_tokens=e.max_new, temperature=temperature,
                       seed=seed, arrival=e.arrival))
    return out


def _drive(eng, reqs, steps_per_s=2000.0):
    """Deterministic replay: request i is submitted before the step whose
    index reaches its arrival; returns per-step (admitted, finished)."""
    log, i, step = [], 0, 0
    pending = sorted(reqs, key=lambda r: r.arrival)
    while i < len(pending) or not eng.idle:
        while i < len(pending) and pending[i].arrival * steps_per_s <= step:
            eng.submit(pending[i], float(step))
            i += 1
        done = eng.step(float(step))
        log.append((sorted(r.rid for r in reqs if r.admit_time == step),
                    sorted(r.rid for r in done)))
        step += 1
        assert step < 1000
    return log


@pytest.mark.parametrize("prefill_chunk", [8, 0])
def test_slot_engine_token_identical_to_reference(bundles, prefill_chunk):
    """The slot continuous engine, chunked (8-token chunks, two rows a
    step) and monolithic, against the reference's through one mixed
    trace: same admissions and finishes at every step, same tokens."""
    jmodel, jparams, model, params = bundles
    trace = make_trace(9, prompt_len=(5, 19, 30), max_new=(2, 9),
                       rate=400.0, seed=1)
    kw = dict(cache_len=40, num_slots=3, prefill_chunk=prefill_chunk,
              max_prefill_per_step=2)
    jreqs, treqs = _requests(JaxRequest, trace), _requests(ServeRequest,
                                                           trace)
    jeng = JaxEngine(jmodel, jparams, **kw)
    transformer.reset_counters()
    teng = ContinuousEngine(model, params, device="cpu", **kw)
    assert teng.kv_layout == "slot"
    assert _drive(jeng, jreqs) == _drive(teng, treqs)
    for j, t in zip(jreqs, treqs):
        assert j.generated == t.generated == t.max_new_tokens
        assert np.array_equal(j.output, t.output)
        assert j.prefill_chunks == t.prefill_chunks
    # monolithic admission prefills each prompt once; chunked never does
    assert transformer.prefill_calls == (0 if prefill_chunk else len(trace))
    tk, jk = teng.kv_accounting(), jeng.kv_accounting()
    for key in ("kv_capacity_tokens", "kv_reserved_over_resident",
                "peak_concurrent"):
        assert tk[key] == pytest.approx(jk[key])


def test_slot_pool_rows_leases_and_reset(bundles):
    """Row gather clamps and scatter drops out-of-range slots; misuse
    raises; a reset over live slots names the leak."""
    _, _, model, params = bundles
    eng = ContinuousEngine(model, params, cache_len=16, num_slots=2,
                           device="cpu")
    kv = eng.kv
    s0 = kv.alloc("a")
    kv.reset_slot(s0)
    rows = kv.rows_at([s0, 5])
    assert rows["k"].shape[1] == 2 and rows["pos"].shape == (2, 17)
    rows["pos"][:] = 7
    before = kv.buffers["pos"].clone()
    kv.rows_into(rows, [s0, 5])
    assert (kv.buffers["pos"][s0] == 7).all()
    assert torch.equal(kv.buffers["pos"][1 - s0], before[1 - s0])
    with pytest.raises(SlotError, match="insert into free slot"):
        kv.insert(1 - s0, rows, 3)
    kv.free(s0)
    with pytest.raises(SlotError, match="double free"):
        kv.free(s0)
    kv.alloc("b")
    with pytest.warns(LeaseLeakWarning, match="slot"):
        eng.reset()
    assert kv.num_free == 2 and eng.idle


def test_monolithic_slot_engine_counts_prefills_not_flash_on_cpu(bundles):
    """On the CPU monolithic prefill takes the plain attention (the
    reference's full/chunked path), so the flash wrapper is not called."""
    _, _, model, params = bundles
    flash_ops.reset_counters()
    transformer.reset_counters()
    ContinuousEngine(model, params, cache_len=20, num_slots=2,
                     prefill_chunk=0, device="cpu").generate(
        _prompt(3, 7, seed=9), 4)
    assert transformer.prefill_calls == 3
    assert flash_ops.counters() == {"flash_launches": 0, "ref_calls": 0}


class _Recorder:
    """Stub static engine: records each batch it is handed."""
    eos_id = -1

    def __init__(self):
        self.calls = []

    def generate(self, batch, max_new, *, temperature, seed):
        self.calls.append((batch["tokens"].shape, int(batch["tokens"][0, 0]),
                           max_new, np.asarray(temperature).tolist(), seed))
        return np.zeros((batch["tokens"].shape[0], max_new), np.int32)


def _bucket_requests(cls, seeds=(0,)):
    """Seven requests, prompt lengths 4/6 interleaved, all arrived; row
    i's first token is i, so a batch names its first member."""
    out = []
    for rid in range(7):
        plen = (4, 6)[rid % 2]
        tok = np.full((1, plen), rid, np.int32)
        out.append(cls(rid=rid, batch={"tokens": tok},
                       max_new_tokens=2 + rid, temperature=0.1 * rid,
                       seed=seeds[rid % len(seeds)], arrival=0.0))
    return out


def test_drive_static_bucketing_matches_reference():
    from repro.launch.serve import drive_static as jax_drive_static
    from repro_torch.launch.serve import drive_static
    jrec, trec = _Recorder(), _Recorder()
    jstats = jax_drive_static(jrec, _bucket_requests(JaxRequest), 3)
    tstats = drive_static(trec, _bucket_requests(ServeRequest), 3)
    assert trec.calls == jrec.calls
    # 4 prompts of length 4 -> batches of 3 + 1 (padded); 3 of length 6
    assert [c[0] for c in trec.calls] == [(3, 4), (3, 4), (3, 6)]
    for key in ("n", "useful_tokens"):
        assert tstats[key] == jstats[key]
    assert tstats["batches"] == 3.0


def test_drive_static_heterogeneous_seeds_raise():
    from repro.launch.serve import drive_static as jax_drive_static
    from repro_torch.launch.serve import drive_static
    for fn, cls in ((jax_drive_static, JaxRequest),
                    (drive_static, ServeRequest)):
        with pytest.raises(ValueError, match="heterogeneous seeds"):
            fn(_Recorder(), _bucket_requests(cls, seeds=(0, 1, 2)), 3)


def test_run_traffic_matches_reference(bundles, monkeypatch):
    """A tiny ``--engine both`` run on both sides, same trace, prompts
    (the port's prompt source patched to the reference's) and parameters:
    every arm's outputs and every token-identity flag agree."""
    import repro.launch.serve as jlaunch
    from repro.models.registry import make_synthetic_batch
    from repro_torch.launch import serve as launch
    jcfg = jax_smoke_config("gemma-2b")
    monkeypatch.setattr(launch, "synthetic_tokens", lambda cfg, b, s, seed:
                        np.asarray(make_synthetic_batch(
                            jcfg, b, s, seed=seed,
                            compute_dtype="float32")["tokens"], np.int32))
    seen = {}

    def recording(name, fn):
        def wrapped(eng, reqs, *a, **kw):
            out = fn(eng, reqs, *a, **kw)
            seen.setdefault(name, []).append(
                [r.output[:r.generated].tolist() for r in reqs])
            return out
        return wrapped

    monkeypatch.setattr(jlaunch, "drive_continuous",
                        recording("continuous", jlaunch.drive_continuous))
    monkeypatch.setattr(jlaunch, "drive_static",
                        recording("static", jlaunch.drive_static))
    kw = dict(smoke=True, requests=4, slots=2, prompt_len=(16, 40),
              max_new=(3, 6), rate=400.0, seed=0)
    ref = jlaunch.run_traffic("gemma-2b", prefix_compare=False,
                              spec_compare=False, **kw)
    jparams = jax_build_model(jcfg, TRAIN, JServeConfig(), tp=1).init(
        jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               get_smoke_config("gemma-2b"))
    res = launch.run_traffic("gemma-2b", device="cpu", params=params,
                             prefix_compare=False, spec_compare=False, **kw)
    arms = res["outputs_by_arm"]
    cont = seen["continuous"]          # chunked, monolithic, paged
    assert arms["continuous"] == cont[0]
    assert arms["continuous_monolithic"] == cont[1]
    assert arms["continuous_paged"] == cont[2]
    assert arms["static"] == seen["static"][0]
    for key in ("parity_token_identical", "parity_token_identical_paged",
                "paged_token_identical_trace", "paged_hbm_within_budget",
                "prefill_chunk", "cache_len", "paged_num_blocks",
                "parity_prompt_len"):
        assert res[key] == ref[key], key
    assert res["parity_token_identical"] and res["paged_token_identical_trace"]
    for arm in ("continuous", "continuous_monolithic", "continuous_paged",
                "static"):
        assert res[arm]["useful_tokens"] == ref[arm]["useful_tokens"]
    assert res["kernels"]["prefill_calls"] > 0
    assert res["kernels"]["flash_launches"] == 0
