"""Port prefix caching vs the JAX reference.

* The radix cache and the refcounted block pool: the same operation
  sequences (admission through ``lookup(limit=)`` + ``alloc_prefix``, CoW
  release, insert, free, reclaim, cold and warm resets) on the
  reference's and the port's ``PrefixCache`` + ``PagedKVCache`` must give
  equal block ids, tables, refcounts, free lists, LRU order, evictions
  and ``stats()``. Random traffic comes from hypothesis.
* The engine: ``ContinuousEngine(prefix_cache=True)`` of both packages on
  one shared-prefix trace, driven step by step on the gemma-2b smoke
  config (float32, parameters moved over by ``interop``): equal block
  tables after every step, equal greedy tokens (and equal to the port's
  engine without the cache), equal ``prefix_stats()``, cold and after
  ``reset(preserve_prefix=True)``.
* The shared-prefix trace (``make_trace``) and the launcher's prefix
  comparison.
"""

import warnings

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.config import ServeConfig
from repro_torch.configs import get_smoke_config
from repro_torch.interop import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.serve import ContinuousEngine, ServeRequest, make_trace
from repro_torch.serve.block_pool import PagedKVCache
from repro_torch.serve.kv_cache import SlotError
from repro_torch.serve.prefix_cache import PrefixCache

BS = 4
F32 = ServeConfig(param_dtype="float32", compute_dtype="float32")


class _StubModel:
    """A model with an empty device pool: the host-side structures alone."""
    device = None

    def init_paged_cache(self, num_blocks, block_size, dtype=None,
                         num_rows=0):
        return {}


def _side(paged_cls, cache_cls, num_blocks, num_slots=3, mbr=6):
    kv = paged_cls(_StubModel(), num_blocks=num_blocks, block_size=BS,
                   num_slots=num_slots, max_blocks_per_req=mbr)
    return kv, cache_cls(kv.pool)


def _state(kv, cache):
    pool = kv.pool
    return dict(tables=kv._tables.tolist(), lengths=kv._len.tolist(),
                refs=pool._ref.tolist(), free=list(pool._free),
                num_free=pool.num_free, live=kv.live_slots,
                parked=list(cache._parked), nodes=sorted(cache._nodes),
                stats=cache.stats())


def _apply(kv, cache, op, live):
    """One operation on one side; returns what it observed."""
    kind = op[0]
    if kind == "admit":
        _, tokens, extra, rid = op
        need = len(tokens) + extra
        hit = cache.lookup(tokens, limit=len(tokens) - 1)
        seen = (hit.blocks, hit.tokens, hit.cow_src, hit.cow_tokens,
                hit.n_parked)
        try:
            ok = kv.can_admit(need, hit=hit)
        except Exception as exc:       # each package's own SlotError
            if type(exc).__name__ != SlotError.__name__:
                raise
            return seen + ("too long",)
        if not ok:
            return seen + ("deferred",)
        slot = kv.alloc_prefix(f"req-{rid}", need, hit, cache)
        if hit.cow_src is not None:
            cache.release_cow(hit.cow_src)
        kv.advance(slot, hit.total_tokens)
        live[slot] = tokens
        return seen + (slot, kv.blocks_of(slot))
    if kind == "insert":
        slots = sorted(live)
        if not slots:
            return None
        slot = slots[op[1] % len(slots)]
        return cache.insert(live[slot], kv.blocks_of(slot))
    if kind == "free":
        slots = sorted(live)
        if not slots:
            return None
        slot = slots[op[1] % len(slots)]
        del live[slot]
        kv.free(slot)
        return slot
    if kind == "reclaim":
        return cache.reclaim(op[1])
    live.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if kind == "reset_warm":
            kv.reset_rows()
        else:
            cache.clear()
            kv.reset()
    return kind


def _ops_strategy():
    templates = [list(range(100 + 20 * g, 120 + 20 * g)) for g in range(3)]
    admit = st.tuples(st.just("admit"), st.integers(0, 2),
                      st.integers(0, 14), st.integers(1, 10),
                      st.integers(0, 8), st.integers(0, 999))

    def build(t):
        _, g, cut, tail, extra, seed = t
        tail_tok = np.random.default_rng(seed).integers(0, 7, size=tail)
        return ("admit", templates[g][:cut] + tail_tok.tolist(), extra)

    return st.lists(st.one_of(
        admit.map(build),
        st.tuples(st.just("insert"), st.integers(0, 5)),
        st.tuples(st.just("free"), st.integers(0, 5)),
        st.tuples(st.just("reclaim"), st.integers(1, 6)),
        st.tuples(st.sampled_from(["reset_warm", "reset_cold"]))),
        min_size=1, max_size=40)


def _both_sides(num_blocks):
    from repro.serve.block_pool import PagedKVCache as JPaged
    from repro.serve.prefix_cache import PrefixCache as JCache
    return (_side(PagedKVCache, PrefixCache, num_blocks),
            _side(JPaged, JCache, num_blocks))


def _run_ops(ops, num_blocks):
    (tkv, tc), (jkv, jc) = _both_sides(num_blocks)
    tlive, jlive = {}, {}
    for i, op in enumerate(ops):
        op = op + (i,) if op[0] == "admit" else op
        assert _apply(tkv, tc, op, tlive) == _apply(jkv, jc, op, jlive), op
        assert _state(tkv, tc) == _state(jkv, jc), op
        tc.check()
    return tc


@settings(max_examples=60, deadline=None, database=None)
@given(ops=_ops_strategy(), num_blocks=st.integers(6, 18))
def test_random_traffic_matches_reference(ops, num_blocks):
    _run_ops(ops, num_blocks)


def test_scripted_traffic_hits_cows_evicts_and_resets():
    """A fixed sequence that reaches every path: full hits, a CoW hit,
    parking, LRU eviction under pressure, a pinned parked node, a warm
    and a cold reset."""
    t = list(range(100, 116))
    ops = [("admit", t[:10] + [1, 2], 2), ("insert", 0),
           ("admit", t[:10] + [3, 3, 3], 0), ("insert", 1),
           ("free", 0), ("admit", t[:9] + [5] * 6, 1), ("insert", 2),
           ("free", 0), ("free", 0), ("admit", [9] * 20, 3),
           ("reclaim", 2), ("admit", t[:12] + [4], 0), ("insert", 0),
           ("reset_warm",), ("admit", t[:12] + [4, 4], 0),
           ("admit", [6] * 9, 0), ("reset_cold",),
           ("admit", t[:12] + [4, 4], 0)]
    tc = _run_ops(ops, 12)
    assert tc.n_lookups > 0


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bundles():
    from repro.config import ServeConfig as JServeConfig
    from repro.config import TrainConfig
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models.registry import build_model as jax_build_model
    train = TrainConfig(param_dtype="float32", compute_dtype="float32",
                        loss_chunk=16, attn_chunk_threshold=64,
                        attn_chunk=16, remat=False)
    jmodel = jax_build_model(jax_smoke_config("gemma-2b"), train,
                             JServeConfig(), tp=1)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config("gemma-2b")
    model = build_model(cfg, F32, device="cpu")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               cfg)
    return jmodel, jparams, model, params


TRACE_KW = dict(prompt_len=(14, 23), max_new=(2, 7), rate=300.0,
                shared_prefix_len=10, share_ratio=0.8, prefix_groups=2,
                seed=4)
ENGINE_KW = dict(cache_len=32, num_slots=3, prefill_chunk=8, block_size=BS,
                 num_blocks=40, max_prefill_per_step=2, kv_layout="paged")


@pytest.mark.parametrize("seed", [0, 4, 9])
@pytest.mark.parametrize("ratio,groups", [(1.0, 1), (0.5, 3), (0.9, 2)])
def test_shared_prefix_trace_matches_reference(seed, ratio, groups):
    from repro.serve.scheduler import make_trace as jax_make_trace
    kw = dict(prompt_len=(1, 12, 30), max_new=(1, 9), rate=50.0,
              shared_prefix_len=16, share_ratio=ratio,
              prefix_groups=groups, seed=seed)
    port, ref = make_trace(11, **kw), jax_make_trace(11, **kw)
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        assert vars(p) == {k: vars(r)[k] for k in vars(p)}
    assert [e.prefix_group for e in port if e.prompt_len == 1] == \
        [-1] * sum(e.prompt_len == 1 for e in port)


def _requests(cls, trace, vocab):
    templates = {g: np.random.default_rng(500 + g).integers(
        0, vocab, size=30).astype(np.int32) for g in range(4)}
    out = []
    for rid, e in enumerate(trace):
        tok = np.random.default_rng(600 + rid).integers(
            0, vocab, size=(1, e.prompt_len)).astype(np.int32)
        if e.prefix_group >= 0:
            tok[0, :e.prefix_len] = templates[e.prefix_group][:e.prefix_len]
        out.append(cls(rid=rid, batch={"tokens": tok},
                       max_new_tokens=e.max_new, arrival=e.arrival))
    return out


def _drive(eng, reqs, steps_per_s=2000.0):
    log, i, step = [], 0, 0
    pending = sorted(reqs, key=lambda r: r.arrival)
    while i < len(pending) or not eng.idle:
        while i < len(pending) and pending[i].arrival * steps_per_s <= step:
            eng.submit(pending[i], float(step))
            i += 1
        eng.step(float(step))
        log.append(eng.kv._tables.copy())
        step += 1
        assert step < 1000
    return log


def test_engine_matches_reference_cold_and_warm(bundles):
    from repro.serve import ContinuousEngine as JaxEngine
    from repro.serve import ServeRequest as JaxRequest
    jmodel, jparams, model, params = bundles
    vocab = model.cfg.vocab_size
    trace = make_trace(9, **TRACE_KW)
    plain_reqs = _requests(ServeRequest, trace, vocab)
    _drive(ContinuousEngine(model, params, device="cpu", **ENGINE_KW),
           plain_reqs)
    teng = ContinuousEngine(model, params, prefix_cache=True, device="cpu",
                            **ENGINE_KW)
    jeng = JaxEngine(jmodel, jparams, prefix_cache=True, **ENGINE_KW)
    for run in ("cold", "warm"):
        treqs = _requests(ServeRequest, trace, vocab)
        jreqs = _requests(JaxRequest, trace, vocab)
        tlog, jlog = _drive(teng, treqs), _drive(jeng, jreqs)
        assert len(tlog) == len(jlog), run
        for tt, jt in zip(tlog, jlog):
            assert np.array_equal(tt, jt), run
        for t, j, p in zip(treqs, jreqs, plain_reqs):
            assert np.array_equal(t.output, np.asarray(j.output)), run
            assert np.array_equal(t.output, p.output), run
            assert t.prefix_hit_tokens == j.prefix_hit_tokens, run
            assert t.prefill_chunks == j.prefill_chunks, run
            assert t.admit_cost_s == pytest.approx(j.admit_cost_s), run
        ts, js = teng.prefix_stats(), jeng.prefix_stats()
        assert ts.keys() == js.keys()
        for key in ts:
            assert ts[key] == pytest.approx(js[key], rel=1e-12), (run, key)
        assert ts["prefix_hit_rate"] > 0, run
        if run == "warm":
            assert ts["prefill_dispatches_saved"] > 0
        else:
            assert ts["prefix_cow_clones"] > 0
        assert teng.scheduler.modeled_admit_cost_s == pytest.approx(
            jeng.scheduler.modeled_admit_cost_s)
        teng.prefix_cache.check()
        teng.reset(preserve_prefix=True)
        jeng.reset(preserve_prefix=True)
    assert teng.prefix_cache.num_cached > 0
    teng.reset()
    assert teng.prefix_cache.num_cached == 0
    assert teng.kv.pool.num_free == teng.kv.pool.num_blocks


def test_cow_clone_copies_one_block_in_place(bundles):
    _, _, model, _ = bundles
    pool = model.init_paged_cache(6, BS)
    gen = torch.Generator().manual_seed(0)
    for t in pool.values():
        t.copy_(torch.randn(t.shape, generator=gen))
    before = {n: t.clone() for n, t in pool.items()}
    model.clone_paged_block(pool, 4, 1)
    for n, t in pool.items():
        assert (t[:, 1] == before[n][:, 4]).all()
        keep = [0, 2, 3, 4, 5]
        assert (t[:, keep] == before[n][:, keep]).all()


def test_capability_and_layout_raises(bundles):
    _, _, model, params = bundles
    kw = dict(cache_len=16, num_slots=1, device="cpu")
    with pytest.raises(ValueError, match="kv_layout='paged'"):
        ContinuousEngine(model, params, prefix_cache=True, **kw)
    for arch in ("mamba2-370m", "hymba-1.5b"):
        fam = build_model(get_smoke_config(arch), F32, device="cpu")
        assert fam.clone_paged_block is None
        with pytest.raises(ValueError, match="capability 'prefix_cache'"):
            ContinuousEngine(fam, fam.init(0), prefix_cache=True,
                             kv_layout="paged", **kw)


def test_run_traffic_prefix_compare_matches_reference(bundles, monkeypatch):
    """The launcher's prefix comparison on both sides with the same trace,
    prompts (the port's prompt source patched to the reference's) and
    parameters: baseline, cold and warm token-identical, and the warm
    run's hit rate, tokens and dispatches saved equal to the reference's
    (the cold run's hits depend on arrival timing; the warm run finds
    every prompt's full blocks resident)."""
    import repro.launch.serve as jlaunch
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models.registry import make_synthetic_batch
    from repro_torch.launch import serve as launch
    jcfg = jax_smoke_config("gemma-2b")
    monkeypatch.setattr(launch, "synthetic_tokens", lambda cfg, b, s, seed:
                        np.asarray(make_synthetic_batch(
                            jcfg, b, s, seed=seed,
                            compute_dtype="float32")["tokens"], np.int32))
    kw = dict(smoke=True, engine="continuous", requests=6, slots=2,
              prompt_len=40, max_new=(2, 5), rate=400.0, seed=0,
              chunk_compare=False, paged_compare=False, parity_check=False,
              prefill_chunk=8, block_size=BS, prefix_compare=True)
    ref = jlaunch.run_traffic("gemma-2b", spec_compare=False, **kw)
    res = launch.run_traffic("gemma-2b", device="cpu", params=bundles[3],
                             spec_compare=False, **kw)
    assert res["prefix_token_identical"] and ref["prefix_token_identical"]
    for key in ("prefix_hit_rate", "prefill_tokens_saved",
                "prefill_dispatches_saved"):
        assert res[key] == ref[key], key
    for key in ("shared_prefix_len", "num_blocks", "prefix_groups"):
        assert res["prefix"][key] == ref["prefix"][key], key
    assert res["prefill_dispatches_saved"] > 0
    out = res["prefix"]["outputs_by_arm"]
    assert out["baseline"] == out["cold"] == out["warm"]
