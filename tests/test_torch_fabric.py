"""The port's serving fabric against the reference's, on the CPU
(gemma-2b smoke, float32, the reference's parameters moved over).

The reference test's geometry: a 56-token cache, chunk 16, 8-token
blocks, 2 ranks of 4 rows, 6 requests of 16-48 tokens with 3-8 new
ones, all arriving at once; prompts drawn by numpy from the seed. Each
placement's reference run is a module-scoped fixture, driven beside the
port's run on the same requests:

- replicated: the same greedy tokens, rank assignments, per-rank
  dispatched / finished / tokens, fabric steps and router census;
- disaggregated, besides: the same decode ranks, blocks, migrations,
  bytes, and modeled migration costs (1e-12 relative); the prefill rank
  produced no token and both pools are free after the drain;
- the replicated fabric with ``speculate=2``: the reference's tokens;
- a sampled trace (temperature 0.8, ``eos_id=-1``) gives the same tokens
  through the port's disaggregated fabric as through the port's single
  engine: each request's generator migrates with it.
"""

import numpy as np
import pytest

import torch_parity as tp
from repro.serve import ServeRequest as JaxRequest
from repro.serve import ServingFabric as JaxFabric
from repro_torch.serve import (ContinuousEngine, ServeRequest, ServingFabric,
                               make_trace)

CACHE_LEN = 48 + 8          # longest prompt + max_new ceiling
CHUNK = 16
BLOCK = 8
CENSUS = ("router_eager_admits", "router_deferred", "router_dispatch_cost_us",
          "router_submitted", "router_in_flight", "arrival_span_s")
RANK_ROW = ("rank", "role", "steps", "busy_steps", "utilization",
            "dispatched", "migrated_in", "migrated_out", "finished",
            "tokens", "predicted_load_s")


@pytest.fixture(scope="module")
def bundle():
    return tp.bundle("gemma-2b")


def requests(cls, vocab, n=6, seed=0, prompt_len=(16, 48), max_new=(3, 8),
             temperature=0.0):
    """The reference test's trace; prompts from ``seed + 1000 + rid``."""
    trace = make_trace(n, prompt_len=prompt_len, max_new=max_new,
                       arrival="all", temperature=temperature, seed=seed)
    return [cls(rid=rid, batch={"tokens": np.random.default_rng(
                    seed + 1000 + rid).integers(
                        0, vocab, size=(1, e.prompt_len)).astype(np.int32)},
                max_new_tokens=e.max_new, temperature=e.temperature,
                seed=seed, arrival=e.arrival)
            for rid, e in enumerate(trace)]


def drain(driveable, reqs, limit=4000):
    for r in reqs:
        driveable.submit(r, 0.0)
    steps = 0
    while not driveable.idle:
        driveable.step(0.0)
        steps += 1
        assert steps < limit, "failed to drain"
    return steps


def fabric(cls, model, params, placement, **kw):
    return cls(model, params, ranks=2, placement=placement,
               cache_len=CACHE_LEN, slots_per_rank=4, prefill_chunk=CHUNK,
               max_prefill_per_step=2, block_size=BLOCK, **kw)


def run(cls, req_cls, model, params, placement, vocab, **kw):
    """Drain the trace through a fresh fabric; what the comparison needs,
    read before ``close``."""
    fab = fabric(cls, model, params, placement, **kw)
    try:
        reqs = requests(req_cls, vocab)
        drain(fab, reqs)
        return {
            "reqs": reqs, "stats": fab.stats(),
            "tokens_out": [w.tokens_out for w in fab.workers],
            "pools_free": [w.engine.kv.pool.num_free
                           == w.engine.kv.pool.num_blocks
                           for w in fab.workers],
        }
    finally:
        fab.close()


@pytest.fixture(scope="module")
def pairs(bundle):
    """``pairs(placement)``: (the reference's run, the port's run) of one
    placement, each run once a module."""
    jmodel, jparams, model, params = bundle
    vocab = model.cfg.vocab_size
    memo = {}

    def get(placement):
        if placement not in memo:
            memo[placement] = (
                run(JaxFabric, JaxRequest, jmodel, jparams, placement,
                    vocab),
                run(ServingFabric, ServeRequest, model, params, placement,
                    vocab, device="cpu"))
        return memo[placement]
    return get


def _outputs(reqs):
    return [r.output[:r.generated] for r in reqs]


@pytest.mark.parametrize("placement", ["replicated", "disagg"])
def test_fabric_matches_reference(pairs, placement):
    """Both placements: tokens, rank assignments, per-rank rows, steps
    and the router census equal the reference's."""
    ref, ours = pairs(placement)
    for a, b in zip(_outputs(ref["reqs"]), _outputs(ours["reqs"])):
        assert np.array_equal(a, b)
    assert [r.rank for r in ours["reqs"]] == [r.rank for r in ref["reqs"]]
    assert sorted({r.rank for r in ours["reqs"]}) == (
        [0, 1] if placement == "replicated" else [0])
    js, st = ref["stats"], ours["stats"]
    assert set(st) == set(js)
    assert st["fabric_steps"] == js["fabric_steps"]
    assert st["placement"] == js["placement"] == placement
    for key in CENSUS:
        assert st[key] == pytest.approx(js[key], rel=1e-12, abs=0.0), key
    assert len(st["per_rank"]) == len(js["per_rank"]) == 2
    for row, jrow in zip(st["per_rank"], js["per_rank"]):
        assert tuple(row) == tuple(jrow) == RANK_ROW
        for key in ("rank", "role", "dispatched", "finished", "tokens",
                    "migrated_in", "migrated_out", "steps", "busy_steps"):
            assert row[key] == jrow[key], key
    assert ours["pools_free"] == ref["pools_free"] == [True, True]


def test_disagg_migration_matches_reference(pairs):
    """Disaggregated: decode ranks, blocks, migrations, bytes and the
    modeled costs equal the reference's; the prefill rank emits no token
    and every token comes from the decode rank."""
    ref, ours = pairs("disagg")
    jreqs, reqs = ref["reqs"], ours["reqs"]
    assert [r.decode_rank for r in reqs] == [r.decode_rank for r in jreqs]
    assert all(r.decode_rank == 1 for r in reqs)
    assert [r.kv_blocks_moved for r in reqs] == \
        [r.kv_blocks_moved for r in jreqs]
    assert [r.kv_blocks_moved for r in reqs] == \
        [-(-r.prompt_len // BLOCK) for r in reqs]
    for r, j in zip(reqs, jreqs):
        assert r.kv_migration_s == pytest.approx(j.kv_migration_s,
                                                 rel=1e-12, abs=0.0)
        assert r.kv_migration_s > 0.0
    js, st = ref["stats"], ours["stats"]
    for key in ("n_migrations", "blocks_moved", "bytes_moved"):
        assert st[key] == js[key], key
    assert st["n_migrations"] == len(reqs)
    for key in ("kv_migration_modeled_s", "kv_migration_us_per_block",
                "kv_migration_p50_us", "kv_migration_p95_us"):
        assert st[key] == pytest.approx(js[key], rel=1e-12, abs=0.0), key
    assert ours["tokens_out"] == ref["tokens_out"]
    assert ours["tokens_out"][0] == 0
    assert ours["tokens_out"][1] == sum(r.generated for r in reqs)


def test_speculative_fabric_matches_reference(bundle):
    """The replicated fabric with ``speculate=2`` on every rank gives the
    reference's tokens and rank assignments."""
    jmodel, jparams, model, params = bundle
    vocab = model.cfg.vocab_size
    ref = run(JaxFabric, JaxRequest, jmodel, jparams, "replicated", vocab,
              speculate=2)
    ours = run(ServingFabric, ServeRequest, model, params, "replicated",
               vocab, speculate=2, device="cpu")
    for a, b in zip(_outputs(ref["reqs"]), _outputs(ours["reqs"])):
        assert np.array_equal(a, b)
    assert [r.rank for r in ours["reqs"]] == [r.rank for r in ref["reqs"]]
    assert ours["stats"]["fabric_steps"] == ref["stats"]["fabric_steps"]


def test_sampled_handoff_continues_the_generator(bundle):
    """A sampled trace through the port's disaggregated fabric gives the
    single engine's tokens: the generator that drew the first token on
    the prefill rank draws the rest on the decode rank."""
    _, _, model, params = bundle
    vocab = model.cfg.vocab_size
    single = requests(ServeRequest, vocab, temperature=0.8)
    drain(ContinuousEngine(model, params, cache_len=CACHE_LEN, num_slots=4,
                           prefill_chunk=CHUNK, max_prefill_per_step=2,
                           kv_layout="paged", block_size=BLOCK, eos_id=-1,
                           device="cpu"), single)
    fab = fabric(ServingFabric, model, params, "disagg", eos_id=-1,
                 device="cpu")
    try:
        reqs = requests(ServeRequest, vocab, temperature=0.8)
        drain(fab, reqs)
        assert fab.stats()["n_migrations"] == len(reqs)
    finally:
        fab.close(strict=True)
    for a, b in zip(_outputs(single), _outputs(reqs)):
        assert np.array_equal(a, b)
    # sampled, not greedy: the same prompts decoded greedily differ
    greedy = requests(ServeRequest, vocab)
    drain(ContinuousEngine(model, params, cache_len=CACHE_LEN, num_slots=4,
                           prefill_chunk=CHUNK, kv_layout="paged",
                           block_size=BLOCK, device="cpu"), greedy)
    assert any(not np.array_equal(a, b)
               for a, b in zip(_outputs(greedy), _outputs(reqs)))
