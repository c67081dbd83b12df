"""The port's runtime threadcomm sanitizer (``repro_torch.analysis``)
against the reference's, on the CPU.

* Every scenario of ``tests/test_sanitizer.py`` runs through both
  packages: the same program, the reference test's own checks on each
  side, and the findings compared (kinds, counts and messages, with the
  sites in them compared by file only).
* ``hb`` and ``ledger`` against the reference's with hypothesis: random
  operation sequences give the same answers and provenance strings.
* The armed paths under ``install(strict=True)``: the disaggregated
  fabric (gemma-2b smoke, 2 ranks, migrations) and the explicit trainer
  on the smallest two-level mesh (float32 and bf16 wires) run clean, with
  the tokens, losses and launch counts of the unarmed runs.
* A request on the card completes through the CUDA event's ``query()``:
  ``test()`` reports completion to the sanitizer once, on the call that
  turns it done.
"""

import os
import re
import warnings
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import torch_parity as tp
from test_torch_fabric_units import _JaxStubModel, _StubModel
from repro.analysis import hb as jax_hb
from repro.analysis import ledger as jax_ledger
from repro.analysis import sanitizer as jax_san
from repro.core import comm as jax_comm
from repro.core.compat import make_mesh as jax_make_mesh
from repro.serve import block_pool as jax_block_pool
from repro.serve import kv_cache as jax_kv_cache
from repro.serve.fabric import transport as jax_transport
from repro.serve.prefix_cache import PrefixCache as JaxPrefixCache
from repro_torch.analysis import hb, ledger
from repro_torch.analysis import sanitizer as S
from repro_torch.core import comm as port_comm
from repro_torch.core.compat import make_mesh
from repro_torch.serve import block_pool as port_block_pool
from repro_torch.serve import kv_cache as port_kv_cache
from repro_torch.serve.fabric import transport as port_transport
from repro_torch.serve.prefix_cache import PrefixCache


#: the two packages' surfaces, addressed alike by every scenario
SIDES = {
    "reference": SimpleNamespace(
        S=jax_san, Request=jax_comm.Request,
        mesh=lambda: jax_make_mesh((1,), ("ranks",)),
        threadcomm_init=jax_comm.threadcomm_init,
        BlockPool=jax_block_pool.BlockPool,
        PagedKVCache=jax_block_pool.PagedKVCache, stub=_JaxStubModel,
        PrefixCache=JaxPrefixCache,
        KVBlockTransport=jax_transport.KVBlockTransport, copy="_copy",
        SlotError=jax_kv_cache.SlotError,
        LeaseLeakWarning=jax_kv_cache.LeaseLeakWarning,
        LeaseLeakError=jax_kv_cache.LeaseLeakError,
        zeros=lambda *shape: jnp.zeros(shape)),
    "port": SimpleNamespace(
        S=S, Request=port_comm.Request,
        mesh=lambda: make_mesh((1,), ("ranks",), device="cpu"),
        threadcomm_init=port_comm.threadcomm_init,
        BlockPool=port_block_pool.BlockPool,
        PagedKVCache=port_block_pool.PagedKVCache, stub=_StubModel,
        PrefixCache=PrefixCache,
        KVBlockTransport=port_transport.KVBlockTransport,
        copy="_copy_impl", SlotError=port_kv_cache.SlotError,
        LeaseLeakWarning=port_kv_cache.LeaseLeakWarning,
        LeaseLeakError=port_kv_cache.LeaseLeakError,
        zeros=lambda *shape: torch.zeros(shape)),
}

_SITE = re.compile(r"(\S+?\.py):\d+")


def _by_file(text: str) -> str:
    """Sites compared by file only: ``/x/y/test.py:12`` -> ``test.py``."""
    return _SITE.sub(lambda m: os.path.basename(m.group(1)), text)


def _record(findings, *extra):
    return ([(f.kind, _by_file(f.message), _by_file(f.site))
             for f in findings] + [_by_file(str(e)) for e in extra])


def _tc(side):
    comm = side.threadcomm_init(side.mesh(), process_axes=(),
                                thread_axes=("ranks",))
    comm.start()
    return comm


def _close(tc):
    if tc._active:
        tc.finish()
    tc.free()


# ---------------------------------------------------------------------------
# the scenarios of tests/test_sanitizer.py, one function each
# ---------------------------------------------------------------------------

def case_unmatched_request_at_finish(side, san):
    tc = _tc(side)
    side.Request(tc, "isend", side.zeros(2))
    tc.finish()
    hits = san.findings_of("unmatched-request")
    assert len(hits) == 1
    assert "isend" in hits[0].message and "finish()" in hits[0].message
    assert "test_torch_sanitizer" in hits[0].site   # caller, not comm.py
    _close(tc)
    return _record(san.findings)


def case_waited_request_is_matched(side, san):
    tc = _tc(side)
    side.Request(tc, "isend", side.zeros(2)).wait()
    tc.finish()
    assert san.findings == []
    _close(tc)
    return _record(san.findings)


def case_tested_request_is_matched(side, san):
    tc = _tc(side)
    done, _ = side.Request(tc, "isend", side.zeros(2)).test()
    assert done
    tc.finish()
    assert san.findings == []
    _close(tc)
    return _record(san.findings)


def case_strict_raises_at_finish(side, san):
    strict = side.S.install(strict=True)
    tc = _tc(side)
    side.Request(tc, "isend", side.zeros(2))
    with pytest.raises(side.S.SanitizerError,
                       match="unmatched-request") as err:
        tc.finish()
    side.S.uninstall()
    _close(tc)          # strict raised before finish() flipped the window
    return _record(strict.findings, err.value)


def case_assert_clean_reports_pending(side, san):
    tc = _tc(side)
    r = side.Request(tc, "isend", side.zeros(2))
    with pytest.raises(side.S.SanitizerError, match="never completed") \
            as err:
        san.assert_clean()
    r.wait()
    tc.finish()
    san.assert_clean()
    _close(tc)
    return _record(san.findings, err.value)


def _two_streams(side, san, comms, order=False, one_stream=False):
    tc = _tc(side)
    subs = comms(tc)

    def body(x):
        with tc.stream("s-a"):
            r1 = subs[0].iallreduce(x)
            if one_stream:
                r2 = subs[1].iallreduce(x)
        if order:
            r1.wait()
        if not one_stream:
            with tc.stream("s-b"):
                r2 = subs[1].iallreduce(x)
        r1.wait()
        r2.wait()
        return x

    tc.run(body, side.zeros(1))
    tc.finish()
    _close(tc)
    return san.findings_of("serialization-hazard")


def case_cross_stream_hazard_same_comm(side, san):
    def same(tc):
        sub = tc.dup()
        return sub, sub
    hits = _two_streams(side, san, same)
    assert len(hits) == 1 and "dup()" in hits[0].message
    return _record(san.findings)


def case_no_hazard_on_dup_comms(side, san):
    assert _two_streams(side, san, lambda tc: (tc.dup(), tc.dup())) == []
    return _record(san.findings)


def case_no_hazard_when_wait_orders_streams(side, san):
    def same(tc):
        sub = tc.dup()
        return sub, sub
    assert _two_streams(side, san, same, order=True) == []
    return _record(san.findings)


def case_no_hazard_within_one_stream(side, san):
    def same(tc):
        sub = tc.dup()
        return sub, sub
    assert _two_streams(side, san, same, one_stream=True) == []
    return _record(san.findings)


def case_double_free_provenance(side, san):
    pool = side.BlockPool(8, 4)
    blocks = pool.alloc(2, "req-7")
    pool.free(blocks)
    with pytest.raises(side.SlotError) as err:
        pool.free(blocks)
    for part in ("allocated at", "first freed at", "test_torch_sanitizer"):
        assert part in str(err.value)
    hits = san.findings_of("double-free")
    assert len(hits) == 1 and "req-7" in hits[0].message
    return _record(san.findings, err.value)


def case_lease_leak_at_reset(side, san):
    pool = side.BlockPool(8, 4)
    pool.alloc(3, "leaker")
    with pytest.warns(side.LeaseLeakWarning, match="leaker") as caught:
        pool.reset()
    hits = san.findings_of("lease-leak")
    assert len(hits) == 3
    assert all("allocated at" in h.message for h in hits)
    return _record(san.findings, *[w.message for w in caught])


def case_clean_reset_no_findings(side, san):
    pool = side.BlockPool(8, 4)
    pool.free(pool.alloc(3, "tidy"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pool.reset()
    assert san.findings == []
    return _record(san.findings)


def case_shared_ref_double_free_provenance(side, san):
    pool = side.BlockPool(8, 4)
    [b] = pool.alloc(1, "req-a")
    pool.ref(b, owner="prefix-cache")       # shared lease
    pool.free([b])                          # req-a done (non-final drop)
    pool.free([b])                          # cache evicts (final)
    with pytest.raises(side.SlotError) as err:
        pool.free([b])                      # the bug under test
    msg = str(err.value)
    for part in ("shared 2-way", "ref'd at", "'prefix-cache'",
                 "allocated at", "first freed at", "shared refs freed at",
                 "test_torch_sanitizer"):
        assert part in msg
    assert len(san.findings_of("double-free")) == 1
    return _record(san.findings, err.value)


def case_trie_parked_leak_named_at_reset(side, san):
    pool = side.BlockPool(8, 4)
    cache = side.PrefixCache(pool)
    blocks = pool.alloc(2, "req-0")
    cache.insert(list(range(8)), blocks)    # trie refs both blocks
    pool.free(blocks)                       # request done -> parked
    with pytest.warns(side.LeaseLeakWarning):
        pool.reset()
    hits = san.findings_of("lease-leak")
    assert len(hits) == 2
    for part in ("prefix-cache", "allocated at", "shared 2-way"):
        assert all(part in h.message for h in hits)
    assert cache.num_cached == 0 and pool.num_free == 8
    return _record(san.findings)


def case_shared_lifecycle_clean(side, san):
    pool = side.BlockPool(8, 4)
    cache = side.PrefixCache(pool)
    toks = list(range(8))
    blocks = pool.alloc(2, "req-0")
    cache.insert(toks, blocks)
    pool.free(blocks)                        # parked under the trie
    hit = cache.lookup(toks + [9], limit=8)
    assert hit.tokens == 8
    cache.lease(hit, "req-1")                # warm reuse
    pool.free(hit.blocks)                    # req-1 done -> parked again
    cache.clear()                            # cache drops its own refs
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pool.reset()
    assert san.findings == []
    return _record(san.findings)


def case_reset_warns_without_sanitizer(side, san):
    side.S.uninstall()
    pool = side.BlockPool(8, 4)
    pool.alloc(1, "bare")
    with pytest.warns(side.LeaseLeakWarning, match="bare") as caught:
        pool.reset()
    return _record([], *[w.message for w in caught])


def case_reset_strict_raises_without_sanitizer(side, san):
    side.S.uninstall()
    pool = side.BlockPool(8, 4)
    pool.alloc(1, "bare")
    with pytest.raises(side.LeaseLeakError, match="bare") as err:
        pool.reset(strict=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", side.LeaseLeakWarning)
        pool.reset()
    return _record([], err.value)


def case_double_free_message_without_sanitizer(side, san):
    side.S.uninstall()
    pool = side.BlockPool(8, 4)
    blocks = pool.alloc(1, "bare")
    pool.free(blocks)
    with pytest.raises(side.SlotError, match="last owner 'bare'") as err:
        pool.free(blocks)
    return _record([], err.value)


def _paged_pair(side):
    mk = lambda: side.PagedKVCache(side.stub, num_blocks=6, block_size=4,
                                   num_slots=2, max_blocks_per_req=4)
    return mk(), mk()


def case_complete_migration_is_clean(side, san):
    tc = _tc(side)
    src, dst = _paged_pair(side)
    side.KVBlockTransport(tc).migrate(src, dst, [0, 1], [2, 3])
    tc.finish()
    assert san.findings == []
    san.assert_clean()
    _close(tc)
    return _record(san.findings)


def case_interrupted_migration_reported(side, san):
    tc = _tc(side)
    src, dst = _paged_pair(side)
    tport = side.KVBlockTransport(tc)
    real_copy, calls = getattr(tport, side.copy), [0]

    def bomb(*a):
        calls[0] += 1
        if calls[0] == 2:
            raise RuntimeError("simulated device loss")
        return real_copy(*a)

    setattr(tport, side.copy, bomb)
    with pytest.raises(RuntimeError, match="device loss"):
        tport.migrate(src, dst, [0, 1, 4], [2, 3, 5])
    tc.finish()
    # the finally-block waitall completed the issued prefix: no request
    # leaks, but the migration never reached its completion point
    assert san.findings_of("unmatched-request") == []
    hits = san.findings_of("migration-incomplete")
    assert len(hits) == 1 and "3 blocks" in hits[0].message
    _close(tc)
    return _record(san.findings)


def case_uninstalled_comm_hooks_inert(side, san):
    side.S.uninstall()
    assert side.S.active() is None
    tc = _tc(side)
    side.Request(tc, "isend", side.zeros(2))   # leaked on purpose
    tc.finish()                                # must not raise or record
    _close(tc)
    return _record(san.findings)


def case_install_is_fresh_each_time(side, san):
    tc = _tc(side)
    side.Request(tc, "isend", side.zeros(2))
    tc.finish()
    assert len(san.findings) == 1
    fresh = side.S.install()
    assert fresh.findings == []
    _close(tc)
    return _record(san.findings, len(fresh.findings))


SCENARIOS = [
    case_unmatched_request_at_finish, case_waited_request_is_matched,
    case_tested_request_is_matched, case_strict_raises_at_finish,
    case_assert_clean_reports_pending, case_cross_stream_hazard_same_comm,
    case_no_hazard_on_dup_comms, case_no_hazard_when_wait_orders_streams,
    case_no_hazard_within_one_stream, case_double_free_provenance,
    case_lease_leak_at_reset, case_clean_reset_no_findings,
    case_shared_ref_double_free_provenance, case_trie_parked_leak_named_at_reset,
    case_shared_lifecycle_clean, case_reset_warns_without_sanitizer,
    case_reset_strict_raises_without_sanitizer,
    case_double_free_message_without_sanitizer, case_complete_migration_is_clean,
    case_interrupted_migration_reported, case_uninstalled_comm_hooks_inert,
    case_install_is_fresh_each_time,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[len("case_"):])
def test_scenario_matches_reference(scenario):
    """The reference test's checks hold on both sides, and the port's
    findings equal the reference's."""
    records = {}
    for name, side in SIDES.items():
        san = side.S.install()
        try:
            records[name] = scenario(side, san)
        finally:
            side.S.uninstall()
    assert records["port"] == records["reference"]


# ---------------------------------------------------------------------------
# the request's completion on the card: test() through the event's query()
# ---------------------------------------------------------------------------

class _Event:
    """A CUDA event's polling surface: not done for ``pending`` queries."""

    def __init__(self, pending):
        self.pending = pending

    def query(self):
        self.pending -= 1
        return self.pending < 0


def test_event_test_reports_completion_once():
    san = S.install()
    completions = []
    real = san.on_request_complete
    san.on_request_complete = lambda req: (completions.append(req),
                                           real(req))
    tc = _tc(SIDES["port"])
    try:
        req = port_comm.Request(tc, "isend", torch.zeros(2))
        req._event = _Event(pending=2)
        assert req.test() == (False, None)
        assert req.test() == (False, None)
        assert completions == []
        assert req.test()[0] and completions == [req]
        assert req.test()[0] and completions == [req]   # already done
        tc.finish()
        assert san.findings == []
    finally:
        S.uninstall()
        _close(tc)


# ---------------------------------------------------------------------------
# hb and ledger against the reference's, random operation sequences
# ---------------------------------------------------------------------------

_CTX = st.sampled_from(["a", "b", "c", ("stream", 1), ("host", 2)])


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(["tick", "merge", "copy"]),
                          st.integers(0, 3), st.integers(0, 3), _CTX),
                max_size=40))
def test_vector_clocks_match_reference(ops):
    ours = [hb.VectorClock() for _ in range(4)]
    ref = [jax_hb.VectorClock() for _ in range(4)]
    for op, i, j, ctx in ops:
        if op == "tick":
            assert ours[i].tick(ctx) == ref[i].tick(ctx)
        elif op == "merge":
            ours[i].merge(ours[j])
            ref[i].merge(ref[j])
        else:
            ours[i], ref[i] = ours[j].copy(), ref[j].copy()
        for a in range(4):
            for b in range(4):
                assert ours[a].leq(ours[b]) == ref[a].leq(ref[b])
                assert (ours[a].concurrent_with(ours[b])
                        == ref[a].concurrent_with(ref[b]))
    assert [repr(c) for c in ours] == [repr(c) for c in ref]


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(
    st.sampled_from(["alloc", "ref", "release", "forget"]),
    st.integers(0, 1), st.integers(0, 3),
    st.sampled_from([None, "req-0", "prefix-cache"]),
    st.sampled_from(["a.py:1", "b.py:2", "c.py:3"])), max_size=40))
def test_ledger_matches_reference(ops):
    ours, ref = ledger.LeaseLedger(), jax_ledger.LeaseLedger()
    for op, pool, res, owner, site in ops:
        for led in (ours, ref):
            if op == "alloc":
                led.on_alloc(pool, res, owner or "req-1", site)
            elif op == "ref":
                led.on_ref(pool, res, owner=owner, site=site)
            elif op == "release":
                led.on_release(pool, res, site)
            else:
                led.forget_pool(pool)
        for p in (0, 1):
            for r in range(4):
                assert ours.provenance(p, r) == ref.provenance(p, r)
            assert ([(r, vars(rec)) for r, rec in ours.live_for(p)]
                    == [(r, vars(rec)) for r, rec in ref.live_for(p)])


# ---------------------------------------------------------------------------
# the armed paths: strict sanitizer, same results as unarmed
# ---------------------------------------------------------------------------

def _fabric_run(model, params, vocab):
    from repro_torch.launch import serve as launch
    from repro_torch.serve import ServeRequest, ServingFabric, make_trace
    fab = ServingFabric(model, params, ranks=2, placement="disagg",
                        cache_len=48 + 8, slots_per_rank=4,
                        prefill_chunk=16, max_prefill_per_step=2,
                        block_size=8, device="cpu")
    trace = make_trace(4, prompt_len=(16, 48), max_new=(3, 6),
                       arrival="all", seed=0)
    reqs = [ServeRequest(rid=i, batch={"tokens": np.random.default_rng(
                i).integers(0, vocab, size=(1, e.prompt_len)).astype(
                    np.int32)}, max_new_tokens=e.max_new)
            for i, e in enumerate(trace)]
    try:
        launch.reset_kernel_counters()
        for r in reqs:
            fab.submit(r, 0.0)
        while not fab.idle:
            fab.step(0.0)
        counts = launch.kernel_counters()
        migrations = fab.transport.n_migrations
    finally:
        fab.close(strict=True)
    return [r.output.tolist() for r in reqs], counts, migrations


def test_armed_fabric_runs_clean():
    """The disaggregated fabric under the strict sanitizer: no finding,
    nothing pending, the unarmed run's tokens and launch counts, and the
    hooks saw every migration and lease."""
    _, _, model, params = tp.bundle("gemma-2b")
    vocab = model.cfg.vocab_size
    plain = _fabric_run(model, params, vocab)
    san = S.install(strict=True)
    seen = {"alloc": 0, "migrate": 0}
    for hook, key in (("on_lease_alloc", "alloc"),
                      ("on_migrate_end", "migrate")):
        real = getattr(san, hook)

        def counted(*a, real=real, key=key):
            seen[key] += 1
            return real(*a)
        setattr(san, hook, counted)
    try:
        armed = _fabric_run(model, params, vocab)
        san.assert_clean()
    finally:
        S.uninstall()
    assert san.findings == []
    assert armed == plain
    assert seen["migrate"] == armed[2] == 4 and seen["alloc"] > 0


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_armed_explicit_trainer_runs_clean(wire):
    """One step of the explicit trainer on pod 2 x data 2 (both levels,
    the "grad" stream's iallreduce) under the strict sanitizer: clean,
    with the unarmed step's loss and parameters."""
    from repro_torch.config import MeshConfig, ServeConfig, TrainConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticPipeline
    from repro_torch.models.registry import build_model
    from repro_torch.train.explicit import flatten_tree, init_explicit_state
    from repro_torch.train.trainer import make_train_step

    cfg = get_smoke_config("gemma-2b")
    tcfg = TrainConfig(param_dtype="float32", compute_dtype="float32",
                       grad_sync="threadcomm", grad_comm_dtype=wire,
                       loss_chunk=16, remat=False)
    mesh_cfg = MeshConfig(shape=(2, 2, 1), axis_names=("pod", "data",
                                                       "model"),
                          process_axes=("pod",))
    model = build_model(cfg, ServeConfig(), device="cpu", train=tcfg)
    batch = {k: torch.from_numpy(v) for k, v in SyntheticPipeline(
        cfg, batch=4, seq_len=16, seed=0).get_batch(0).items()}

    def one_step():
        step = make_train_step(model, mesh_cfg, tcfg, mesh=make_mesh(
            (2, 2, 1), ("pod", "data", "model"), device="cpu"))
        state, met = step(init_explicit_state(model, 0, dp=4), batch)
        step.comm.finish()
        return float(met["loss"]), flatten_tree(state.params)

    loss, params = one_step()
    san = S.install(strict=True)
    issued = []
    real = san.on_request
    san.on_request = lambda req: (issued.append(req.op), real(req))
    try:
        armed_loss, armed_params = one_step()
        san.assert_clean()
    finally:
        S.uninstall()
    assert san.findings == [] and issued == ["allreduce"]
    assert armed_loss == loss and torch.equal(armed_params, params)


def test_hooks_from_many_threads_lose_no_update():
    """The lease hooks from more threads than cores at a tiny switch
    interval (the fabric's rank threads lease at once): every shared ref
    and release of one block is counted, and no pool reset's scan of the
    ledger races another thread's insert."""
    import sys
    import threading

    san = S.install()
    shared, n_threads, rounds = object(), 4 * min(os.cpu_count() or 1, 16), 100
    san.on_lease_alloc(shared, [0], "root")
    errors = []

    def work(t):
        try:
            own = object()
            for _ in range(rounds):
                san.on_lease_ref(shared, 0, owner=t)
                san.on_lease_alloc(own, range(32), t)
                for b in range(32):
                    san.on_lease_release(own, b)
                san.on_pool_reset(own)     # scans the ledger, then drops
                san.on_lease_release(shared, 0)
        except Exception as e:   # reported below, with the thread's id
            errors.append((t, e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
        S.uninstall()
    assert errors == []
    [(res, rec)] = san.ledger.live_for(id(shared))
    assert res == 0 and rec.refs == 1
    assert len(rec.ref_sites) == len(rec.shared_free_sites) == \
        n_threads * rounds
    assert san.findings == []
