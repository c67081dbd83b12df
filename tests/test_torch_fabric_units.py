"""Units of the port's serving fabric, on the CPU (gemma-2b smoke,
float32): the placements, the router's refusals and dispatch, the
KV-block transport against the reference's, the engine's prefill role,
trial hygiene (``reset``, ``close(strict=True)``), the split path of a
wide comm, the launch counters under threads, the migration price, and
``run_fabric``'s keys against the reference launcher's."""

import sys
import threading
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.core import protocol as jax_protocol
from repro.core import threadcomm_init as jax_threadcomm_init
from repro.core.compat import make_mesh as jax_make_mesh
from repro.serve.block_pool import PagedKVCache as JaxPagedKVCache
from repro.serve.fabric.placement import make_placement as jax_placement
from repro.serve.fabric.transport import KVBlockTransport as JaxTransport
from repro_torch.configs import get_smoke_config
from repro_torch.core import compat, protocol, threadcomm_init
from repro_torch.core.comm import ThreadCommError
from repro_torch.kernels.paged_attention import ops
from repro_torch.models.registry import build_model
from repro_torch.serve import (ContinuousEngine, LeaseLeakError,
                               PagedKVCache, ServeRequest, ServingFabric,
                               make_trace, shard_trace)
from repro_torch.serve.fabric import KVBlockTransport, make_placement
from repro_torch.serve.scheduler import make_trace as port_make_trace

CACHE_LEN = 48 + 8
CHUNK = 16
BLOCK = 8


@pytest.fixture(scope="module")
def bundle():
    return tp.bundle("gemma-2b")


def requests(vocab, n=6, seed=0, prompt_len=(16, 48), max_new=(3, 8)):
    trace = make_trace(n, prompt_len=prompt_len, max_new=max_new,
                       arrival="all", seed=seed)
    return [ServeRequest(rid=rid, batch={"tokens": np.random.default_rng(
                             seed + 1000 + rid).integers(
                                 0, vocab, size=(1, e.prompt_len)).astype(
                                     np.int32)},
                         max_new_tokens=e.max_new, seed=seed)
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


def fabric(model, params, placement, **kw):
    kw = dict(dict(ranks=2, cache_len=CACHE_LEN, slots_per_rank=4,
                   prefill_chunk=CHUNK, max_prefill_per_step=2,
                   block_size=BLOCK, device="cpu"), **kw)
    return ServingFabric(model, params, placement=placement, **kw)


@pytest.fixture
def cpu_comm():
    """A started one-rank threadcomm on the CPU."""
    comm = threadcomm_init(compat.make_mesh((1,), ("serve",), device="cpu"),
                           process_axes=(), thread_axes=("serve",))
    comm.start()
    yield comm
    comm.finish()
    comm.free()


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name, n_prefill, ranks", [
    ("replicated", 1, 3), ("disagg", 1, 3), ("disagg", 2, 4),
    ("disagg", 1, 1), ("disagg", 2, 2), ("replicated", 1, 0)])
def test_placement_roles_match_reference(name, n_prefill, ranks):
    """Roles, and the reference's ValueErrors where it raises."""
    ours, ref = make_placement(name, n_prefill), jax_placement(name,
                                                              n_prefill)
    assert (ours.name, ours.needs_migration) == (ref.name,
                                                 ref.needs_migration)
    try:
        want = ref.roles(ranks)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            ours.roles(ranks)
        assert str(err.value) == str(e)
    else:
        assert ours.roles(ranks) == want


def test_placement_validation_errors():
    for bad in (lambda: make_placement("ring"),
                lambda: make_placement("disagg", n_prefill=0)):
        with pytest.raises(ValueError):
            bad()


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("placement,role", [("disagg", "decode"),
                                            ("replicated", "full")])
def test_fabric_rejects_unservable_budget(bundle, placement, role):
    """An unservable budget fails at the router's submit, for either
    placement, with nothing half-queued."""
    _, _, model, params = bundle
    fab = fabric(model, params, placement)
    try:
        req = ServeRequest(rid=0, batch={"tokens": np.zeros((1, 16),
                                                            np.int32)},
                           max_new_tokens=10 * CACHE_LEN)
        with pytest.raises(ValueError, match=f"{role}-rank capacity"):
            fab.submit(req, 0.0)
        assert fab.scheduler.num_waiting == 0
    finally:
        fab.close(strict=True)


def test_fabric_refusals(bundle):
    """Speculation under disaggregation, and disaggregation of a family
    without the 'kv_migration' capability, are refused up front."""
    _, _, model, params = bundle
    with pytest.raises(ValueError, match="disaggregated"):
        fabric(model, params, "disagg", speculate=2)
    mamba = build_model(get_smoke_config("mamba2-370m"), tp.F32,
                        device="cpu")
    with pytest.raises(ValueError, match="kv_migration"):
        fabric(mamba, {}, "disagg")


def test_dispatch_window_backpressure(bundle):
    _, _, model, params = bundle
    fab = fabric(model, params, "replicated", dispatch_window=1)
    try:
        reqs = requests(model.cfg.vocab_size)
        for r in reqs:
            fab.submit(r, 0.0)
        fab._dispatch(0.0)
        # a window of 1 a rank: at most 2 dispatched, the rest wait at
        # the router
        assert fab.scheduler.num_waiting >= 4
        assert sum(w.n_dispatched for w in fab.workers) <= 2
        drain(fab, [])
        assert all(r.output is not None for r in reqs)
    finally:
        fab.close(strict=True)


def test_jsq_balances_predicted_cost_not_count(bundle):
    """On an alternating 16/256-token trace a count-JSQ would hand every
    long prompt to one rank; the cost-JSQ splits them."""
    _, _, model, params = bundle
    fab = fabric(model, params, "replicated", cache_len=320, block_size=16)
    try:
        reqs = [ServeRequest(rid=rid, batch={"tokens": np.zeros(
                    (1, 16 if rid % 2 == 0 else 256), np.int32)},
                    max_new_tokens=2) for rid in range(8)]
        for r in reqs:
            fab.submit(r, 0.0)
        fab._dispatch(0.0)
        assert all(r.rank >= 0 for r in reqs)
        w0, w1 = fab.workers
        assert isinstance(w0.load, float)
        assert w0.queue_depth + w1.queue_depth == 8
        heavy = w0.predicted_cost_s(reqs[1])
        assert heavy > 3 * w0.predicted_cost_s(reqs[0])
        heavies = [sum(1 for r in reqs if r.rank == w.rank
                       and r.prompt_len == 256) for w in fab.workers]
        assert min(heavies) >= 1, heavies
        toks = [sum(r.prompt_len for r in reqs if r.rank == w.rank)
                for w in fab.workers]
        assert max(toks) - min(toks) <= 256, toks
        assert abs(w0.load - w1.load) <= heavy + 1e-12
    finally:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # dispatched only: in flight
            fab.close()


def test_reset_between_back_to_back_trials(bundle):
    """``reset`` clears the router's rid-keyed log, every rank and the
    migration counters: trial 2 counts trial 2 only."""
    _, _, model, params = bundle
    fab = fabric(model, params, "disagg")
    try:
        drain(fab, requests(model.cfg.vocab_size, n=4, seed=1))
        assert fab.stats()["n"] == 4
        assert len(fab.scheduler.req_log) == 4
        fab.reset()
        assert fab.scheduler.req_log == {}
        assert fab.stats().get("n", 0.0) == 0.0
        assert fab.stats()["n_migrations"] == 0.0
        assert all(w.total_steps == 0 for w in fab.workers)
        reqs2 = requests(model.cfg.vocab_size, n=4, seed=2)
        drain(fab, reqs2)
        st = fab.stats()
        assert st["n"] == 4 and st["n_migrations"] == 4
        assert sorted(fab.scheduler.req_log) == [0, 1, 2, 3]
        assert all(fab.scheduler.req_log[r.rid] is r for r in reqs2)
    finally:
        fab.close(strict=True)


def test_close_strict_names_a_leaked_lease(bundle):
    """Closing over live leases raises under ``strict=True``, naming the
    ranks that hold them, and still finishes the owned comm."""
    _, _, model, params = bundle
    fab = fabric(model, params, "disagg")
    for r in requests(model.cfg.vocab_size, n=3):
        fab.submit(r, 0.0)
    fab.step(0.0)
    assert any(w.engine.kv.num_live for w in fab.workers)
    comm = fab.comm
    with pytest.raises(LeaseLeakError, match="rank 0 \\(prefill\\)"):
        fab.close(strict=True)
    assert not fab._owns_comm and fab._rank_pool is None
    assert fab.scheduler.req_log == {}
    with pytest.raises(ThreadCommError):
        comm.dup()


def test_split_path_gives_each_rank_its_color_class(bundle):
    """On a 4-rank comm each engine rank's context is a dup of the
    split into two colour classes, and the fabric still serves."""
    _, _, model, params = bundle
    root = threadcomm_init(compat.make_mesh((4,), ("serve",), device="cpu"),
                           process_axes=(), thread_axes=("serve",))
    root.start()
    try:
        fab = fabric(model, params, "disagg", comm=root)
        classes = [[0, 1], [2, 3]]
        for w in fab.workers:
            assert w.comm is not root
            assert w.engine._decode_stream.comm is w.comm
            assert w.comm.families() == classes
            assert w.comm.families()[w.rank] == [
                ur for ur in range(4) if ur * 2 // 4 == w.rank]
        reqs = requests(model.cfg.vocab_size, n=2)
        drain(fab, reqs)
        fab.close(strict=True)
        root.dup()                       # a passed-in comm stays open
    finally:
        root.finish()
        root.free()


# ---------------------------------------------------------------------------
# the engine's prefill role
# ---------------------------------------------------------------------------

def test_prefill_role_leases_prompt_only(bundle):
    """A prefill engine leases the prompt alone, parks the finished
    prefill with its decode state (the generator object included) and
    never decodes; the submit message names the prompt."""
    _, _, model, params = bundle
    eng = ContinuousEngine(model, params, cache_len=CACHE_LEN, num_slots=4,
                           prefill_chunk=CHUNK, kv_layout="paged",
                           block_size=BLOCK, role="prefill", device="cpu")
    req = ServeRequest(rid=7, batch={"tokens": np.zeros((1, 16), np.int32)},
                       max_new_tokens=32, temperature=0.5)
    assert eng._token_budget(req) == 16
    with pytest.raises(ValueError, match="prompt = 64 tokens"):
        eng.submit(ServeRequest(rid=8, batch={"tokens": np.zeros(
            (1, 64), np.int32)}, max_new_tokens=1), 0.0)
    eng.submit(req, 0.0)
    steps = 0
    while not eng.ready_handoffs:
        eng.step(0.0)
        steps += 1
        assert steps < 50
    h = eng.ready_handoffs[0]
    assert h.req is req and req.state == "migrating"
    assert h.length == 16 and len(h.blocks) == -(-16 // BLOCK)
    assert req.generated == 1 and eng.num_decoding == 0
    state = eng.handoff_state(h.slot)
    assert state["pos"] == 16 and state["tok"] == int(h.out[0])
    assert state["temp"] == 0.5
    assert isinstance(state["gen"], torch.Generator)
    assert eng.take_handoffs() == [h] and not eng.ready_handoffs
    eng.release_handoff(h.slot)
    assert eng.kv.pool.num_free == eng.kv.pool.num_blocks
    with pytest.raises(ValueError, match="not supported on disaggregated"):
        ContinuousEngine(model, params, cache_len=CACHE_LEN, num_slots=2,
                         kv_layout="paged", role="decode",
                         prefix_cache=True, device="cpu")
    with pytest.raises(ValueError, match="not supported on disaggregated"):
        ContinuousEngine(model, params, cache_len=CACHE_LEN, num_slots=2,
                         kv_layout="paged", role="prefill", speculate=2,
                         device="cpu")


# ---------------------------------------------------------------------------
# the transport
# ---------------------------------------------------------------------------

class _StubModel:
    """The reference test's stub pool geometry: (2, P, 4, 1, 2)."""
    device = torch.device("cpu")

    @staticmethod
    def init_paged_cache(num_blocks, block_size, num_rows=0):
        shape = (2, num_blocks, block_size, 1, 2)
        return {"k": torch.zeros(shape), "v": torch.zeros(shape)}


class _JaxStubModel:
    @staticmethod
    def init_paged_cache(num_blocks, block_size, num_rows=0):
        shape = (2, num_blocks, block_size, 1, 2)
        return {"k": jnp.zeros(shape, jnp.float32),
                "v": jnp.zeros(shape, jnp.float32)}


def test_transport_matches_reference(cpu_comm):
    """The same numpy source pool and block lists through both
    transports: the destination pools bitwise equal, the same
    ValueErrors and the same stats."""
    rng = np.random.default_rng(5)
    src_np = {k: rng.standard_normal((2, 6, 4, 1, 2)).astype(np.float32)
              for k in ("k", "v")}
    geo = dict(num_blocks=6, block_size=4, num_slots=2, max_blocks_per_req=4)
    src, dst = PagedKVCache(_StubModel, **geo), PagedKVCache(_StubModel, **geo)
    for k, t in src.buffers.items():
        t.copy_(torch.from_numpy(src_np[k]))
    jcomm = jax_threadcomm_init(jax_make_mesh((1,), ("serve",)),
                                process_axes=(), thread_axes=("serve",))
    jcomm.start()
    try:
        jsrc = JaxPagedKVCache(_JaxStubModel, **geo)
        jdst = JaxPagedKVCache(_JaxStubModel, **geo)
        jsrc.swap_buffers({k: jnp.asarray(v) for k, v in src_np.items()})
        tp_ours, tp_ref = KVBlockTransport(cpu_comm), JaxTransport(jcomm)
        moves = ([4, 1], [0, 3]), ([5, 2, 0], [1, 2, 5])
        for sb, db in moves:
            cost = tp_ours.migrate(src, dst, sb, db)
            assert cost == tp_ref.migrate(jsrc, jdst, sb, db)
        for k, t in dst.buffers.items():
            assert np.array_equal(t.numpy(), np.asarray(jdst.buffers[k]))
        assert np.array_equal(dst.buffers["k"][:, 0].numpy(),
                              src_np["k"][:, 4])
        assert not dst.buffers["v"][:, 4].any()          # untouched
        assert tp_ours.stats() == tp_ref.stats()
        assert tp_ours.block_nbytes(src) == tp_ref.block_nbytes(jsrc) == 128
        other = dict(geo, block_size=2)
        for args, jargs in (
                ((src, dst, [0, 1], [2]), (jsrc, jdst, [0, 1], [2])),
                ((src, PagedKVCache(_StubModel, **other), [0], [0]),
                 (jsrc, JaxPagedKVCache(_JaxStubModel, **other), [0], [0]))):
            with pytest.raises(ValueError) as ref_err:
                tp_ref.migrate(*jargs)
            with pytest.raises(ValueError) as err:
                tp_ours.migrate(*args)
            assert str(err.value) == str(ref_err.value)
        assert tp_ours.stats() == tp_ref.stats()
        tp_ours.reset()
        assert tp_ours.stats()["n_migrations"] == 0.0
    finally:
        jcomm.finish()
        jcomm.free()


class _SlotStub:
    """A slot pool of two layers (k: (2, B, 8, 1, 4), pos: (B, 8)), all
    zeros as the reference's pool starts."""
    @staticmethod
    def init_cache(batch, cache_len):
        return {"k": torch.zeros((2, batch, cache_len, 1, 4)),
                "pos": torch.zeros((batch, cache_len), dtype=torch.int32)}


class _JaxSlotStub:
    @staticmethod
    def init_cache(batch, cache_len, dtype=None):
        return {"k": jnp.zeros((2, batch, cache_len, 1, 4), jnp.float32),
                "pos": jnp.zeros((batch, cache_len), jnp.int32)}


def _slot_pools_equal(ours, ref):
    """The port's layer-major pool against the reference's slot-major one
    (its leading slot axis over a batch-1 cache)."""
    k, jk = ours.buffers["k"].numpy(), np.asarray(ref.buffers["k"])
    pos, jpos = ours.buffers["pos"].numpy(), np.asarray(ref.buffers["pos"])
    return (np.array_equal(k, np.moveaxis(jk[:, :, 0], 0, 1))
            and np.array_equal(pos, jpos[:, 0]))


def test_slot_rows_insert_at_and_reset_slot_match_reference():
    """The handoff's slot-row API (``take_rows`` / ``insert_at``) on the
    same rows through both pools: the padding row clamps on the gather
    and writes nothing on the scatter, ``lengths`` sets only in-range
    slots, ``insert_at`` with a length into a free slot raises
    ``SlotError`` after its rows land, and ``reset_slot`` blanks a live
    slot and refuses a free one."""
    from repro.serve import LeaseLeakWarning as JaxLeaseLeakWarning
    from repro.serve import SlotError as JaxSlotError
    from repro.serve import SlotKVCache as JaxSlotKVCache
    from repro_torch.serve import LeaseLeakWarning, SlotError, SlotKVCache
    rng = np.random.default_rng(11)
    kv, jkv = SlotKVCache(_SlotStub, 8, 3), JaxSlotKVCache(_JaxSlotStub, 8, 3)
    a = kv.alloc("req-a")
    assert jkv.alloc("req-a") == a
    one_k = rng.standard_normal((2, 1, 8, 1, 4)).astype(np.float32)
    one_pos = np.arange(8, dtype=np.int32)[None]
    kv.insert(a, {"k": torch.from_numpy(one_k),
                  "pos": torch.from_numpy(one_pos)}, length=5)
    jkv.insert(a, {"k": jnp.asarray(one_k), "pos": jnp.asarray(one_pos)},
               length=5)
    assert _slot_pools_equal(kv, jkv)
    pad = [a, kv.num_slots]                          # second row = padding
    rows, jrows = kv.take_rows(pad), jkv.take_rows(pad)
    assert rows["k"].shape == (2, 2, 8, 1, 4)
    assert np.array_equal(rows["k"].numpy(),
                          np.moveaxis(np.asarray(jrows["k"])[:, :, 0], 0, 1))
    new_k = rng.standard_normal((2, 2, 8, 1, 4)).astype(np.float32)
    new_pos = np.full((2, 8), 3, np.int32)
    kv.insert_at(pad, {"k": torch.from_numpy(new_k),
                       "pos": torch.from_numpy(new_pos)}, lengths=[7, 99])
    jkv.insert_at(pad, {"k": jnp.asarray(np.moveaxis(new_k, 1, 0)[:, :, None]),
                        "pos": jnp.asarray(new_pos[:, None])},
                  lengths=[7, 99])
    assert _slot_pools_equal(kv, jkv)
    assert not kv.buffers["k"][:, (a + 1) % 3].any()   # padding dropped
    assert kv.length(a) == jkv.length(a) == 7
    kv.advance(a, 2)
    jkv.advance(a, 2)
    assert kv.length(a) == jkv.length(a) == 9
    free = (a + 1) % 3
    with pytest.raises(JaxSlotError) as ref_err:
        jkv.insert_at([free], jkv.take_rows([a]), lengths=[4])
    with pytest.raises(SlotError) as err:
        kv.insert_at([free], kv.take_rows([a]), lengths=[4])
    assert str(err.value) == str(ref_err.value)
    assert _slot_pools_equal(kv, jkv)                # the rows landed
    assert kv.length(free) == jkv.length(free) == 0
    kv.reset_slot(a)
    jkv.reset_slot(a)
    assert _slot_pools_equal(kv, jkv)
    assert (kv.buffers["pos"][a] == -1).all() and kv.length(a) == 0
    with pytest.raises(JaxSlotError):
        jkv.reset_slot(free)
    with pytest.raises(SlotError):
        kv.reset_slot(free)
    with pytest.warns(JaxLeaseLeakWarning, match="req-a"):
        jkv.reset()
    with pytest.warns(LeaseLeakWarning, match="req-a"):
        kv.reset()
    assert kv.num_free == jkv.num_free == 3 and kv.live_slots == []


def test_kv_migration_latency_matches_reference():
    for nbytes, bb in ((8192, 8192), (4 * 8192, 8192), (8192 + 100, 8192),
                       (0, 64), (294_912 * 16, 294_912), (700, 64)):
        assert protocol.kv_migration_latency(nbytes, bb) == \
            jax_protocol.kv_migration_latency(nbytes, bb)
    with pytest.raises(ValueError):
        protocol.kv_migration_latency(8192, 0)


# ---------------------------------------------------------------------------
# counters under threads, shard_trace, the launcher
# ---------------------------------------------------------------------------

def test_paged_counters_exact_under_threads():
    """Two threads bump the paged-attention counters 10,000 times each
    (the switch interval cut so that a bare ``+=`` would interleave):
    no count is lost."""
    ops.reset_counters()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def bump():
        for _ in range(10_000):
            ops.count("mq_launches", 4)
            ops.count("ref_calls")

    try:
        threads = [threading.Thread(target=bump) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert ops.counters() == {"decode_launches": 0, "mq_launches": 20_000,
                              "ref_calls": 20_000}
    assert ops.mq_launches_by_k == {4: 20_000}
    ops.reset_counters()


def test_shard_trace_matches_reference():
    from repro.serve.scheduler import make_trace as jax_make_trace
    from repro.serve.scheduler import shard_trace as jax_shard_trace
    trace = port_make_trace(11, prompt_len=(16, 256), max_new=4, seed=3)
    jtrace = jax_make_trace(11, prompt_len=(16, 256), max_new=4, seed=3)
    for seed in (None, 9):
        shards = [shard_trace(trace, r, 3, seed) for r in range(3)]
        jshards = [jax_shard_trace(jtrace, r, 3, seed) for r in range(3)]
        assert [[trace.index(e) for e in s] for s in shards] == \
            [[jtrace.index(e) for e in s] for s in jshards]
        assert sorted(trace.index(e) for s in shards for e in s) == \
            list(range(11))
    with pytest.raises(ValueError):
        shard_trace(trace, 3, 3)


#: run_fabric's keys beyond the reference's
PORT_KEYS = {"backend", "layers", "device", "torch_version", "cuda_version",
             "dtype", "kernels", "fabric_equal_token_share_replicated",
             "fabric_equal_token_share_disagg"}


def test_run_fabric_keys_match_reference():
    """The launcher's fabric comparison on the CPU gives the reference
    launcher's keys (plus the port's own), token identity on both
    placements, and the same per-placement keys."""
    from repro.launch.serve import run_fabric as jax_run_fabric
    from repro_torch.launch.serve import run_fabric
    kw = dict(smoke=True, requests=4, ranks=2, slots=2, prompt_len=(16, 24),
              max_new=(2, 4), rate=400.0, prefill_chunk=16, block_size=8)
    ref = jax_run_fabric(**kw)
    ours = run_fabric(device="cpu", **kw)
    assert set(ours) == set(ref) | PORT_KEYS
    for p in ("replicated", "disagg"):
        assert ours[f"fabric_token_identical_{p}"] is True
        assert ours[f"fabric_speculate_k_{p}"] == 0
        assert set(ref[f"fabric_{p}"]) - {"metrics"} <= set(
            ours[f"fabric_{p}"])
    assert ours["fabric_disagg"]["n_migrations"] == 4.0
    assert ours["kernels"]["decode_launches"] == 0
    assert ours["fabric_disagg"]["kernels"]["ref_calls"] > 0
