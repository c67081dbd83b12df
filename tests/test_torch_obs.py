"""The port's telemetry (``repro_torch.obs``), case for case with the
reference's ``tests/test_obs.py``: span nesting and parents, rank
attribution under pool threads, ring overflow, Chrome ``trace_event``
export, hop and residual coupling, the stall detector gated on the
runnable hint, ``merge_reports``, the metrics registry, the trial flush
on engine reset and the inert-when-disabled guard; plus parity with the
reference's ledger and tracer (the same calls give the same report
dicts and the same Chrome events), and the comm's wait and stream
hooks; and what the port's tracer adds: ``record_function`` ranges
while a ``torch.profiler`` run is active, device time from CUDA event
pairs (fake events on the CPU), ``step`` taken from the enclosing
span. Pure host code, a few seconds.

Fixtures force each package's tracer on or off, so ``REPRO_TRACE=1`` in
the environment (which installs both at import) cannot leak between
tests.
"""

import json
import os
import subprocess
import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.obs import metrics as JM
from repro.obs import residuals as JR
from repro.obs import trace as JT
from repro_torch import obs
from repro_torch.config import ServeConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core import compat, threadcomm_init
from repro_torch.models.registry import build_model
from repro_torch.obs import metrics as M
from repro_torch.obs import residuals as R
from repro_torch.obs import trace as T
from repro_torch.serve import ContinuousEngine

ROOT = Path(__file__).resolve().parents[1]


def _all_off():
    for mod in (T, M, JT, JM):
        mod.uninstall()


@pytest.fixture
def tracer():
    _all_off()
    tr = T.install(capacity=4096)
    M.install()
    yield tr
    _all_off()


@pytest.fixture
def off():
    """Force the disabled state on both packages (REPRO_TRACE=1 in the
    environment installs at import)."""
    _all_off()
    yield


@pytest.fixture(scope="module")
def engine_bundle():
    cfg = get_smoke_config("gemma-2b")
    model = build_model(cfg, ServeConfig(param_dtype="float32",
                                         compute_dtype="float32"),
                        device="cpu")
    return model, model.init(0)


# ---------------------------------------------------------------------------
# span nesting and rank attribution
# ---------------------------------------------------------------------------

def test_span_nesting_parent_recorded(tracer):
    with tracer.span("outer", cat="test"):
        with tracer.span("inner", cat="test", k=1):
            pass
    by_name = {e["name"]: e for e in tracer.events()}
    assert by_name["inner"]["args"]["parent"] == "outer"
    assert "parent" not in by_name["outer"]["args"]
    assert by_name["inner"]["ph"] == "X"
    assert by_name["inner"]["dur"] >= 0.0
    assert tracer.unbalanced == 0


def test_complete_inherits_open_parent(tracer):
    with tracer.span("outer"):
        t0 = time.perf_counter()
        tracer.complete("hot", t0, time.perf_counter())
    ev = [e for e in tracer.events() if e["name"] == "hot"][0]
    assert ev["args"]["parent"] == "outer"


def test_manual_end_is_idempotent(tracer):
    sp = tracer.span("once")
    sp.end()
    sp.end()
    assert len([e for e in tracer.events() if e["name"] == "once"]) == 1
    assert tracer.unbalanced == 0


def test_out_of_order_end_counted_unbalanced(tracer):
    a = tracer.span("a")
    b = tracer.span("b")
    a.end()              # LIFO violation: b is still open
    b.end()
    assert tracer.unbalanced == 1
    assert len(tracer.events()) == 2


def test_rank_attribution_under_pool_threads(tracer):
    """A ThreadPoolExecutor reassigns threads to ranks arbitrarily:
    rank_scope pins every event to its rank, and the thread-local stacks
    never cross."""
    def one_step(rank, step):
        with tracer.rank_scope(rank):
            with tracer.span(f"step:{rank}", step=step):
                with tracer.span(f"sub:{rank}"):
                    time.sleep(0.0005)

    with ThreadPoolExecutor(max_workers=3,
                            thread_name_prefix="fabric-rank") as ex:
        futs = [ex.submit(one_step, rank, step)
                for step in range(8) for rank in range(4)]
        for f in futs:
            f.result(timeout=60)
    assert tracer.unbalanced == 0
    for ev in tracer.events():
        kind, _, rank = ev["name"].partition(":")
        assert ev["tid"] == int(rank)        # lane == rank, not thread
        if kind == "sub":
            assert ev["args"]["parent"] == f"step:{rank}"
    assert len(tracer.events()) == 64        # 4 ranks x 8 steps x 2 spans


def test_driver_lane_outside_rank_scope(tracer):
    tracer.instant("driver_event")
    ev = tracer.events()[0]
    assert ev["tid"] >= T.DRIVER_TID
    lanes = tracer.chrome_trace()["traceEvents"]
    names = {m["tid"]: m["args"]["name"] for m in lanes
             if m.get("ph") == "M" and m["name"] == "thread_name"}
    assert ev["tid"] in names


# ---------------------------------------------------------------------------
# ring buffer
# ---------------------------------------------------------------------------

def test_ring_overflow_drops_oldest_first():
    tr = T.Tracer(capacity=8)
    for i in range(12):
        tr.instant(f"ev{i}")
    assert [e["name"] for e in tr.events()] == [f"ev{i}"
                                                for i in range(4, 12)]
    assert tr.dropped == 4
    assert tr.chrome_trace()["metadata"]["dropped_events"] == 4


def test_ring_capacity_validated():
    with pytest.raises(ValueError):
        T.Tracer(capacity=0)


# ---------------------------------------------------------------------------
# Chrome trace_event export
# ---------------------------------------------------------------------------

def test_chrome_trace_valid_json(tracer, tmp_path):
    with tracer.rank_scope(1):
        with tracer.span("rank_step", cat="fabric"):
            t0 = time.perf_counter()
            tracer.complete("decode", t0, time.perf_counter(), rows=2)
        tracer.counter("block_pool", free=3, live=5)
    tracer.instant("admit", cat="sched", rid=0)
    path = tmp_path / "trace.json"
    tracer.write_chrome(str(path))
    doc = json.loads(path.read_text())
    assert doc["displayTimeUnit"] == "ms"
    evs = doc["traceEvents"]
    assert {"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
            "args": {"name": "repro-serve"}} in evs
    assert any(m.get("ph") == "M" and m["name"] == "thread_name"
               and m["tid"] == 1 and m["args"]["name"] == "rank 1"
               for m in evs)
    data = [e for e in evs if e.get("ph") != "M"]
    assert [e["ts"] for e in data] == sorted(e["ts"] for e in data)
    for e in data:
        assert {"name", "ph", "ts", "pid", "tid"} <= set(e)
        if e["ph"] == "X":
            assert e["dur"] >= 0.0


def test_hop_emits_span_and_residual(tracer):
    t0 = time.perf_counter()
    time.sleep(0.001)
    with tracer.rank_scope(2):
        tracer.hop("migration", 0.5e-3, t0, time.perf_counter(), rid=7)
    ev = [e for e in tracer.events() if e["name"] == "hop:migration"][0]
    assert ev["cat"] == "residual"
    assert ev["args"]["modeled_s"] == pytest.approx(0.5e-3)
    assert ev["args"]["measured_s"] > 0.0
    assert ev["args"]["residual_ratio"] == pytest.approx(
        ev["args"]["measured_s"] / 0.5e-3)
    assert ev["tid"] == 2
    assert tracer.residuals.report()["hops"]["migration"]["n"] == 1


# ---------------------------------------------------------------------------
# residual ledger + serialization-stall detector
# ---------------------------------------------------------------------------

def test_residual_report_flags_over_factor():
    led = R.ResidualLedger()
    led.record("admission", 1e-3, 1.1e-3)         # on-model
    led.record("migration", 1e-3, 5e-3, rank=1)   # 5x over
    rep = led.report(factor=2.0)
    assert rep["hops"]["admission"]["ratio"] == pytest.approx(1.1)
    assert rep["hops"]["migration"]["ratio"] == pytest.approx(5.0)
    assert rep["flagged"] == ["migration"]
    assert rep["hops"]["migration"]["n_off"] == 1
    assert rep["hops"]["migration"]["worst_over"] == pytest.approx(5.0)


def test_residual_unmodeled_hop_is_inf():
    led = R.ResidualLedger()
    led.record("router_dispatch", 0.0, 1e-4)
    rep = led.report()
    assert rep["hops"]["router_dispatch"]["ratio"] == float("inf")
    assert "router_dispatch" in rep["flagged"]


def test_residual_under_factor_flagged_too():
    led = R.ResidualLedger()
    led.record("spec_verify", 1e-2, 1e-3)         # 10x under
    assert led.report()["flagged"] == ["spec_verify"]


def test_stall_detector_gated_on_runnable(tracer):
    t0 = time.perf_counter()
    t1 = t0 + 2e-3
    tracer.on_wait("allreduce", t0, t1)           # no runnable hint: idle
    assert tracer.residuals.report()["serialization_stall_s"] == 0.0
    tracer.set_runnable(3)
    tracer.on_wait("allreduce", t0, t1)           # blocked while runnable
    rep = tracer.residuals.report()
    assert rep["serialization_stall_s"] == pytest.approx(2e-3)
    assert rep["stall_events"] == 1
    waits = [e for e in tracer.events() if e["name"] == "wait:allreduce"]
    assert len(waits) == 2 and waits[1]["args"]["runnable"] == 3


def test_merge_reports_recombines_sums():
    a, b = R.ResidualLedger(), R.ResidualLedger()
    a.record("admission", 1e-3, 2e-3)
    a.stall(1e-3, rank=0)
    b.record("admission", 1e-3, 4e-3)
    b.record("migration", 2e-3, 2e-3, rank=1)
    b.stall(2e-3, rank=0)
    merged = R.merge_reports([a.report(), b.report(), {}])
    assert merged["hops"]["admission"]["n"] == 2
    assert merged["hops"]["admission"]["ratio"] == pytest.approx(3.0)
    assert merged["hops"]["migration"]["ratio"] == pytest.approx(1.0)
    assert merged["flagged"] == ["admission"]
    assert merged["serialization_stall_s"] == pytest.approx(3e-3)
    assert merged["stall_by_rank"]["0"] == pytest.approx(3e-3)


# ---------------------------------------------------------------------------
# parity with the reference's ledger and tracer
# ---------------------------------------------------------------------------

KINDS = ("admission", "prefix_hit", "migration", "spec_verify",
         "router_dispatch", "custom")


def _ledger_calls(seed, n=40):
    """A seeded sequence of ledger calls: records (some unmodeled, some
    off by more than the factor, some on ranks) and stalls."""
    rng = np.random.default_rng(seed)
    calls = []
    for _ in range(n):
        rank = None if rng.random() < 0.3 else int(rng.integers(4))
        if rng.random() < 0.25:
            calls.append(("stall", float(rng.exponential(1e-3)), rank))
        else:
            modeled = 0.0 if rng.random() < 0.1 else float(
                rng.exponential(1e-4))
            calls.append(("record", KINDS[rng.integers(len(KINDS))],
                          modeled, float(rng.exponential(3e-4)), rank))
    return calls


def _replay_ledger(cls, calls):
    led = cls()
    for c in calls:
        if c[0] == "stall":
            led.stall(c[1], rank=c[2])
        else:
            led.record(c[1], c[2], c[3], rank=c[4])
    return led


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("factor", [2.0, 1.5])
def test_ledger_reports_equal_reference(seed, factor):
    calls = _ledger_calls(seed)
    ours = _replay_ledger(R.ResidualLedger, calls)
    theirs = _replay_ledger(JR.ResidualLedger, calls)
    assert ours.counts() == theirs.counts()
    assert ours.report(factor) == theirs.report(factor)
    parts = [_ledger_calls(seed * 10 + i, n=15) for i in range(3)]
    mine = [_replay_ledger(R.ResidualLedger, p).report() for p in parts]
    ref = [_replay_ledger(JR.ResidualLedger, p).report() for p in parts]
    assert mine == ref
    assert R.merge_reports(mine + [{}], factor) == JR.merge_reports(
        ref + [{}], factor)
    ours.reset()
    assert ours.report() == JR.ResidualLedger().report()


def _tracer_script(tr):
    """The same tracer calls on either package's tracer."""
    t0 = time.perf_counter()
    with tr.span("outer", cat="engine", rows=2):
        tr.complete("decode", t0, time.perf_counter(), cat="engine", rows=2)
        tr.instant("admit", cat="sched", rid=3, protocol="eager")
    tr.counter("block_pool", free=5, live=3)
    tr.hop("admission", 2e-6, t0, time.perf_counter(), rid=3)
    tr.hop("router_dispatch", 0.0, t0, time.perf_counter())
    tr.set_runnable(2)
    tr.on_wait("allreduce", t0, time.perf_counter())
    with tr.rank_scope(1):
        with tr.span("rank_step"):
            tr.instant("defer", cat="sched", rid=4, reason="blocks")
    sp = tr.span("manual")
    sp.end()


def test_tracer_events_equal_reference(off):
    ours, theirs = T.Tracer(capacity=64), JT.Tracer(capacity=64)
    _tracer_script(ours)
    _tracer_script(theirs)

    def shape(tr):
        doc = tr.chrome_trace()
        evs = [(e["name"], e.get("cat"), e["ph"], e["tid"],
                sorted(e.get("args", {})), e.get("s"))
               for e in doc["traceEvents"] if e["ph"] != "M"]
        meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
        return sorted(evs), meta, doc["metadata"], doc["displayTimeUnit"]

    assert shape(ours) == shape(theirs)
    pick = [[(e["name"], {k: v for k, v in e["args"].items()
                          if not k.endswith("_s") and k != "residual_ratio"})
             for e in tr.events()] for tr in (ours, theirs)]
    assert pick[0] == pick[1]
    assert ours.residuals.counts() == theirs.residuals.counts()
    assert ours.unbalanced == theirs.unbalanced == 0


# ---------------------------------------------------------------------------
# the profiler's ranges, device time, the step
# ---------------------------------------------------------------------------

def _profiled_host_events(prof):
    return {e.name(): e for e in prof.profiler.kineto_results.events()
            if e.name() in ("outer", "inner")}


def test_spans_mirror_into_a_running_profiler(tracer):
    """Under ``torch.profiler`` every span is a host event of its name,
    nested as the spans are, each inside its span's own times."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        w0 = time.time_ns()
        with tracer.span("outer", cat="engine"):
            with tracer.span("inner", cat="phase"):
                torch.ones(64).add_(1)
        w1 = time.time_ns()
    host = _profiled_host_events(prof)
    assert set(host) == {"outer", "inner"}
    spans = {e["name"]: e for e in tracer.events()}
    for name, e in host.items():
        assert w0 <= e.start_ns() and e.start_ns() + e.duration_ns() <= w1
        assert e.duration_ns() * 1e-3 <= spans[name]["dur"]
    o, i = host["outer"], host["inner"]
    assert o.start_ns() <= i.start_ns()
    assert i.start_ns() + i.duration_ns() <= o.start_ns() + o.duration_ns()


def test_no_profiler_range_without_a_profiler(tracer, monkeypatch):
    def refuse(name):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with tracer.span("outer"):
        with tracer.span("inner", device=True):
            pass
    assert [e["name"] for e in tracer.events()] == ["inner", "outer"]


@pytest.mark.parametrize("device", [None, torch.device("cpu")])
def test_device_span_on_the_cpu_has_no_device_time(tracer, monkeypatch,
                                                   device):
    def refuse(*a, **kw):
        raise AssertionError("a CUDA event on the CPU")
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    with tracer.span("decode", cat="engine", device=device, rows=2):
        pass
    (ev,) = tracer.events()
    assert ev["args"] == {"rows": 2}


class _FakeEvent:
    """A CUDA event's host side: ``record`` stamps a device clock the
    test advances; ``query`` says whether the device got that far."""

    clock = [0.0]
    done_up_to = [float("inf")]
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.at = None

    def record(self, stream=None):
        self.at = self.clock[0]

    def query(self):
        return self.at <= self.done_up_to[0]

    def synchronize(self):
        self.done_up_to[0] = max(self.done_up_to[0], self.at)

    def elapsed_time(self, end):
        return end.at - self.at


@pytest.fixture
def fake_card(monkeypatch):
    _FakeEvent.clock[0], _FakeEvent.done_up_to[0] = 0.0, float("inf")
    _FakeEvent.made = 0
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: "stream")
    return _FakeEvent


def test_device_time_from_event_pairs(tracer, fake_card):
    """A device-timed span carries its event pair's time as
    ``device_ms``: read at once where ``query`` finds the end done (the
    events then serve the next span), else when the events are taken."""
    card = torch.device("cuda")
    with tracer.span("prefill_chunk", cat="engine", device=card):
        fake_card.clock[0] += 2.5
    assert tracer._pending == deque() and fake_card.made == 2
    fake_card.done_up_to[0] = 2.5          # the device is behind
    with tracer.span("decode", cat="engine", device=card):
        fake_card.clock[0] += 4.0
    assert len(tracer._pending) == 1 and fake_card.made == 2
    with tracer.span("decode", cat="engine", device=card):
        fake_card.clock[0] += 1.0
    assert len(tracer._pending) == 2 and fake_card.made == 4
    evs = tracer.events()
    assert not tracer._pending
    assert [e["args"]["device_ms"] for e in evs] == [2.5, 4.0, 1.0]
    assert len(tracer._free_events) == 4
    doc = tracer.chrome_trace()
    assert [e["args"]["device_ms"] for e in doc["traceEvents"]
            if e["ph"] == "X"] == [2.5, 4.0, 1.0]


def test_children_take_the_enclosing_step(tracer):
    with tracer.span("prefill_chunk", cat="engine", step=7):
        with tracer.span("prefill_chunk.forward", cat="phase"):
            with tracer.span("moe", cat="block", layer=0):
                pass
        with tracer.span("other", step=8):
            pass
    with tracer.span("outside"):
        pass
    got = {e["name"]: e["args"].get("step") for e in tracer.events()}
    assert got == {"moe": 7, "prefill_chunk.forward": 7, "other": 8,
                   "prefill_chunk": 7, "outside": None}


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

def test_registry_counter_gauge_histogram(tracer):
    reg = M.active()
    reg.counter("sched.admitted").inc(3)
    reg.counter("sched.admitted").inc()
    reg.gauge("sched.queue_depth").set(7)
    for v in (1.0, 2.0, 3.0, 4.0):
        reg.histogram("latency_s").observe(v)
    snap = reg.snapshot()
    assert snap["counters"]["sched.admitted"] == 4.0
    assert snap["gauges"]["sched.queue_depth"] == 7.0
    h = snap["histograms"]["latency_s"]
    assert h["count"] == 4.0 and h["mean"] == pytest.approx(2.5)
    assert h["min"] == 1.0 and h["max"] == 4.0
    reg.reset()
    assert reg.snapshot() == {"counters": {}, "gauges": {},
                              "histograms": {}}


def test_registry_snapshot_equals_reference():
    ours, theirs = M.MetricsRegistry(), JM.MetricsRegistry()
    rng = np.random.default_rng(0)
    vals = rng.exponential(1.0, size=5000)    # past the reservoir's cap
    for reg in (ours, theirs):
        reg.counter("tokens_out").inc(12)
        reg.gauge("block_pool.free_blocks").set(9)
        reg.histogram("empty")
        for v in vals:
            reg.histogram("ttft_s").observe(v)
    assert ours.snapshot() == theirs.snapshot()


def test_snapshot_merges_registry_and_extra(tracer):
    M.active().counter("tokens_out").inc(5)
    out = M.snapshot(extra={"tok_s": 12.0})
    assert out["tok_s"] == 12.0
    assert out["metrics"]["counters"]["tokens_out"] == 5.0


def test_engine_stats_are_the_collectors(off, engine_bundle):
    """The engine's kv_accounting / prefix_stats / spec_stats are aliases
    of the collectors, and ``snapshot(engine=)`` merges them with the
    scheduler's latency stats (no registry when telemetry is off)."""
    model, params = engine_bundle
    eng = ContinuousEngine(model, params, cache_len=32, num_slots=2,
                           prefill_chunk=16, kv_layout="paged",
                           block_size=8, prefix_cache=True, device="cpu")
    out = eng.generate({"tokens": np.arange(20, dtype=np.int32).reshape(
        2, 10)}, 3)
    assert out.shape == (2, 3)
    assert eng.kv_accounting() == M.engine_kv_accounting(eng)
    assert eng.prefix_stats() == M.engine_prefix_stats(eng)
    assert eng.spec_stats() == M.engine_spec_stats(eng) == {}
    snap = M.snapshot(engine=eng)
    assert "metrics" not in snap and snap["n"] == 2.0
    assert snap["kv_bytes_total"] == float(sum(
        t.nbytes for t in eng.kv.buffers.values()))
    assert snap["prefix_lookups"] == 2.0


# ---------------------------------------------------------------------------
# trial-flush wiring
# ---------------------------------------------------------------------------

def test_engine_reset_flushes_trial(tracer, engine_bundle):
    model, params = engine_bundle
    eng = ContinuousEngine(model, params, cache_len=32, num_slots=2,
                           prefill_chunk=16, kv_layout="paged",
                           block_size=8, device="cpu")
    tracer.residuals.record("admission", 1e-3, 5e-3)   # warm-up pollution
    M.active().counter("tokens_out").inc(9)
    eng.reset()
    assert tracer.residuals.counts() == {}
    assert M.active().snapshot()["counters"] == {}


def test_engine_reset_preserve_prefix_flushes_too(tracer, engine_bundle):
    model, params = engine_bundle
    eng = ContinuousEngine(model, params, cache_len=32, num_slots=2,
                           prefill_chunk=16, kv_layout="paged",
                           block_size=8, prefix_cache=True, device="cpu")
    tracer.residuals.record("prefix_hit", 1e-3, 1e-3)
    eng.reset(preserve_prefix=True)
    assert tracer.residuals.counts() == {}


def test_package_install_flush_uninstall(off):
    tr = obs.install(capacity=32)
    try:
        assert T.active() is tr and M.active() is not None
        tr.residuals.record("admission", 1e-6, 1e-5)
        M.active().counter("x").inc()
        tr.instant("kept")
        obs.flush_trial()
        assert tr.residuals.counts() == {}
        assert M.active().snapshot()["counters"] == {}
        assert tr.n_events == 1           # the ring survives a flush
    finally:
        obs.uninstall()
    assert T.active() is None and M.active() is None
    obs.flush_trial()                     # off: a no-op


# ---------------------------------------------------------------------------
# the comm's hooks
# ---------------------------------------------------------------------------

def test_comm_wait_and_stream_spans(tracer):
    """``Request.wait`` emits ``wait:<op>`` (charged to the stall
    detector while runnable work is set) and a stream region is a
    ``stream:<name>`` span, the waits inside it its children."""
    tc = threadcomm_init(compat.make_mesh((2,), ("ranks",), device="cpu"))
    x = torch.arange(8, dtype=torch.float32).reshape(2, 4)
    with tc.start():
        def body(v):
            with tc.stream("grad"):
                return tc.iallreduce(v).wait()
        y = tc.run(body, x)
        tracer.set_runnable(2)
        tc.run(lambda v: tc.ibarrier(v).wait(), x)
    assert torch.equal(y, x.sum(0, keepdim=True).expand(2, 4))
    evs = {e["name"]: e for e in tracer.events()}
    assert evs["stream:grad"]["cat"] == "comm"
    assert evs["wait:allreduce"]["args"]["parent"] == "stream:grad"
    assert evs["wait:allreduce"]["args"]["runnable"] == 0
    assert evs["wait:barrier"]["args"]["runnable"] == 2
    assert tracer.residuals.report()["stall_events"] == 1


# ---------------------------------------------------------------------------
# inert when disabled
# ---------------------------------------------------------------------------

def test_disabled_hooks_inert(off):
    assert T.active() is None
    assert M.active() is None
    T.flush_trial()                     # no-ops, no error
    M.flush_trial()


def test_disabled_guard_is_one_global_read(off):
    """The instrumented-site pattern when telemetry is off: one module-
    global read plus a None check; bounded generously: nothing allocates
    or reads the clock on the disabled path."""
    n = 200_000
    t0 = time.perf_counter()
    for _ in range(n):
        tr = T.active()
        if tr is not None:              # pragma: no cover
            tr.instant("never")
    dt = time.perf_counter() - t0
    assert dt / n < 5e-6


@pytest.mark.parametrize("speculate", [0, 2])
def test_disabled_engine_reads_no_clock(off, engine_bundle, monkeypatch,
                                        speculate):
    """With telemetry off the engine's sites never read the clock, make
    no CUDA event and enter no profiler range (each is a global read and
    a None check)."""
    import types

    from repro_torch.serve import engine as engine_mod

    def clock():
        raise AssertionError("the clock was read with telemetry off")

    def refuse(*a, **kw):
        raise AssertionError("a CUDA event or profiler range with "
                             "telemetry off")
    monkeypatch.setattr(engine_mod, "time",
                        types.SimpleNamespace(perf_counter=clock))
    monkeypatch.setattr(T, "time", types.SimpleNamespace(perf_counter=clock))
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    model, params = engine_bundle
    eng = ContinuousEngine(model, params, cache_len=32, num_slots=2,
                           prefill_chunk=16, kv_layout="paged",
                           block_size=8, speculate=speculate, device="cpu")
    out = eng.generate({"tokens": np.ones((2, 9), np.int32)}, 4)
    assert out.shape == (2, 4)


def test_install_is_fresh_each_time():
    tr1 = T.install(capacity=16)
    tr1.instant("stale")
    tr2 = T.install(capacity=16)
    try:
        assert T.active() is tr2
        assert tr2.n_events == 0
    finally:
        T.uninstall()


def test_repro_trace_environment_switch():
    """``REPRO_TRACE`` (and ``REPRO_TRACE_CAPACITY``) install the tracer
    and the registry at import, as the reference's do."""
    code = ("from repro_torch.obs import metrics, trace\n"
            "tr = trace.active()\n"
            "print(tr is not None and tr.capacity,"
            " metrics.active() is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_TRACE="on",
               REPRO_TRACE_CAPACITY="123")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["123", "True"]
    env["REPRO_TRACE"] = "0"
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.stdout.split() == ["False", "False"]
