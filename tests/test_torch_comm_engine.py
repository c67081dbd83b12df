"""The port's engine bound to a communicator, its burst and sampled
traces, and its telemetry, against the reference on the CPU (gemma-2b
smoke, float32, the reference's parameters moved over).

- A comm-bound port engine against the reference's comm-bound engine,
  step by step (``torch_parity.check_engine``): admissions, finishes,
  block tables and greedy tokens, on the paged and slot layouts and with
  ``speculate=2``; and against the port's unbound engine, pool included,
  bit for bit.
- ``make_trace`` with burst arrivals and a sampling temperature gives the
  reference's entries; a sampled trace gives the reference's admissions
  and tables (``eos_id=-1``).
- With both packages' tracers installed, one trace through both engines
  gives the same spans, instants and counters in order, the same
  residual counts and registry values, and ``reset`` flushes both. The
  port's own categories (``phase``: an engine step's pack / forward /
  sample; ``block``: the MoE block) are held apart from that comparison
  and checked on their own: present, nested in their step, well-formed.
- The launcher's CLI under ``REPRO_TRACE=1`` writes a Chrome trace and a
  payload with the residual keys.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.core import threadcomm_init as jax_threadcomm_init
from repro.core.compat import make_mesh as jax_make_mesh
from repro.obs import metrics as JM
from repro.obs import trace as JT
from repro.serve import ContinuousEngine as JaxEngine
from repro.serve import ServeRequest as JaxRequest
from repro.serve.scheduler import make_trace as jax_make_trace
from repro_torch.core import compat, threadcomm_init
from repro_torch.core.comm import CommStream
from repro_torch.obs import metrics as M
from repro_torch.obs import trace as T
from repro_torch.serve import (ContinuousEngine, ServeRequest, SlotError,
                               make_trace)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def bundle():
    return tp.bundle("gemma-2b")


@pytest.fixture(scope="module")
def moe_bundle():
    return tp.bundle("olmoe-1b-7b")


@pytest.fixture(scope="module")
def comms():
    """(the port's, the reference's) one-rank threadcomm, started."""
    ours = threadcomm_init(compat.make_mesh((1,), ("ranks",), device="cpu"),
                           process_axes=(), thread_axes=("ranks",))
    theirs = jax_threadcomm_init(jax_make_mesh((1,), ("ranks",)),
                                 process_axes=(), thread_axes=("ranks",))
    ours.start()
    theirs.start()
    yield ours, theirs
    for c in (ours, theirs):
        c.finish()
        c.free()


@pytest.fixture
def off():
    """Both packages' telemetry off, whatever REPRO_TRACE says."""
    for mod in (T, M, JT, JM):
        mod.uninstall()
    yield


@pytest.fixture
def traced():
    """Both packages' tracer and registry freshly installed."""
    tracers = (T.install(capacity=8192), JT.install(capacity=8192))
    M.install()
    JM.install()
    yield tracers
    for mod in (T, M, JT, JM):
        mod.uninstall()


# ---------------------------------------------------------------------------
# (i) the comm binding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout, extra", [
    ("paged", {}), ("slot", {}), ("slot-monolithic", {}),
    ("paged", {"speculate": 2})])
def test_bound_engine_matches_reference(bundle, comms, off, layout, extra):
    eng = tp.check_engine(bundle, layout, comm=comms, **extra)
    for name in ("prefill", "decode", "draft", "verify"):
        stream = getattr(eng, f"_{name}_stream")
        assert isinstance(stream, CommStream) and stream.name == name


def _replay(eng, model, trace, seed=100):
    reqs = tp.requests(ServeRequest, model.cfg, trace, seed=seed)
    return tp.drive(eng, reqs), [r.output[:r.generated] for r in reqs]


@pytest.mark.parametrize("extra", [{}, {"speculate": 2}])
def test_bound_engine_equals_unbound_bitwise(bundle, comms, off, extra):
    """Binding orders values only: the port's bound and unbound engines
    give the same log, tokens and final pools, bit for bit."""
    model, params = bundle[2], bundle[3]
    trace = make_trace(6, prompt_len=(5, 19), max_new=(2, 7), rate=400.0,
                       seed=3)
    kw = dict(tp.ENGINE_KW, kv_layout="paged", device="cpu", **extra)
    runs = []
    for comm in (comms[0], None):
        eng = ContinuousEngine(model, params, comm=comm, **kw)
        runs.append((eng,) + _replay(eng, model, trace))
    (a, log_a, out_a), (b, log_b, out_b) = runs
    tp.same_log(log_a, log_b)
    assert all(np.array_equal(x, y) for x, y in zip(out_a, out_b))
    pools = [(a.kv, b.kv)] + ([(a.draft_kv, b.draft_kv)] if extra else [])
    for pa, pb in pools:
        for k, t in pa.buffers.items():
            assert torch.equal(t, pb.buffers[k]), k


def test_swap_buffers_takes_the_pool_itself(bundle, off):
    model, params = bundle[2], bundle[3]
    for layout in ("paged", "slot"):
        eng = ContinuousEngine(model, params, device="cpu",
                               **dict(tp.ENGINE_KW, kv_layout=layout))
        buf = eng.kv.buffers
        eng.kv.swap_buffers(buf)
        eng.kv.swap_buffers(dict(buf))        # the same tensors
        with pytest.raises(SlotError, match="pool's own tensors"):
            eng.kv.swap_buffers({k: v.clone() for k, v in buf.items()})
        assert eng.kv.buffers is buf


def test_accessors_match_reference(bundle, off):
    """``num_active`` / ``num_prefilling`` and the scheduler's
    ``queue_depths`` / ``latency_stats`` after every step, as the
    reference's."""
    jmodel, jparams, model, params = bundle
    trace = make_trace(5, prompt_len=(5, 19), max_new=(2, 6),
                       arrival="burst", burst=3, rate=400.0, seed=2)
    kw = dict(tp.ENGINE_KW, kv_layout="paged")
    sides = []
    for eng, cls in ((ContinuousEngine(model, params, device="cpu", **kw),
                      ServeRequest),
                     (JaxEngine(jmodel, jparams, **kw), JaxRequest)):
        reqs = tp.requests(cls, model.cfg, trace)
        seen, i, step = [], 0, 0
        while i < len(reqs) or not eng.idle:
            while i < len(reqs) and reqs[i].arrival * 2000.0 <= step:
                eng.submit(reqs[i], float(step))
                i += 1
            eng.step(float(step))
            step += 1
            seen.append((eng.num_active, eng.num_prefilling,
                         eng.num_decoding, eng.scheduler.queue_depths()))
        sides.append((seen, eng.scheduler.latency_stats()))
    assert sides[0][0] == sides[1][0]
    assert sides[0][1] == pytest.approx(sides[1][1])


# ---------------------------------------------------------------------------
# (ii) burst and sampled traces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 5])
@pytest.mark.parametrize("kw", [
    dict(arrival="burst", burst=3),
    dict(arrival="burst", burst=4, temperature=0.8),
    dict(arrival="poisson", temperature=0.5, shared_prefix_len=6,
         share_ratio=0.7, prefix_groups=2),
    dict(arrival="all", temperature=1.0, max_new=9)])
def test_make_trace_matches_reference(seed, kw):
    kw = {"max_new": (2, 11), **kw}
    ours = make_trace(7, prompt_len=(5, 19, 8), rate=300.0, seed=seed, **kw)
    theirs = jax_make_trace(7, prompt_len=(5, 19, 8), rate=300.0, seed=seed,
                            **kw)
    assert [dataclasses.astuple(e) for e in ours] == [
        dataclasses.astuple(e) for e in theirs]
    assert ([f.name for f in dataclasses.fields(ours[0])]
            == [f.name for f in dataclasses.fields(theirs[0])])


def test_make_trace_unknown_arrival_raises():
    with pytest.raises(ValueError, match="unknown arrival kind"):
        make_trace(2, prompt_len=4, max_new=2, arrival="gamma")


@pytest.mark.parametrize("layout", ["paged", "slot"])
def test_sampled_burst_trace_admissions_match_reference(bundle, comms, off,
                                                        layout):
    tp.check_engine(bundle, layout, comm=comms,
                    trace_kw=dict(arrival="burst", burst=3,
                                  temperature=0.7))


def test_sampled_trace_repeats_within_the_port(bundle, comms, off):
    """Each request draws from its own generator: the same sampled trace
    twice through the bound engine gives the same tokens, and its
    admissions and tables are the greedy run's (``eos_id=-1``)."""
    model, params = bundle[2], bundle[3]
    eng = ContinuousEngine(model, params, comm=comms[0], device="cpu",
                           **dict(tp.ENGINE_KW, kv_layout="paged"))
    runs = []
    for temp in (0.8, 0.8, 0.0):
        trace = make_trace(6, prompt_len=(5, 19), max_new=(2, 7),
                           arrival="burst", burst=4, rate=400.0,
                           temperature=temp, seed=4)
        runs.append(_replay(eng, model, trace))
        eng.reset()
    (log1, out1), (log2, out2), (greedy_log, greedy_out) = runs
    tp.same_log(log1, log2)
    tp.same_log(log1, greedy_log)
    assert all(np.array_equal(x, y) for x, y in zip(out1, out2))
    assert any(not np.array_equal(x, y) for x, y in zip(out1, greedy_out))


# ---------------------------------------------------------------------------
# (iii) telemetry against the reference's
# ---------------------------------------------------------------------------

ARGS = ("rid", "rows", "jobs", "k", "free", "live", "reason", "protocol")
#: categories only the port emits: an engine step's phases and the MoE
#: block (the reference has no device time to put on them)
PORT_ONLY = ("phase", "block")
PHASES = ("pack", "forward", "sample")


def _events(tracer):
    return [(e["name"], e["cat"], e["ph"],
             {k: e["args"][k] for k in ARGS if k in e["args"]})
            for e in tracer.events() if e["cat"] not in PORT_ONLY]


def _inside(child, parent):
    return (parent["ts"] <= child["ts"] + 1e-3
            and child["ts"] + child["dur"]
            <= parent["ts"] + parent["dur"] + 1e-3)


def _check_port_spans(events, num_layers, moe):
    """The port-only spans: a chunked step's ``admit`` phase comes before
    its chunk batch; each ``prefill_chunk`` / ``decode`` step has its
    three phases, of its ``step``, inside it and in order; each MoE
    layer of a forward is one ``moe`` span inside that forward's
    ``.forward`` phase; no device time on the CPU."""
    steps = {(e["name"], e["args"]["step"]): e for e in events
             if e["name"] in ("prefill_chunk", "decode")}
    assert steps and len(steps) == sum(
        e["name"] in ("prefill_chunk", "decode") for e in events)
    port = [e for e in events if e["cat"] in PORT_ONLY]
    for e in port:
        assert e["ph"] == "X" and e["dur"] >= 0
        assert "device_ms" not in e["args"]
    # a chunked step's admissions: one ``admit`` phase a step, before its
    # chunk batch, holding every admission hop
    admits = {e["args"]["step"]: e for e in port if e["name"] == "admit"}
    assert len(admits) == sum(e["name"] == "admit" for e in port)
    for (name, step), e in steps.items():
        if name == "prefill_chunk":
            a = admits[step]
            assert a["ts"] + a["dur"] <= e["ts"] + 1e-3
    for e in events:
        if e["name"].startswith("hop:admission") and admits:
            assert e["args"]["parent"] == "admit"
    phases = {}
    for e in (e for e in port if e["cat"] == "phase"
              and e["name"] != "admit"):
        parent, _, kind = e["name"].partition(".")
        assert e["args"]["parent"] == parent and kind in PHASES
        assert _inside(e, steps[parent, e["args"]["step"]])
        phases.setdefault((parent, e["args"]["step"]), []).append(e)
    assert set(phases) == set(steps)
    for kids in phases.values():
        assert [k["name"].partition(".")[2] for k in kids] == list(PHASES)
        assert all(a["ts"] + a["dur"] <= b["ts"] + 1e-3
                   for a, b in zip(kids, kids[1:]))
    blocks = [e for e in port if e["cat"] == "block"]
    assert bool(blocks) == moe
    for (parent, step), kids in phases.items():
        fwd = kids[1]
        mine = [b for b in blocks if b["args"]["step"] == step
                and b["args"]["parent"] == fwd["name"]]
        assert all(b["name"] == "moe" and _inside(b, fwd) for b in mine)
        assert [b["args"]["layer"] for b in mine] == (
            list(range(num_layers)) if moe else [])
        phase = "chunk" if parent == "prefill_chunk" else "decode"
        assert all(b["args"]["phase"] == phase for b in mine)
    assert len(blocks) == num_layers * len(steps) * moe


@pytest.mark.parametrize("layout, extra, arch", [
    ("paged", {}, "gemma-2b"), ("paged", {"speculate": 2}, "gemma-2b"),
    ("slot-monolithic", {}, "gemma-2b"), ("paged", {}, "olmoe-1b-7b")])
def test_traced_engines_agree_with_reference(request, comms, traced, layout,
                                             extra, arch):
    bundle = request.getfixturevalue(
        "bundle" if arch == "gemma-2b" else "moe_bundle")
    jmodel, jparams, model, params = bundle
    ours_tr, theirs_tr = traced
    kw = dict(tp.ENGINE_KW, kv_layout=layout.split("-")[0], **extra)
    if layout == "slot-monolithic":
        kw["prefill_chunk"] = 0
    trace = make_trace(5, prompt_len=(5, 19), max_new=(2, 6), rate=400.0,
                       seed=6)
    eng = ContinuousEngine(model, params, device="cpu", comm=comms[0], **kw)
    jeng = JaxEngine(jmodel, jparams, comm=comms[1], **kw)
    a = tp.drive(eng, tp.requests(ServeRequest, model.cfg, trace))
    b = tp.drive(jeng, tp.requests(JaxRequest, model.cfg, trace))
    tp.same_log(a, b)
    ev, jev = _events(ours_tr), _events(theirs_tr)
    assert ev == jev
    names = {e[0] for e in ev}
    step = "spec_round" if extra else "decode"
    assert {"admit", "hop:admission", step} <= names
    assert ("prefill_chunk" in names) == (layout == "paged")
    assert ("block_pool" in names) == (layout == "paged")
    assert ("hop:spec_verify" in names) == bool(extra)
    _check_port_spans(ours_tr.events(), model.cfg.num_layers,
                      moe=arch == "olmoe-1b-7b")
    for e in ours_tr.events():
        if e["name"].startswith("hop:"):
            assert e["cat"] == "residual" and e["args"]["measured_s"] >= 0
            assert e["args"]["residual_ratio"] == pytest.approx(
                e["args"]["measured_s"] / e["args"]["modeled_s"])
    assert ours_tr.residuals.counts() == theirs_tr.residuals.counts()
    rep, jrep = ours_tr.residuals.report(), theirs_tr.residuals.report()
    for kind, row in rep["hops"].items():
        assert row["modeled_s"] == pytest.approx(
            jrep["hops"][kind]["modeled_s"])
    snap, jsnap = M.active().snapshot(), JM.active().snapshot()
    assert snap["counters"] == jsnap["counters"]
    assert snap["gauges"] == jsnap["gauges"]
    assert snap["counters"]["sched.admitted"] == 5.0
    assert snap["counters"]["tokens_out"] == sum(e.max_new for e in trace)
    assert snap["histograms"].keys() == jsnap["histograms"].keys()
    for name, h in snap["histograms"].items():
        assert h == pytest.approx(jsnap["histograms"][name]), name
    for e, tr, reg in ((eng, ours_tr, M), (jeng, theirs_tr, JM)):
        e.reset()
        assert tr.residuals.counts() == {}
        assert reg.active().snapshot()["counters"] == {}


def test_launcher_trace_out_under_repro_trace(tmp_path):
    """The CLI under REPRO_TRACE=1 with a burst, sampled trace: the trace
    file parses as Chrome trace_event JSON with the engine's spans, and
    the payload carries the residual keys."""
    trace_path, out = tmp_path / "trace.json", tmp_path / "serve.json"
    env = dict(os.environ, REPRO_TRACE="1",
               PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
           "--device", "cpu", "--engine", "continuous", "--requests", "4",
           "--slots", "2", "--prompt-len", "16,40", "--max-new-hi", "6",
           "--arrival", "burst", "--temperature", "0.7",
           "--no-chunk-compare", "--no-prefix-compare",
           "--trace-out", str(trace_path), "--json", str(out)]
    res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    doc = json.loads(trace_path.read_text())
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"prefill_chunk", "decode", "admit", "hop:admission",
            "block_pool"} <= names
    assert doc["metadata"]["dropped_events"] == 0
    pay = json.loads(out.read_text())
    assert pay["arrival"] == "burst" and "continuous_spec" not in pay
    for key in ("residual_report", "residual_admission_ratio",
                "serialization_stall_s"):
        assert key in pay
    assert pay["residual_report"]["hops"]["admission"]["n"] > 0
    assert "metrics" in pay["continuous"]
