"""The readers of the program's spans and counters (``prefill_chunk_ms``,
``moe_roofline``, ``chunk_valid_share``) and of the idle split
(``idle_in_forward.saturated``, ``idle_in_engine.saturated``), each on a
made-up run with values worked out by hand; what each reads from a
program without the spans (nothing, and no error); and a traced run of
each cell at a CPU size, in which every reader returns a number or
nothing."""

import time
from types import SimpleNamespace

import pytest

from bench import devtrace, hw, readers, stats
from bench.run import load_reader
from conftest import ROOT, SMALL, small_spec

SLICE_AT = 30.0
#: olmoe's smoke sizes: d 64, d_ff 32, 8 experts, top-2, swiglu
SMOKE_MOE = {"block": "moe", "d_model": 64, "d_ff": 32, "num_experts": 8,
             "top_k": 2, "mlp_act": "swiglu"}


def _read(name, **run):
    base = dict(c=SMOKE_MOE, spans=[], slice_at=SLICE_AT, counters={},
                reading=None, hw=hw, stats=stats)
    return load_reader(name, ROOT).read(SimpleNamespace(**dict(base, **run)))


def _span(name, t0, **args):
    return (name, t0, t0 + 0.01, args)


# -- prefill_chunk_ms ------------------------------------------------------

def test_prefill_chunk_ms_is_the_median_before_the_slice():
    spans = [_span("prefill_chunk", 1.0, step=1, device_ms=80.0),
             _span("prefill_chunk", 2.0, step=3, device_ms=100.0),
             _span("prefill_chunk", 3.0, step=5, device_ms=90.0),
             _span("prefill_chunk", SLICE_AT + 1, step=9, device_ms=500.0),
             _span("decode", 4.0, step=5, device_ms=7.0)]
    assert _read("prefill_chunk_ms", spans=spans) == 90.0


def test_prefill_chunk_ms_reads_nothing_without_device_time():
    spans = [_span("prefill_chunk", 1.0, jobs=2)]        # host clock only
    assert _read("prefill_chunk_ms", spans=spans) is None


# -- moe_roofline ----------------------------------------------------------

def _moe_spans(**chunk_kw):
    return [_span("prefill_chunk", 1.0, step=1, tokens=10, positions=32,
                  **chunk_kw),
            _span("moe", 1.0, step=1, phase="chunk", layer=0,
                  device_ms=0.001),
            _span("prefill_chunk", 2.0, step=2, tokens=3, positions=32,
                  **chunk_kw),
            _span("moe", 2.0, step=2, phase="chunk", layer=0,
                  device_ms=0.002),
            # a decode step's call and one in the slice are not counted
            _span("moe", 3.0, step=3, phase="decode", layer=0,
                  device_ms=5.0),
            _span("moe", SLICE_AT + 1, step=2, phase="chunk", layer=1,
                  device_ms=5.0)]


def test_moe_roofline_by_hand():
    # V = 10: 10 (2*64*8 + 2*2*3*64*32) = 256,000 FLOPs; 8 experts of
    # 3*64*32 weights, the router's 64*8, 10*64 in and out, in bf16:
    # 2 (49,152 + 512 + 1,280) = 101,888 bytes; bytes bound the call.
    # V = 3: 76,800 FLOPs; 6 experts: 2 (36,864 + 512 + 384) = 75,520.
    want = 100.0 * (101888 / 3.35e12 + 75520 / 3.35e12) / 3e-6
    got = _read("moe_roofline", spans=_moe_spans(device_ms=1.0))
    assert got == pytest.approx(want, rel=1e-12)
    assert 0 < got <= 100


def test_moe_roofline_lost_spans_fail_the_run():
    spans = [s for s in _moe_spans(device_ms=1.0) if s[0] != "moe"]
    with pytest.raises(RuntimeError, match="no device-timed moe span"):
        _read("moe_roofline", spans=spans)


@pytest.mark.parametrize("spans", [
    # a program without the spans: chunks on the host clock only
    [_span("prefill_chunk", 1.0, jobs=2)],
    # a CPU run: the spans, no device time
    [_span("prefill_chunk", 1.0, step=1, tokens=10, positions=32),
     _span("moe", 1.0, step=1, phase="chunk", layer=0)],
])
def test_moe_roofline_reads_nothing_without_device_time(spans):
    assert _read("moe_roofline", spans=spans) is None


def test_moe_roofline_is_for_moe_configs_only():
    assert _read("moe_roofline", c={"block": "ssm"},
                 spans=_moe_spans(device_ms=1.0)) is None


# -- chunk_valid_share -----------------------------------------------------

def test_chunk_valid_share_from_the_counters_moves():
    eng = "repro_torch.serve.engine"
    mod = load_reader("chunk_valid_share", ROOT)
    assert set(mod.COUNTERS) == {(eng, "prefill_valid_tokens"),
                                 (eng, "prefill_positions")}
    counters = {(eng, "prefill_valid_tokens"): 3_000,
                (eng, "prefill_positions"): 4_096}
    assert _read("chunk_valid_share", counters=counters) == \
        pytest.approx(100.0 * 3_000 / 4_096)
    assert _read("chunk_valid_share", counters={}) is None


def test_chunk_valid_share_declares_no_counter_a_program_lacks(monkeypatch):
    from repro_torch.serve import engine
    monkeypatch.delattr(engine, "prefill_positions")
    mod = load_reader("chunk_valid_share", ROOT)
    assert mod.COUNTERS == (("repro_torch.serve.engine",
                             "prefill_valid_tokens"),)


# -- the idle split --------------------------------------------------------

def _reading(forward=True):
    r = devtrace.Reading(window_s=10.0)
    # busy [1, 4] and [6, 7]: idle [0, 1], [4, 6], [7, 10], 6 s of 10
    r.device = [("k", 1.0, 2.0), ("k", 2.5, 1.5), ("k", 6.0, 1.0)]
    r.host = [("engine.step", 0.5, 9.0), ("aten::mm", 4.0, 4.5)]
    if forward:
        r.host += [("prefill_chunk.forward", 3.5, 5.0),
                   ("decode.forward", 6.5, 8.0)]
    return r


def test_idle_split_by_hand():
    r = _reading()
    share = readers.idle_share(SimpleNamespace(reading=r))
    fwd = _read("idle_in_forward.saturated", reading=r)
    eng = _read("idle_in_engine.saturated", reading=r)
    # in a forward: [4, 5] and [7, 8]; in engine.step outside one:
    # [0.5, 1], [5, 6], [8, 9]
    assert (share, fwd, eng) == pytest.approx((60.0, 20.0, 25.0))
    assert fwd + eng <= share


def test_idle_split_reads_nothing_without_forward_ranges():
    r = _reading(forward=False)
    for name in ("idle_in_forward.saturated", "idle_in_engine.saturated"):
        assert _read(name, reading=r) is None
        assert _read(name, reading=None) is None


# -- a whole traced run at a CPU size --------------------------------------

NEW = ("prefill_chunk_ms", "moe_roofline", "chunk_valid_share",
       "idle_in_forward.saturated", "idle_in_engine.saturated")


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_traced_cpu_run_reads_every_metric_or_nothing(cell, monkeypatch):
    """The slice profiles the CPU: the counters read, the device metrics
    and the device-timed spans read nothing, and no reader raises."""
    from bench import run
    seen = {}
    real = run.load_reader

    def load(name, root=run.ROOT):
        mod = real(name, root)
        read = mod.read

        def recorded(r):
            seen[name] = read(r)
            return seen[name]
        mod.read = recorded
        return mod
    monkeypatch.setattr(run, "load_reader", load)
    res = run.run_cell(small_spec(cell), 2 ** 31 + 11, 2.0, True,
                       device="cpu", t_start=time.perf_counter())
    assert res["correct"], res["checks"]
    mine = {m for m in NEW if m in seen}
    assert mine == ({m for m in NEW if m != "moe_roofline"}
                    | ({"moe_roofline"} if cell.startswith("olmoe") else
                       set()))
    for name in mine:
        v = seen[name]
        assert v is None or isinstance(v, float), (name, v)
    assert 0 < seen["chunk_valid_share"] <= 100
    for name in mine - {"chunk_valid_share"}:
        assert seen[name] is None, name
