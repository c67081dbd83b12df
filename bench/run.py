#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's name finds everything it needs: its entry in
``BENCHMARK.json``, its traffic in ``bench/workloads/<cell>.json``, its
configuration file (from ``BENCHMARK.json``), the family's plain
reference in ``bench/reference/<family>.py`` and each per-layer metric's
reader in ``bench/metrics/<metric>.py``.

A run: set-up (imports, the kernels built or loaded from the checkout's
``build/``, the parameters drawn on the card from the seed, the paged
``ContinuousEngine`` of ``repro_torch``, one warm-up over this cell's
shapes), then a window of ``--seconds`` that drives the engine through
``submit`` / ``step`` and stamps every token after the step that made it
visible, then the comparison with the reference. With ``--trace 0`` the
result's metrics are the cell's end-to-end ones, with ``--trace 1`` its
per-layer ones (the program's tracer on, ``torch.profiler`` over a few
seconds in the middle of the window).

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its
limit); the last lines of standard error repeat the checks. No card, too
few cards, no program beside the benchmark, or JAX or the JAX package
in the process after the window or before the result is printed: no
result, exit code 2 or 1.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from collections import deque  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that must not be loaded in a run: JAX and the
#: JAX package the port was made from (``repro_torch`` is not ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: where the profiled slice of a traced run starts, as a share of the
#: window, and how long it lasts at most (seconds); the per-layer
#: metrics read from the program's spans take what came before it
SLICE_AT, SLICE_S = 0.75, 2.0
#: request index of the warm-up's prompts (the window's start at 0)
WARM_INDEX = 1 << 40


def _prepare(root: Path = ROOT) -> None:
    """Import paths (the port's ``src/`` and the checkout), one host
    thread for torch's CPU work (load from one process with few
    threads), and every build or kernel cache at a fixed place inside
    the checkout."""
    for p in (str(root / "src"), str(root)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    torch.set_num_threads(1)
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor")
    os.environ["USE_FLAX"] = "0"


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return metric.get("workloads") is None or cell in metric["workloads"]


def cell_spec(cell: str, root: Path = ROOT) -> SimpleNamespace:
    """Everything a cell's name finds: its ``BENCHMARK.json`` entry,
    workload file, configuration file and the metrics it reports."""
    bj = _json(root / "BENCHMARK.json")
    entry = next(w for w in bj["workloads"] if w["name"] == cell)
    conf = next(c for c in bj["configs"] if c["name"] == entry["config"])
    return SimpleNamespace(
        name=cell, chips=int(entry["chips"]),
        wl=_json(root / "bench" / "workloads" / f"{cell}.json"),
        cfg=_json(root / conf["file"]),
        end_to_end=[m for m in bj["end_to_end"] if _applies(m, cell)],
        per_layer=[m for m in bj["per_layer"] if _applies(m, cell)])


def load_reader(name: str, root: Path = ROOT):
    """A per-layer metric's reader module, ``bench/metrics/<name>.py``."""
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def refuse_forbidden() -> None:
    """End the process with exit code 1, naming them on standard error,
    if any of :data:`FORBIDDEN` is loaded."""
    found = forbidden_modules()
    if found:
        raise SystemExit(f"loaded in this process: {', '.join(found)}")


class _Live:
    """A request in flight, as the harness follows it."""
    __slots__ = ("entry", "req", "clock", "chunks", "gen", "client")

    def __init__(self, entry, req, clock, client):
        self.entry, self.req, self.clock = entry, req, clock
        self.chunks = self.gen = 0
        self.client = client


class Drive:
    """The measured window: submits the cell's requests when due, steps
    the engine, and reads each request's progress after every step."""

    def __init__(self, engine, wl: dict, seed: int, seconds: float,
                 vocab: int, *, traced: bool, readers=()):
        from bench import traffic
        self.engine, self.wl, self.seed = engine, wl, seed
        self.seconds = float(seconds)
        self.vocab = vocab
        self.traced = traced
        self.readers = readers
        self.chunk = engine.prefill_chunk
        self.closed = wl["loop"] == "closed"
        if self.closed:
            self.pool = traffic.ClosedPool(wl, seed)
            self.pending = deque()
        else:
            self.pending = deque(traffic.open_schedule(wl, seed, seconds))
        self.tokens = {e.index: traffic.prompt_tokens(seed, e.index,
                                                      e.prompt_len, vocab)
                       for e in self.pending}
        self.live: list = []
        self.clocks: list = []
        self.steps: list = []
        self.finished: list = []       # (prompt, served) of done requests
        self.dues: dict = {}
        self.next_index = 0
        self.slice = None
        self._c0: dict = {}
        self.counters: dict = {}

    # -- requests --------------------------------------------------------
    def _submit(self, entry, due: float, now: float, client=None) -> None:
        from bench import stats, traffic
        from repro_torch.serve.scheduler import ServeRequest
        tok = self.tokens.pop(entry.index, None)
        if tok is None:
            tok = traffic.prompt_tokens(self.seed, entry.index,
                                        entry.prompt_len, self.vocab)
        req = ServeRequest(rid=entry.index, batch={"tokens": tok},
                           max_new_tokens=entry.max_new, temperature=0.0,
                           seed=0, arrival=due)
        self.engine.submit(req, now)
        clock = stats.RequestClock(due)
        self.clocks.append(clock)
        self.dues[entry.index] = due
        self.live.append(_Live(entry, req, clock, client))

    def _closed_next(self, client: int, due: float, now: float) -> None:
        entry = self.pool.entry(self.next_index)
        self.next_index += 1
        self._submit(entry, due, now, client)

    # -- the window ------------------------------------------------------
    def run(self, t_start: float) -> SimpleNamespace:
        from torch.profiler import record_function

        from bench import devtrace, work
        clock = time.perf_counter
        eng = self.engine
        # what set-up made lives to the end: the collector leaves it be
        gc.collect()
        gc.freeze()
        t_open = clock()
        setup_s = t_open - t_start
        deadline = self.seconds
        slice_at = SLICE_AT * self.seconds
        slice_end = None
        if self.closed:
            for client in range(int(self.wl["clients"])):
                self._closed_next(client, 0.0, 0.0)
        while True:
            now = clock() - t_open
            if now >= deadline:
                break
            while self.pending and self.pending[0].due <= now:
                e = self.pending.popleft()
                self._submit(e, e.due, now)
            if eng.idle:
                wake = self.pending[0].due if self.pending else deadline
                time.sleep(max(0.0, min(wake, deadline) - now))
                continue
            if self.traced and self.slice is None and now >= slice_at:
                self._slice_start(devtrace)
                slice_end = now + min(SLICE_S, 0.25 * self.seconds)
            in_slice = self.slice is not None and slice_end is not None
            if in_slice:
                with record_function(devtrace.ANNOTATIONS[0]):
                    eng.step(now)
            else:
                eng.step(now)
            t = clock() - t_open
            step = work.Step(now, t, in_slice=in_slice)
            self._observe(step, t)
            self.steps.append(step)
            if in_slice and t >= slice_end:
                self._slice_stop()
                slice_end = None
        if slice_end is not None:
            self._slice_stop()
        t_close = clock() - t_open
        gc.unfreeze()
        return SimpleNamespace(setup_s=setup_s, t_close=t_close,
                               t_open=t_open)

    def _observe(self, step, t: float) -> None:
        """Read every request in flight after a step: the prompt chunks it
        rode in, the tokens that became visible (stamped at ``t``), and
        whether it finished (a closed-loop client then sends its next)."""
        C = self.chunk
        current, self.live = self.live, []
        for lv in current:
            req, P = lv.req, lv.entry.prompt_len
            for k in range(lv.chunks + 1, req.prefill_chunks + 1):
                pos0 = (k - 1) * C
                step.chunks.append((P, pos0, min(C, P - pos0)))
            lv.chunks = req.prefill_chunks
            g = req.generated
            # output token i >= 1 came from a decode row reading P + i keys
            step.decode.extend(P + i for i in range(max(lv.gen, 1), g))
            step.generated += lv.clock.observe(g, t)
            lv.gen = g
            if req.state != "done":
                self.live.append(lv)
                continue
            self.finished.append((req.batch["tokens"][0].copy(),
                                  req.output.copy()))
            if self.closed:
                self._closed_next(lv.client, t, t)

    # -- the profiled slice ----------------------------------------------
    def _counters(self) -> dict:
        out = {}
        for r in self.readers:
            for mod, name in getattr(r, "COUNTERS", ()):
                out[(mod, name)] = getattr(importlib.import_module(mod),
                                           name)
        return out

    def _slice_start(self, devtrace) -> None:
        self._c0 = self._counters()
        self.slice = devtrace.Slice()
        self.slice.start()

    def _slice_stop(self) -> None:
        self.slice.stop()
        c1 = self._counters()
        self.counters = {k: c1[k] - self._c0[k] for k in c1}


def reference(cfg: dict):
    """The configuration's plain reference, ``bench/reference/<name>.py``."""
    return importlib.import_module(f"bench.reference.{cfg['reference']}")


def make_model(cfg: dict, device: str):
    """The port's model bundle for a configuration file, in its dtype."""
    from repro_torch.config import ModelConfig, ServeConfig
    from repro_torch.models.registry import build_model
    return build_model(ModelConfig(**cfg["port"]), ServeConfig(
        param_dtype=cfg["dtype"], compute_dtype=cfg["dtype"]), device=device)


def make_engine(model, params, wl: dict, seed: int, device: str):
    """The cell's paged ``ContinuousEngine``, warmed on its shapes."""
    from bench import traffic
    from repro_torch.serve.engine import ContinuousEngine
    engine = ContinuousEngine(
        model, params, cache_len=traffic.longest_request(wl),
        num_slots=wl["rows"], prefill_chunk=wl["prefill_chunk"],
        max_prefill_per_step=wl["max_prefill_per_step"], kv_layout="paged",
        block_size=wl["block_size"], device=device)
    _warm_up(engine, model.cfg.vocab_size, seed)
    return engine


def _warm_up(engine, vocab: int, seed: int) -> None:
    """Drive this cell's shapes once before the window: one request more
    than a step prefills, each of one chunk and one token more, so the
    widest chunk batch and smaller ones, a prompt's last chunk and the
    decode step all run; then a fresh engine state."""
    from bench import traffic
    from repro_torch.serve.scheduler import ServeRequest
    n = engine.prefill_chunk + 1
    reqs = [ServeRequest(rid=i, batch={"tokens": traffic.prompt_tokens(
        seed, WARM_INDEX + i, n, vocab)}, max_new_tokens=3)
        for i in range(engine.max_prefill_per_step + 1)]
    for r in reqs:
        engine.submit(r, 0.0)
    while not engine.idle:
        engine.step(0.0)
    engine.reset()


def _spans(tracer, tracer_t0: float, t_open: float) -> list:
    """The program tracer's events as (name, start, end, args), in seconds
    of the window's clock."""
    out = []
    for ev in tracer.events():
        t0 = tracer_t0 + ev["ts"] * 1e-6 - t_open
        out.append((ev["name"], t0, t0 + ev.get("dur", 0.0) * 1e-6,
                    ev.get("args", {})))
    return out


def run_cell(spec, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float = T_START,
             control: bool = False) -> dict:
    """One run of the cell ``spec`` (:func:`cell_spec`): set-up, window,
    comparison; returns the result object. ``device="cpu"`` runs the
    port's plain path (for tests at small sizes; no device metric).
    ``control`` (calibration only, ``bench/calibrate.py``) adds the fp8
    control's readings on the same sample as ``control_readings``."""
    import torch

    from bench import check, hw, stats, work

    cfg, wl = spec.cfg, spec.wl
    ref = reference(cfg)
    readers = ({m["name"]: load_reader(m["name"]) for m in spec.per_layer}
               if trace else {})
    tracer = None
    if trace:
        from repro_torch import obs
        a = time.perf_counter()
        tracer = obs.install(capacity=1 << 20)
        tracer_t0 = 0.5 * (a + time.perf_counter())
    port = cfg["port"]
    vocab = int(port["vocab_size"])
    model = make_model(cfg, device)
    params = ref.make_params(port, seed, device,
                             dtype=getattr(torch, cfg["dtype"]))
    engine = make_engine(model, params, wl, seed, device)
    on_card = torch.device(device).type == "cuda"
    if trace and on_card:
        from bench import devtrace
        devtrace.warm()
    if on_card:
        torch.cuda.synchronize()
    drive = Drive(engine, wl, seed, seconds, vocab, traced=trace,
                  readers=list(readers.values()))
    win = drive.run(t_start)
    window_s = win.t_close
    refuse_forbidden()
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0

    spans = _spans(tracer, tracer_t0, win.t_open) if tracer else []
    if tracer is not None:
        from repro_torch import obs
        obs.uninstall()
    c = dict(port, kv_block=wl["block_size"])
    run = SimpleNamespace(
        c=c, wl=wl, steps=drive.steps, clocks=drive.clocks,
        window_s=window_s, spans=spans, dues=drive.dues,
        slice_at=SLICE_AT * float(seconds),
        reading=drive.slice.read() if drive.slice else None,
        counters=drive.counters, hw=hw, work=work, stats=stats)
    metrics = {}
    if trace:
        for m in spec.per_layer:
            v = readers[m["name"]].read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = {"setup_s": win.setup_s,
               "processed_tok_s": sum(s.tokens for s in drive.steps)
               / window_s,
               "ttft_p95_ms": stats.ttft_p95_ms(drive.clocks, window_s),
               "itl_p95_ms": stats.itl_p95_ms(drive.clocks)}
        for m in spec.end_to_end:
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                      "unit": m["unit"]}

    # the comparison, with the program's state freed
    finished = drive.finished
    n_due = len(drive.clocks)
    del drive, engine, model
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    chk = wl["check"]
    sample = check.pick(finished, seed, int(chk["requests"]))
    read = check.readings(check.gaps(ref, params, port, sample, device))
    correct, checks = check.judge(read, chk)

    result = {"correct": correct, "attempted": n_due, "failed": 0,
              "metrics": metrics,
              "device": _device(on_card, peak)}
    if trace and run.reading is not None:
        result["device"]["busy_s"] = run.reading.busy_s()
        result["device"]["window_s"] = run.reading.window_s
        result["breakdown"] = {"device_ops": run.reading.top_ops(),
                               "idle_gaps": run.reading.idle_gaps()}
    result["readings"] = read
    if control:
        result["control_readings"] = check.readings(check.gaps(
            ref, params, port, sample, device, control=True))
    result["checks"] = checks
    return result


def _device(on_card: bool, peak: int) -> dict:
    import torch
    if not on_card:
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": peak}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = cell_spec(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec.chips:
        print(f"{args.workload} needs {spec.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    _prepare()
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    # what the readers and the reference loaded counts too
    refuse_forbidden()
    for name, chk in result["checks"].items():
        print(f"check {name}: {chk['value']} (limit {chk['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
