"""The paged engine's step spans and chunk counters on the CPU, at the
smoke configurations of the two families the benchmark serves (olmoe's
MoE block, mamba2's carried state), float32.

- Each ``prefill_chunk`` span's ``tokens`` and ``positions`` are its
  batch's valid prompt tokens and ``rows x chunk``, as the model call saw
  them; the engine's always-on counters move by the spans' sums.
- Each MoE forward is ``num_layers`` ``moe`` spans, one a layer, of the
  forward's phase.
- Tracing on or off, the outputs and the final pool are bitwise equal.
"""

import numpy as np
import pytest
import torch

from repro_torch.config import ServeConfig
from repro_torch.configs import get_smoke_config
from repro_torch.models.registry import build_model
from repro_torch.obs import metrics as M
from repro_torch.obs import trace as T
from repro_torch.serve import ContinuousEngine, ServeRequest
from repro_torch.serve import engine as engine_mod

ARCHES = ["olmoe-1b-7b", "mamba2-370m"]
#: prompt lengths: several chunks, a short last chunk, one chunk exactly
PROMPTS = (37, 9, 21, 50, 16)
CHUNK = 16


@pytest.fixture(scope="module", params=ARCHES)
def bundle(request):
    cfg = get_smoke_config(request.param)
    model = build_model(cfg, ServeConfig(param_dtype="float32",
                                         compute_dtype="float32"),
                        device="cpu")
    return model, model.init(0)


@pytest.fixture
def quiet():
    for mod in (T, M):
        mod.uninstall()
    yield
    for mod in (T, M):
        mod.uninstall()


def _drive(model, params, traced):
    """Serve :data:`PROMPTS` to the end; returns (outputs, final pool,
    the chunk batches the model ran as (rows, valid tokens), the tracer's
    events, the counters' moves)."""
    batches = []
    real = model.prefill_chunk_paged

    def seen(params, cache, tokens, tables, rows, pos0, n_valid):
        batches.append((tokens.shape, int(n_valid.sum())))
        return real(params, cache, tokens, tables, rows, pos0, n_valid)
    model = model._replace(prefill_chunk_paged=seen)
    tr = T.install(capacity=1 << 16) if traced else None
    c0 = (engine_mod.prefill_positions, engine_mod.prefill_valid_tokens)
    try:
        eng = ContinuousEngine(model, params, cache_len=64, num_slots=3,
                               prefill_chunk=CHUNK, max_prefill_per_step=2,
                               kv_layout="paged", block_size=8,
                               device="cpu")
        rng = np.random.default_rng(5)
        reqs = [ServeRequest(rid=i, batch={"tokens": rng.integers(
            0, model.cfg.vocab_size, (1, n)).astype(np.int32)},
            max_new_tokens=4) for i, n in enumerate(PROMPTS)]
        for r in reqs:
            eng.submit(r, 0.0)
        while not eng.idle:
            eng.step(0.0)
        events = tr.events() if tr is not None else []
    finally:
        T.uninstall()
    moved = (engine_mod.prefill_positions - c0[0],
             engine_mod.prefill_valid_tokens - c0[1])
    pool = {k: v.clone() for k, v in eng.kv.buffers.items()}
    return [r.output.copy() for r in reqs], pool, batches, events, moved


def test_chunk_spans_carry_their_batch_and_the_counters_agree(bundle,
                                                              quiet):
    model, params = bundle
    _, _, batches, events, moved = _drive(model, params, traced=True)
    chunks = [e for e in events if e["name"] == "prefill_chunk"]
    assert len(chunks) == len(batches) > 1
    for e, ((n, C), valid) in zip(chunks, batches):
        assert C == CHUNK
        assert e["args"]["tokens"] == valid
        assert e["args"]["positions"] == n * C
        assert e["args"]["jobs"] == n
    assert sum(v for _, v in batches) == sum(PROMPTS)
    assert moved == (sum(e["args"]["positions"] for e in chunks),
                     sum(e["args"]["tokens"] for e in chunks))
    for name in ("prefill_chunk", "decode"):
        steps = [e["args"]["step"] for e in events if e["name"] == name]
        assert steps and all(a < b for a, b in zip(steps, steps[1:]))


def test_moe_spans_one_a_layer_of_each_forward(bundle, quiet):
    model, params = bundle
    _, _, _, events, _ = _drive(model, params, traced=True)
    moe = model.cfg.block == "moe"
    L = model.cfg.num_layers
    for name, phase in (("prefill_chunk", "chunk"), ("decode", "decode")):
        for e in (e for e in events if e["name"] == name):
            mine = [b for b in events if b["name"] == "moe"
                    and b["args"]["step"] == e["args"]["step"]
                    and b["args"]["phase"] == phase]
            assert [b["args"]["layer"] for b in mine] == (
                list(range(L)) if moe else [])
            assert all(b["cat"] == "block"
                       and b["args"]["parent"] == f"{name}.forward"
                       for b in mine)


def test_tracing_changes_no_bit(bundle, quiet):
    model, params = bundle
    off = _drive(model, params, traced=False)
    on = _drive(model, params, traced=True)
    assert off[3] == [] and on[3]
    assert all(np.array_equal(a, b) for a, b in zip(off[0], on[0]))
    assert off[1].keys() == on[1].keys()
    for k in off[1]:
        assert torch.equal(off[1][k], on[1][k]), k
    assert off[2] == on[2] and off[4] == on[4]
