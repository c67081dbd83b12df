"""Port SSM (mamba2) and hybrid (hymba) families vs the JAX reference, on
their smoke configs.

Both sides run the same parameters (the reference's ``init``, moved over
through ``interop.params_from_numpy``) in float32 on the CPU, where the
port's scan is its plain chunked version and its attention the plain
path. Steps are held to the reference's at 1e-5 (logits and every state
leaf; the two sides sum in different orders): the monolithic prefill,
the slot decode step and slot chunk, and the paged chunk (with the
reference's ``rows`` argument, an out-of-range padding row included) and
paged decode. Byte-exact checks are the port's own: parked rows keep
their carried state, and a stale state in a recycled row cannot leak into
a chunk at ``pos0 == 0``. The engines (paged and slot continuous, chunk
16, and static) emit the reference's greedy tokens with the same
admissions on ``test_family_parity.py``'s prompt. No test here asserts
that a chunked state equals the monolithic one bit for bit: the reference
does not give that on this jax either (``in_proj`` at different row
counts).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ServeConfig as JServeConfig
from repro.config import TrainConfig
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.registry import build_model as jax_build_model
from repro.models.registry import derive_capabilities as jax_caps
from repro.models.registry import make_synthetic_batch
from repro.serve import ContinuousEngine as JaxEngine
from repro.serve import StaticEngine as JaxStatic
from repro_torch.config import ServeConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.interop import params_from_numpy, slot_cache_from_numpy
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import transformer
from repro_torch.models.registry import build_model, derive_capabilities
from repro_torch.serve import ContinuousEngine, StaticEngine

ARCHS = ["mamba2-370m", "hymba-1.5b"]
TOL = 1e-5
TRAIN = TrainConfig(param_dtype="float32", compute_dtype="float32",
                    loss_chunk=16, attn_chunk_threshold=64, attn_chunk=16,
                    remat=False)
F32 = ServeConfig(param_dtype="float32", compute_dtype="float32",
                  attn_chunk_threshold=64, attn_chunk=16)
PARK = -(2 ** 30)
STATE = ("conv", "ssm")


@pytest.fixture(scope="module", params=ARCHS)
def bundle(request):
    jcfg = jax_smoke_config(request.param)
    jmodel = jax_build_model(jcfg, TRAIN, JServeConfig(), tp=1)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config(request.param)
    model = build_model(cfg, F32, device="cpu")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               cfg)
    return jmodel, jparams, model, params


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape).astype(np.int32)


def _garbage_state(cfg, rows, seed):
    """Stale carried state of ``rows`` rows: what a recycled row holds."""
    rng = np.random.default_rng(seed)
    conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_state
    L = cfg.num_layers
    return {"conv": rng.standard_normal((L, rows, cfg.ssm_conv - 1,
                                         conv_dim), dtype=np.float32),
            "ssm": rng.standard_normal((L, rows, cfg.ssm_heads,
                                        cfg.ssm_head_dim, cfg.ssm_state),
                                       dtype=np.float32)}


# ---------------------------------------------------------------------------
# capabilities
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_capabilities_equal_reference(arch):
    """Field by field, ``reason`` verbatim, smoke and published configs."""
    for cfg, jcfg in ((get_smoke_config(arch), jax_smoke_config(arch)),
                      (get_config(arch), get_config(arch))):
        assert derive_capabilities(cfg)._asdict() == jax_caps(jcfg)._asdict()
    assert derive_capabilities(get_config(arch)).chunk_multiple == 128


def test_chunk_multiple_clamp_matches_reference(bundle):
    """The engine floors the chunk to ``chunk_multiple`` and raises, with
    the reference's message, when nothing is left."""
    jmodel, jparams, model, params = bundle
    for kv_layout in ("slot", "paged"):
        eng = ContinuousEngine(model, params, cache_len=32, num_slots=2,
                               prefill_chunk=12, kv_layout=kv_layout,
                               block_size=4, device="cpu")
        ref = JaxEngine(jmodel, jparams, cache_len=32, num_slots=2,
                        prefill_chunk=12, kv_layout=kv_layout, block_size=4)
        assert eng.prefill_chunk == ref.prefill_chunk == 8
        for chunk, cache_len in ((4, 32), (16, 6)):
            with pytest.raises(ValueError) as ours:
                ContinuousEngine(model, params, cache_len=cache_len,
                                 num_slots=2, prefill_chunk=chunk,
                                 kv_layout=kv_layout, device="cpu")
            with pytest.raises(ValueError) as theirs:
                JaxEngine(jmodel, jparams, cache_len=cache_len, num_slots=2,
                          prefill_chunk=chunk, kv_layout=kv_layout)
            assert str(ours.value) == str(theirs.value)
            assert "chunk_multiple=8" in str(ours.value)


# ---------------------------------------------------------------------------
# slot layout: monolithic prefill, decode, chunk
# ---------------------------------------------------------------------------

def _check_slot_cache(cache, jcache, rows=None):
    """The port's slot cache against a reference cache (numpy leaves). The
    k/v scratch column, where the port's padding queries write and the
    reference's drop, is left out; its position stays -1."""
    ref = slot_cache_from_numpy(jcache)
    for k, v in ref.items():
        got = cache[k]
        if rows is not None:            # pos is row-major, the rest layer-
            got = got[rows] if k == "pos" else got[:, rows]     # major
        if k == "pos":
            assert torch.equal(got, v)
        elif k in ("k", "v"):
            _close(got[:, :, :-1], v[:, :, :-1])
        else:
            _close(got, v)


@pytest.mark.parametrize("S", [13, 16])
def test_prefill_matches_reference(bundle, S):
    """Monolithic prefill (ragged and chunk-aligned S): logits and the
    whole slot cache; attention-free caches hold only the state."""
    jmodel, jparams, model, params = bundle
    cfg = model.cfg
    tok = _tokens(cfg, (2, S), seed=S)
    ssd_ops.reset_counters()
    transformer.reset_counters()
    logits, cache = model.prefill(params, torch.as_tensor(tok), 24)
    assert transformer.prefill_calls == 1
    assert ssd_ops.counters()["ref_calls"] == cfg.num_layers
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(tok)}, 24)
    _close(logits, jl)
    jc = jax.tree_util.tree_map(np.asarray, jc)
    assert set(cache) == set(jc)
    assert cfg.uses_attention == ("k" in cache)
    _check_slot_cache(cache, jc)


def _row_cache(jcache, b):
    """Row ``b`` of a reference slot cache, as a batch-1 cache."""
    return {k: (v if k == "pos" else v[:, b:b + 1]) for k, v in
            jcache.items()}


def test_slot_decode_matches_reference(bundle):
    """Decode from prefilled rows at per-row positions: a live row against
    the reference's step, a parked row keeps its state byte for byte."""
    jmodel, jparams, model, params = bundle
    cfg = model.cfg
    tok = _tokens(cfg, (2, 13), seed=3)
    _, cache = model.prefill(params, torch.as_tensor(tok), 24)
    _, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(tok)}, 24)
    before = {k: cache[k].clone() for k in STATE}
    nxt = _tokens(cfg, (2, 1), seed=4)
    logits = model.decode_step(params, cache, torch.as_tensor(nxt),
                               torch.tensor([13, PARK]))
    jl, jrow = jmodel.decode_step(jparams, _row_cache(jc, 0),
                                  jnp.asarray(nxt[:1]), jnp.int32(13))
    _close(logits[:1], jl)
    _check_slot_cache(cache, jax.tree_util.tree_map(np.asarray, jrow),
                      rows=[0])
    for k in STATE:
        assert torch.equal(cache[k][:, 1], before[k][:, 1])


def test_slot_chunk_matches_reference(bundle):
    """Two slot chunks over two rows with stale state: at ``pos0 == 0`` the
    stale state is dropped (equal to a zero-state run bit for bit), then a
    full and a partial chunk resume; each row against the reference's
    per-request chunk step."""
    jmodel, jparams, model, params = bundle
    cfg = model.cfg
    C = 8
    prompts = _tokens(cfg, (2, 2 * C), seed=5)
    cache = model.init_cache(2, 24)
    zero = {k: v.clone() for k, v in cache.items()}
    stale = _garbage_state(cfg, 2, seed=6)
    for k in STATE:
        cache[k].copy_(torch.as_tensor(stale[k]))
    jcs = [jmodel.init_cache(1, 24) for _ in range(2)]
    jcs = [{k: (jnp.asarray(stale[k][:, b:b + 1]) if k in STATE else v)
            for k, v in c.items()} for b, c in enumerate(jcs)]
    for step, (pos0, n_valid) in enumerate((([0, 0], [C, C]),
                                            ([C, C], [C, 5]))):
        tok = np.stack([prompts[b, pos0[b]:pos0[b] + C] for b in range(2)])
        args = (torch.as_tensor(tok), torch.tensor(pos0),
                torch.tensor(n_valid))
        if step == 0:
            clean = model.prefill_chunk(params, zero, *args)
        logits = model.prefill_chunk(params, cache, *args)
        if step == 0:
            assert torch.equal(logits, clean)
            for k in STATE:
                assert torch.equal(cache[k], zero[k])
        for b in range(2):
            jl, jcs[b] = jmodel.prefill_chunk(
                jparams, jcs[b], jnp.asarray(tok[b]), jnp.int32(pos0[b]),
                jnp.int32(n_valid[b]))
            _close(logits[b], jl)
            _check_slot_cache(cache, jax.tree_util.tree_map(np.asarray,
                                                            jcs[b]),
                              rows=[b])


# ---------------------------------------------------------------------------
# paged layout: chunk with rows, decode
# ---------------------------------------------------------------------------

NUM_ROWS, P, BS, NB = 3, 12, 4, 6


def _paged_pool(cfg, seed):
    rng = np.random.default_rng(seed)
    pool = _garbage_state(cfg, NUM_ROWS, seed + 1)
    if cfg.uses_attention:
        shape = (cfg.num_layers, P, BS, cfg.num_kv_heads, cfg.head_dim)
        pool["k"] = rng.standard_normal(shape, dtype=np.float32)
        pool["v"] = rng.standard_normal(shape, dtype=np.float32)
    return pool


def _run_paged(bundle, pool, kind, *args):
    """One paged step on both sides from the same pool: (port logits,
    reference logits, port pool, reference pool) as numpy."""
    jmodel, jparams, model, params = bundle
    tpool = {k: torch.as_tensor(v.copy()) for k, v in pool.items()}
    jpool = {k: jnp.asarray(v) for k, v in pool.items()}
    targs = [torch.as_tensor(a) for a in args]
    jargs = [jnp.asarray(a) for a in args]
    if kind == "decode":
        port = model.decode_step_paged(params, tpool, *targs)
        ref, jpool = jmodel.decode_step_paged(jparams, jpool, *jargs)
    else:
        port = model.prefill_chunk_paged(params, tpool, *targs)
        ref, jpool = jmodel.prefill_chunk_paged(jparams, jpool, *jargs)
    return (port.numpy(), np.asarray(ref),
            {k: v.numpy() for k, v in tpool.items()},
            {k: np.asarray(v) for k, v in jpool.items()})


def _tables():
    t = np.full((NUM_ROWS, NB), -1, np.int32)
    t[0, :4] = [3, 7, 1, 10]
    t[1, :3] = [0, 5, 9]
    t[2, :5] = [2, 11, 4, 6, 8]
    return t


def test_paged_chunk_matches_reference(bundle):
    """Chunk rows aimed at request rows 2 and 0 (out of order) and a
    padding row aimed past the last row (all -1 table, n_valid 0): logits
    of the valid rows, every pool and state leaf; the padding row writes
    nothing; row 1's state is untouched; row 2's stale state does not
    leak into its pos0 == 0 chunk."""
    cfg = bundle[2].cfg
    C = 8
    pool = _paged_pool(cfg, seed=10)
    tables = _tables()
    tok = _tokens(cfg, (3, C), seed=11)
    ctab = np.stack([tables[2], tables[0], np.full(NB, -1, np.int32)])
    rows = np.array([2, 0, NUM_ROWS], np.int32)
    pos0 = np.array([0, 8, 0], np.int32)
    n_valid = np.array([C, 5, 0], np.int32)
    port, ref, tpool, jpool = _run_paged(bundle, pool, "chunk", tok, ctab,
                                         rows, pos0, n_valid)
    _close(port[:2], ref[:2])
    for k in tpool:
        _close(tpool[k], jpool[k])
    for k in STATE:
        assert np.array_equal(tpool[k][:, 1], pool[k][:, 1])
    # stale state of row 2 dropped: a zero-state run gives the same bits
    clean = {k: v.copy() for k, v in pool.items()}
    for k in STATE:
        clean[k][:, 2] = 0
    port2, _, tpool2, _ = _run_paged(bundle, clean, "chunk", tok, ctab,
                                     rows, pos0, n_valid)
    assert np.array_equal(port2[0], port[0])
    for k in STATE:
        assert np.array_equal(tpool2[k][:, 2], tpool[k][:, 2])


def test_paged_decode_matches_reference(bundle):
    """Full-width paged decode: live rows against the reference, a parked
    row keeps its state (and writes no page) byte for byte."""
    cfg = bundle[2].cfg
    pool = _paged_pool(cfg, seed=20)
    tables = _tables()
    tok = _tokens(cfg, (NUM_ROWS, 1), seed=21)
    positions = np.array([13, PARK, 19], np.int32)
    port, ref, tpool, jpool = _run_paged(bundle, pool, "decode", tok,
                                         positions, tables)
    _close(port[[0, 2]], ref[[0, 2]])
    for k in tpool:
        _close(tpool[k], jpool[k])
    for k in STATE:
        assert np.array_equal(tpool[k][:, 1], pool[k][:, 1])


def test_paged_steps_take_rows_from_a_list(bundle):
    """``rows`` may be a host sequence: the same result as a tensor."""
    jmodel, jparams, model, params = bundle
    cfg = model.cfg
    pool = _paged_pool(cfg, seed=30)
    tables = _tables()
    tok = torch.as_tensor(_tokens(cfg, (2, 8), seed=31))
    outs = []
    for rows in ([1, 0], torch.tensor([1, 0])):
        tpool = {k: torch.as_tensor(v.copy()) for k, v in pool.items()}
        outs.append(model.prefill_chunk_paged(
            params, tpool, tok, torch.as_tensor(tables[[1, 0]]), rows,
            torch.tensor([0, 0]), torch.tensor([8, 8])))
    assert torch.equal(outs[0], outs[1])


# ---------------------------------------------------------------------------
# engines: greedy token identity with the same admissions
# ---------------------------------------------------------------------------

def _prompt(cfg, B=3, S=24, seed=0):
    batch = make_synthetic_batch(cfg, B, S, seed=seed,
                                 compute_dtype="float32")
    return {"tokens": np.asarray(batch["tokens"], np.int32)}


@pytest.mark.parametrize("engine", ["static", "paged", "slot",
                                    "slot-monolithic"])
def test_engine_token_identical_to_reference(bundle, engine):
    """``test_family_parity.py``'s prompt (B=3, S=24, 6 tokens): the port's
    engine against the reference's same engine, and against the
    reference's static baseline; the SSM scans run once per layer per
    chunk or prefill. The monolithic slot engine inserts each prefilled
    row's state into its slot."""
    jmodel, jparams, model, params = bundle
    prompt = _prompt(jmodel.cfg)
    static = JaxStatic(jmodel, jparams, cache_len=32).generate(prompt, 6)
    ssd_ops.reset_counters()
    transformer.reset_counters()
    if engine == "static":
        out = StaticEngine(model, params, cache_len=32,
                           device="cpu").generate(prompt, 6)
        ref = static
    else:
        mono = engine == "slot-monolithic"
        kw = dict(cache_len=32, num_slots=4, prefill_chunk=0 if mono else 16,
                  kv_layout=engine.split("-")[0], block_size=8)
        eng = ContinuousEngine(model, params, device="cpu", **kw)
        out = eng.generate(prompt, 6)
        ref = JaxEngine(jmodel, jparams, **kw).generate(prompt, 6)
        assert eng.prefill_chunk == kw["prefill_chunk"]
    assert np.array_equal(np.asarray(out), np.asarray(ref))
    assert np.array_equal(np.asarray(out), np.asarray(static))
    L = model.cfg.num_layers
    calls = transformer.prefill_calls + transformer.chunk_calls
    assert calls == {"static": 1, "slot-monolithic": 3}.get(engine, 3 * 2)
    assert ssd_ops.counters() == {"ssd_launches": 0, "ref_calls": L * calls}


def test_carried_state_bytes_match_reference(bundle):
    jmodel, jparams, model, params = bundle
    for layout in ("slot", "paged"):
        kw = dict(cache_len=32, num_slots=3, prefill_chunk=16,
                  kv_layout=layout, block_size=8)
        ours = ContinuousEngine(model, params, device="cpu", **kw)
        theirs = JaxEngine(jmodel, jparams, **kw)
        assert ours._carried_state_bytes() == theirs._carried_state_bytes()
        assert ours.scheduler.state_bytes == theirs.scheduler.state_bytes > 0


def test_run_family_rows_matches_reference():
    """A tiny ``--config`` run on both sides: the capability flags, the
    chunk and the state bytes equal the reference's, every family's
    tokens equal its static baseline, and olmoe (ported now) gives a
    served row, no skipped one. On the CPU each chunk forward and each
    prefill runs the plain scan once per layer."""
    from repro.launch.serve import run_family_rows as jax_rows
    from repro_torch.launch.serve import run_family_rows
    archs = ("mamba2-370m", "hymba-1.5b")
    ref = jax_rows(archs, smoke=True)
    rows = run_family_rows(archs + ("olmoe-1b-7b",), smoke=True,
                           device="cpu")
    assert "skipped" not in rows[2] and rows[2]["block"] == "moe"
    assert rows[2]["static_tok_identical"] and rows[2]["n"] == 6.0
    for arch, row, jrow in zip(archs, rows, ref):
        for key in ("family", "block", "chunked_prefill", "paged_decode",
                    "carried_state", "prefix_cache", "kv_migration",
                    "speculative", "prefill_chunk", "static_tok_identical",
                    "state_bytes_per_slot"):
            assert row[key] == jrow[key], key
        assert row["static_tok_identical"] and row["n"] == 6.0
        k = row["kernels"]
        L = get_smoke_config(arch).num_layers
        assert k["prefill_calls"] == 1 and k["chunk_calls"] > 0
        assert k["ssd_ref_calls"] == L * (k["prefill_calls"]
                                          + k["chunk_calls"])
        assert k["ssd_launches"] == 0


def test_run_family_rows_dtype():
    """``dtype`` sets a row's parameter and compute dtype (float32 at the
    smoke configs by default): hymba's smoke row in bfloat16 still serves
    every request and reports its share of tokens equal to the static
    baseline."""
    from repro_torch.launch.serve import run_family_rows
    (f32,) = run_family_rows(("hymba-1.5b",), smoke=True, device="cpu")
    (bf16,) = run_family_rows(("hymba-1.5b",), smoke=True, device="cpu",
                              dtype="bfloat16")
    assert f32["dtype"] == "float32" and f32["static_tok_identical"]
    assert bf16["dtype"] == "bfloat16" and bf16["n"] == 6.0
    assert 0.0 <= bf16["static_equal_token_share"] <= 1.0
    assert bf16["state_bytes_per_slot"] < f32["state_bytes_per_slot"]
