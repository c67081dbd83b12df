"""Port speculative decoding vs the JAX reference, on the gemma-2b smoke
config in float32 on the CPU.

* ``verify_step_paged`` (K teacher-forced queries through block tables)
  against the reference's ``make_verify_step_paged``: logits of every
  valid query and the written pool entries within 1e-5 (the frameworks
  sum in different orders), entries no valid query writes byte-identical.
* ``ContinuousEngine(speculate=k)`` at k = 1, 2, 3, with the target
  drafting for itself and with a drafter of seed 1, driven step by step
  through one Poisson trace beside the reference's engine: the same block
  tables after every step, greedy tokens identical to the reference's and
  to the port's plain paged engine, and ``spec_stats()`` equal.
* The budget clamp, EOS, block recycling, the drafter pool's lockstep,
  the capability and composition raises, and the protocol prices.
* The multi-query paged attention at the verify and resync shapes (K = 4
  and 2; padded, parked and past-lease rows; gemma's and hymba's heads):
  the kernels' split arithmetic (``ref.paged_attention_split_ref``)
  against the plain version and the reference's oracle on the CPU, and
  the CUDA kernel against both on the card (``cuda``: skips without one).

Parameters move from the reference through ``interop.params_from_numpy``;
pools, tables and tokens are made by numpy from a seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.config import ServeConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core import protocol
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref, paged_attention_split_ref)
from repro_torch.models import transformer as T
from repro_torch.models.registry import build_model
from repro_torch.serve import ContinuousEngine, ServeRequest, make_trace
from repro_torch.serve.engine import PARK_POS

TOL = 1e-5
F32 = ServeConfig(param_dtype="float32", compute_dtype="float32")
ENGINE_KW = dict(cache_len=36, num_slots=3, prefill_chunk=8, block_size=4,
                 num_blocks=20, max_prefill_per_step=2, kv_layout="paged")


@pytest.fixture(scope="module")
def models():
    from repro.config import ServeConfig as JServeConfig
    from repro.config import TrainConfig
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models.registry import build_model as jax_build_model
    train = TrainConfig(param_dtype="float32", compute_dtype="float32",
                        loss_chunk=16, attn_chunk_threshold=64,
                        attn_chunk=16, remat=False)
    jmodel = jax_build_model(jax_smoke_config("gemma-2b"), train,
                             JServeConfig(), tp=1)
    cfg = get_smoke_config("gemma-2b")
    model = build_model(cfg, F32, device="cpu")
    out = {"jmodel": jmodel, "model": model}
    for seed in (0, 1):
        jp = jmodel.init(jax.random.PRNGKey(seed))
        out[f"jparams{seed}"] = jp
        out[f"params{seed}"] = params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jp), cfg)
    return out


# ---------------------------------------------------------------------------
# verify_step_paged
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [2, 4])
def test_verify_step_matches_reference(models, K):
    """Rows with 1..K valid queries, a parked row, an all -1 row, and a
    row whose lease ends before its last padding query."""
    jmodel, model = models["jmodel"], models["model"]
    cfg = model.cfg
    P, bs, NB, B = 24, 4, 6, 5
    rng = np.random.default_rng(K)
    shape = (cfg.num_layers, P, bs, cfg.num_kv_heads, cfg.head_dim)
    pool = {n: rng.standard_normal(shape, dtype=np.float32)
            for n in ("k", "v")}
    tables = np.full((B, NB), -1, np.int32)
    tables[0, :5] = [3, 7, 1, 12, 20]       # 20 tokens leased
    tables[1, :2] = [0, 5]                  # lease ends at 8: row 1's
    tables[2, :3] = [2, 9, 14]              # padding queries pass it
    tables[3, :4] = [4, 6, 8, 10]           # parked (mid-prefill) row
    positions = np.array([13, 6, 0, PARK_POS, PARK_POS], np.int32)
    n_valid = np.array([K, min(2, K), 1, K, 0], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, K)).astype(np.int32)
    tpool = {n: torch.as_tensor(v.copy()) for n, v in pool.items()}
    T.reset_counters()
    port = model.verify_step_paged(
        models["params0"], tpool, torch.as_tensor(tokens),
        torch.as_tensor(positions), torch.as_tensor(tables),
        torch.as_tensor(n_valid)).numpy()
    assert T.verify_calls == 1
    ref, jpool = jmodel.verify_step_paged(
        models["jparams0"], {n: jnp.asarray(v) for n, v in pool.items()},
        jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(tables),
        jnp.asarray(n_valid))
    ref = np.asarray(ref)
    assert port.shape == ref.shape == (B, K, cfg.padded_vocab)
    valid = (np.arange(K)[None] < n_valid[:, None]) & (positions >= 0)[:, None]
    np.testing.assert_allclose(port[valid], ref[valid], atol=TOL, rtol=TOL)
    assert (port[valid].argmax(-1) == ref[valid].argmax(-1)).all()
    keep = np.ones((P, bs), bool)
    for b, j in zip(*np.nonzero(valid)):
        q = positions[b] + j
        keep[tables[b, q // bs], q % bs] = False
    for n in ("k", "v"):
        got = tpool[n].numpy()
        assert np.array_equal(got[:, keep], pool[n][:, keep])
        np.testing.assert_allclose(got, np.asarray(jpool[n]), atol=TOL,
                                   rtol=TOL)


def test_verify_at_width_one_is_the_decode_step(models):
    """A one-query verify computes the decode step's logits and writes."""
    model, params = models["model"], models["params0"]
    cfg = model.cfg
    rng = np.random.default_rng(5)
    shape = (cfg.num_layers, 12, 4, cfg.num_kv_heads, cfg.head_dim)
    pool = {n: torch.as_tensor(rng.standard_normal(shape, dtype=np.float32))
            for n in ("k", "v")}
    tables = torch.tensor([[3, 7, 1, -1], [0, 5, -1, -1]], dtype=torch.int32)
    tok = torch.tensor([[11], [42]])
    pos = torch.tensor([9, PARK_POS])
    a = {n: v.clone() for n, v in pool.items()}
    b = {n: v.clone() for n, v in pool.items()}
    dec = model.decode_step_paged(params, a, tok, pos, tables)
    ver = model.verify_step_paged(params, b, tok, pos, tables,
                                  torch.tensor([1, 1]))
    torch.testing.assert_close(ver[0, 0], dec[0], atol=TOL, rtol=TOL)
    for n in ("k", "v"):
        torch.testing.assert_close(a[n], b[n], atol=0, rtol=0)


# ---------------------------------------------------------------------------
# the speculative engine against the reference's and the plain engine
# ---------------------------------------------------------------------------

def _trace(n=8):
    return make_trace(n, prompt_len=(5, 13), max_new=(1, 9), rate=400.0,
                      seed=3)


def _requests(cls, trace, vocab):
    out = []
    for rid, e in enumerate(trace):
        tok = np.random.default_rng(300 + rid).integers(
            0, vocab, size=(1, e.prompt_len)).astype(np.int32)
        out.append(cls(rid=rid, batch={"tokens": tok},
                       max_new_tokens=e.max_new, arrival=e.arrival))
    return out


def _drive(eng, reqs, steps_per_s=2000.0):
    """Deterministic replay: request i is submitted before the step whose
    index reaches its arrival; returns each step's block tables."""
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


@pytest.fixture(scope="module")
def plain_run(models):
    """The port's plain paged engine on the trace: the tokens every
    speculative run must reproduce."""
    reqs = _requests(ServeRequest, _trace(), models["model"].cfg.vocab_size)
    eng = ContinuousEngine(models["model"], models["params0"], device="cpu",
                           **ENGINE_KW)
    _drive(eng, reqs)
    return [r.output.copy() for r in reqs]


SPEC_CASES = [(k, d) for k in (1, 2, 3) for d in ("self", "seed1")]


@pytest.mark.parametrize("k,drafter", SPEC_CASES,
                         ids=[f"k{k}-{d}" for k, d in SPEC_CASES])
def test_spec_engine_matches_reference_and_plain(models, plain_run, k,
                                                 drafter):
    from repro.serve import ContinuousEngine as JaxEngine
    from repro.serve import ServeRequest as JaxRequest
    model, jmodel = models["model"], models["jmodel"]
    vocab = model.cfg.vocab_size
    dkw = {} if drafter == "self" else dict(draft_model=model,
                                            draft_params=models["params1"])
    jdkw = {} if drafter == "self" else dict(
        draft_model=jmodel, draft_params=models["jparams1"])
    treqs = _requests(ServeRequest, _trace(), vocab)
    jreqs = _requests(JaxRequest, _trace(), vocab)
    teng = ContinuousEngine(model, models["params0"], speculate=k,
                            device="cpu", **ENGINE_KW, **dkw)
    jeng = JaxEngine(jmodel, models["jparams0"], speculate=k, **ENGINE_KW,
                     **jdkw)
    T.reset_counters()
    ops.reset_counters()
    tlog = _drive(teng, treqs)
    jlog = _drive(jeng, jreqs)
    assert len(tlog) == len(jlog)
    for tt, jt in zip(tlog, jlog):
        assert np.array_equal(tt, jt)          # same block tables
    for t, j, want in zip(treqs, jreqs, plain_run):
        assert t.generated == j.generated == t.max_new_tokens
        assert np.array_equal(t.output, np.asarray(j.output))
        assert np.array_equal(t.output, want)
    ts, js = teng.spec_stats(), jeng.spec_stats()
    assert ts.keys() == js.keys()
    for key in ts:
        assert ts[key] == pytest.approx(js[key], rel=1e-12), key
    assert teng.decode_tokens_per_dispatch == pytest.approx(
        jeng.decode_tokens_per_dispatch)
    if drafter == "self" and k > 1:
        assert ts["accepted_per_dispatch"] > 1.0
    # every round: one resync and one verify forward, k - 1 drafter
    # decode steps; one attention call a layer each, plus the chunks
    L = model.cfg.num_layers
    assert T.verify_calls == 2 * teng.spec_rounds
    assert ops.ref_calls == L * (T.chunk_calls + T.verify_calls
                                 + (k - 1) * teng.spec_rounds)
    # both pools drained in lockstep
    assert teng.kv.pool.num_free == teng.draft_kv.pool.num_free \
        == teng.kv.pool.num_blocks


def test_budget_clamp_eos_and_block_recycling(models):
    """One-token and two-token budgets (the round degenerates to a
    width-1 verify), an EOS inside an accepted run (truncated there, the
    row freed), and a pool too small for the trace at once (blocks and
    rows recycle): the tokens equal the plain engine's, and both pools
    drain."""
    model, params = models["model"], models["params0"]
    vocab = model.cfg.vocab_size
    prompts = np.random.default_rng(9).integers(0, vocab, size=(6, 7))
    news = [1, 2, 9, 9, 5, 9]
    kw = dict(ENGINE_KW, num_blocks=12, num_slots=2)

    def run(speculate, eos):
        eng = ContinuousEngine(model, params, eos_id=eos,
                               speculate=speculate, device="cpu", **kw)
        reqs = [ServeRequest(rid=i, batch={"tokens": prompts[i:i + 1]
                                           .astype(np.int32)},
                             max_new_tokens=n) for i, n in enumerate(news)]
        for r in reqs:
            eng.submit(r)
        steps = 0
        while not eng.idle:
            eng.step(0.0)
            steps += 1
            assert steps < 500
        return eng, [r.output[:r.generated].tolist() for r in reqs]

    _, plain = run(0, -1)
    eos = plain[2][4]                  # a token inside request 2's stream
    for e in (-1, eos):
        eng, spec = run(3, e)
        assert spec == run(0, e)[1]
        assert eng.kv.pool.num_free == eng.kv.pool.num_blocks
        assert eng.draft_kv.pool.num_free == eng.draft_kv.pool.num_blocks
        assert (eng._draft_len == 0).all()
    assert [len(o) for o in plain] == news
    assert len(spec[2]) == plain[2].index(eos) + 1


def test_capability_and_composition_raises(models):
    model, params = models["model"], models["params0"]
    kw = dict(cache_len=16, num_slots=1, device="cpu")
    with pytest.raises(ValueError, match="kv_layout='paged'"):
        ContinuousEngine(model, params, speculate=2, **kw)
    with pytest.raises(ValueError, match="does not compose"):
        ContinuousEngine(model, params, speculate=2, prefix_cache=True,
                         kv_layout="paged", **kw)
    with pytest.raises(ValueError, match="speculate must be >= 0"):
        ContinuousEngine(model, params, speculate=-1, kv_layout="paged",
                         **kw)
    with pytest.raises(ValueError, match="draft_params"):
        ContinuousEngine(model, params, speculate=2, kv_layout="paged",
                         draft_model=model, **kw)
    other = build_model(dataclasses.replace(model.cfg, vocab_size=200), F32,
                        device="cpu")
    with pytest.raises(ValueError, match="drafter vocab"):
        ContinuousEngine(model, params, speculate=2, kv_layout="paged",
                         draft_model=other, draft_params=params, **kw)
    for arch in ("mamba2-370m", "hymba-1.5b"):
        fam = build_model(get_smoke_config(arch), F32, device="cpu")
        assert fam.verify_step_paged is None
        with pytest.raises(ValueError, match="capability 'speculative'"):
            ContinuousEngine(fam, fam.init(0), speculate=2,
                             kv_layout="paged", **kw)
        if fam.cfg.vocab_size == model.cfg.vocab_size:
            with pytest.raises(ValueError, match="draft model lacks"):
                ContinuousEngine(model, params, speculate=2,
                                 kv_layout="paged", draft_model=fam,
                                 draft_params=fam.init(0), **kw)
    eng = ContinuousEngine(model, params, speculate=2, kv_layout="paged",
                           **kw)
    req = ServeRequest(rid=0, batch={"tokens": np.zeros((1, 4), np.int32)},
                       max_new_tokens=3, temperature=0.5)
    with pytest.raises(ValueError, match="temperature must be 0"):
        eng.submit(req)


def test_run_traffic_spec_arm(models):
    """``run_traffic(spec_compare=True)`` on the CPU: the speculative arm
    is token-identical to the plain paged arm, accepts more than one
    token a dispatch, and its launch counts follow the round's shape."""
    from repro_torch.launch import serve as launch
    res = launch.run_traffic(
        "gemma-2b", device="cpu", params=models["params0"],
        engine="continuous", requests=5, slots=2, prompt_len=(9, 20),
        max_new=(3, 10), rate=400.0, chunk_compare=False, parity_check=False,
        prefill_chunk=8, block_size=4, prefix_compare=False,
        spec_compare=True, speculate=3)
    assert res["spec_token_identical_trace"]
    assert res["spec_baseline_arm"] == "continuous_paged"
    assert res["spec_accepted_per_dispatch"] > 1.0
    sp = res["continuous_spec"]
    c, L, k = sp["kernels"], models["model"].cfg.num_layers, 3
    assert c["verify_calls"] == 2 * sp["spec_rounds"]
    assert c["ref_calls"] == L * (c["chunk_calls"] + c["verify_calls"]
                                  + (k - 1) * sp["spec_rounds"])
    # launches by query width count only the card's kernel launches
    assert sp["mq_launches_by_k"] == {}
    # yi-smoke (vocab 256, as gemma-smoke's) drafts for gemma-smoke: a
    # separate drafter keeps the greedy tokens; its acceptance is its own
    other = launch.run_traffic(
        "gemma-2b", device="cpu", engine="continuous", requests=3, slots=2,
        prompt_len=(9, 20), max_new=(3, 8), rate=400.0, chunk_compare=False,
        parity_check=False, prefill_chunk=8, block_size=4,
        prefix_compare=False, spec_compare=True, speculate=2,
        draft_arch="yi-9b")
    assert other["draft_arch"] == "yi-9b"
    assert other["spec_token_identical_trace"]
    sp = other["continuous_spec"]
    assert sp["kernels"]["verify_calls"] == 2 * sp["spec_rounds"]


# ---------------------------------------------------------------------------
# protocol prices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bw", [12e9, 3e9])
def test_protocol_prices_match_reference(bw):
    from repro.core import protocol as jprotocol
    tm, jm = protocol.HostModel(bw_copy=bw), jprotocol.HostModel(bw_copy=bw)
    for k in range(1, 9):
        for tb in (2, 4, 8):
            assert protocol.speculative_verify_latency(k, tb, tm) \
                == jprotocol.speculative_verify_latency(k, tb, jm)
    for nbytes in (0, 1, 63, 64, 4096, 65536, 1 << 20):
        for bb in (16, 64, 4096):
            for cow in (0, 1, 3):
                assert protocol.prefix_hit_latency(nbytes, bb, tm, cow) \
                    == jprotocol.prefix_hit_latency(nbytes, bb, jm, cow)
    with pytest.raises(ValueError):
        protocol.speculative_verify_latency(0)
    with pytest.raises(ValueError):
        protocol.prefix_hit_latency(64, 0)


# ---------------------------------------------------------------------------
# the multi-query kernel at the verify and resync shapes
# ---------------------------------------------------------------------------

#: (tag, H, Hkv, hd, window, NB, positions): gemma-2b's and hymba-1.5b's
#: heads; mirrors chip_smoke.py's verify_specs
VERIFY_SHAPES = [
    ("gemma", 8, 1, 256, 0, 32, [17, 100, PARK_POS, 255, 300, 510, 0, 200]),
    ("hymba", 25, 5, 64, 2048, 164,
     [17, 100, PARK_POS, 2047, 2100, 2600, 0, 2300]),
]


def verify_inputs(H, Hkv, hd, NB, positions, K, bs=16, seed=0):
    """A verify (K = k + 1) or resync (K = 2) batch: row b's queries at
    ``positions[b] + j``, so ``lengths = positions + K``; each row leases
    only the tokens its valid queries write (``n_valid`` = K, 1, .., so
    padding queries reach past the lease, into -1 entries), one row is
    parked, and row 5 (gemma) reaches past the table's width."""
    rng = np.random.default_rng(seed + K)
    B = len(positions)
    pos = np.asarray(positions, np.int64)
    n_valid = np.array([K, 1, 0, K, min(2, K), 2, 1, K - 1])
    leases = [0 if p < 0 else min(NB, -(-(p + n) // bs))
              for p, n in zip(pos, n_valid)]
    P = sum(leases) + 8
    perm = rng.permutation(P)
    tables = np.full((B, NB), -1, np.int32)
    used = 0
    for b, n in enumerate(leases):
        tables[b, :n] = perm[used:used + n]
        used += n
    tables[2, :3] = perm[used:used + 3]          # the parked row's lease
    kp = rng.standard_normal((P, bs, Hkv, hd), dtype=np.float32)
    vp = rng.standard_normal((P, bs, Hkv, hd), dtype=np.float32)
    q = rng.standard_normal((B, K, H, hd), dtype=np.float32)
    lengths = (pos + K).astype(np.int32)
    live = [b for b in range(B) if pos[b] >= 0]
    return (q, kp, vp, tables, lengths), live


VERIFY_CASES = [(s, K) for s in VERIFY_SHAPES for K in (2, 4)]
VERIFY_IDS = [f"{s[0]}-K{K}" for s, K in VERIFY_CASES]


@pytest.mark.parametrize("shape,K", VERIFY_CASES, ids=VERIFY_IDS)
def test_verify_shapes_split_emulation_matches_oracles(shape, K):
    """The kernels' split-and-combine arithmetic at the verify shapes
    against the plain version and the reference's oracle (float32): every
    query of every live row, padding queries past the lease included."""
    from repro.kernels.paged_attention.ref import paged_attention_ref as jref
    _, H, Hkv, hd, window, NB, positions = shape
    args, live = verify_inputs(H, Hkv, hd, NB, positions, K)
    t = [torch.as_tensor(a) for a in args]
    plain = paged_attention_ref(*t, window=window)
    port = ops.paged_attention(*t, window=window)
    pl = ops.plan(len(positions), K, H, Hkv, 16, NB)
    split = paged_attention_split_ref(*t, plan=pl,
                                      tile_tokens=ops.TILE_TOKENS,
                                      window=window)
    oracle = np.asarray(jref(*[jnp.asarray(a) for a in args],
                             window=window))
    assert torch.equal(port, plain)
    for got in (split.numpy(), plain.numpy()):
        np.testing.assert_allclose(got[live], oracle[live], atol=2e-5,
                                   rtol=2e-5)
    # the parked row sees nothing and walks no table entry
    assert (split[2] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("shape,K", VERIFY_CASES, ids=VERIFY_IDS)
def test_cuda_verify_shapes(shape, K, dtype, tol):
    """The multi-query kernel at the verify and resync shapes against
    the plain version and the split emulation, twice, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    _, H, Hkv, hd, window, NB, positions = shape
    args, live = verify_inputs(H, Hkv, hd, NB, positions, K)
    dev = torch.device("cuda")
    q, kp, vp, tables, lengths = [torch.as_tensor(a).to(dev) for a in args]
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    before, before_k = ops.mq_launches, ops.mq_launches_by_k.get(K, 0)
    out = ops.launch(q, kp, vp, tables, lengths, window=window)
    again = ops.launch(q, kp, vp, tables, lengths, window=window)
    assert ops.mq_launches == before + 2
    assert ops.mq_launches_by_k[K] == before_k + 2
    ref = paged_attention_ref(q, kp, vp, tables, lengths, window=window)
    split = paged_attention_split_ref(
        q, kp, vp, tables, lengths,
        plan=ops.plan(len(positions), K, H, Hkv, 16, NB),
        tile_tokens=ops.TILE_TOKENS, window=window)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert torch.isfinite(out.float()).all()
    for want in (ref, split):
        torch.testing.assert_close(out[live].float(), want[live].float(),
                                   atol=tol, rtol=tol)
    # the parked row writes zeros
    assert (out[2] == 0).all()
