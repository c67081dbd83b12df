"""Port encoder-decoder family (whisper-tiny) vs the JAX reference, on its
smoke config in float32 on the CPU.

Both sides run the reference's parameters (LayerNorm weights and biases
redrawn off their unit / zero init so they act); frames and tokens are
made by numpy from a seed. Held to 1e-5 (the frameworks sum in different
orders): ``layernorm`` and ``sinusoidal_pos`` (2e-4 at whisper's 1500
rows, where float32 angles reach 1500 rad); the encoder; the static
prefill (logits, the decoder's self-attention cache and every layer's
cross K/V) and slot decode; the encoder pre-chunk into request rows (an
out-of-range row writes nothing); the paged decoder chunk (rows gathered
from the carried cross K/V) and decode. The engines — static, slot
monolithic and paged with the pre-chunk at admission — emit the
reference's greedy tokens with the same admissions and block tables, the
slot chunk raises the reference's message, and the carried state is
priced as the reference prices it. ``run_traffic`` and ``run_family_rows``
(all five families) agree with the reference's.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro.serve import ContinuousEngine as JaxEngine
from repro.serve import StaticEngine as JaxStatic
from repro_torch.models import encdec
from repro_torch.models import layers as L
from repro_torch.serve import ContinuousEngine, StaticEngine

ARCH = "whisper-tiny"


@functools.lru_cache(maxsize=None)
def _bundle():
    return tp.bundle(ARCH, perturbed=("w", "b"))


@pytest.fixture
def bundle():
    return _bundle()


@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 384)])
def test_layernorm_matches_reference(shape):
    rng = np.random.default_rng(len(shape))
    x = (3 * rng.standard_normal(shape) + 1).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    tp.close(L.layernorm(torch.as_tensor(x), torch.as_tensor(w),
                         torch.as_tensor(b), eps=1e-5),
             JL.layernorm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                          eps=1e-5))


@pytest.mark.parametrize("seq,d,tol", [(32, 64, 1e-5), (1500, 384, 2e-4)])
def test_sinusoidal_pos_matches_reference(seq, d, tol):
    """Both tables are float32 throughout; at whisper-tiny's 1500 rows the
    angles reach 1500 rad, where one ulp of difference between the two
    frameworks' ``exp`` of a frequency moves an angle, and so its sine, by
    up to ~1.2e-4: the full-width table is held to 2e-4, the smoke one to
    1e-5."""
    tp.close(L.sinusoidal_pos(seq, d), JL.sinusoidal_pos(seq, d), tol=tol)


def test_encode_matches_reference(bundle):
    from repro.models import encdec as jencdec
    jmodel, jparams, model, params = bundle
    frames = tp.prompt(model.cfg, 2, 1, seed=1)["frames"]
    ours = encdec.encode(model.cfg, params, torch.as_tensor(frames),
                         compute_dtype=torch.float32, serve=tp.F32)
    theirs = jencdec.encode(jmodel.cfg, jparams, jnp.asarray(frames),
                            jmodel.knobs)
    tp.close(ours, theirs)


def test_prefill_and_slot_decode_match_reference(bundle):
    """The static prefill's logits and whole cache (cross K/V included);
    then slot decode at per-row positions, a parked row writing nothing,
    against the reference's step on the live row."""
    jmodel, jparams, model, params = bundle
    batch = tp.prompt(model.cfg, 2, 11, seed=2)
    logits, cache = model.prefill(params, torch.as_tensor(batch["tokens"]),
                                  24, frames=torch.as_tensor(
                                      batch["frames"]))
    jl, jc = jmodel.prefill(jparams, tp.jbatch(batch), 24)
    tp.close(logits, jl)
    tp.check_slot_cache(cache, jc)
    before = {k: v.clone() for k, v in cache.items()}
    nxt = tp.tokens(model.cfg, (2, 1), seed=3)
    logits = model.decode_step(params, cache, torch.as_tensor(nxt),
                               torch.tensor([11, tp.PARK]))
    row0 = {k: (v if k == "pos" else v[:, :1]) for k, v in jc.items()}
    jl, jrow = jmodel.decode_step(jparams, row0, jnp.asarray(nxt[:1]),
                                  jnp.int32(11))
    tp.close(logits[:1], jl)
    tp.check_slot_cache(cache, jrow, rows=[0])
    for k in ("k", "v"):
        assert torch.equal(cache[k][:, 1, :-1], before[k][:, 1, :-1])
    for k in ("pos", "cross_k", "cross_v"):
        assert torch.equal(cache[k], before[k]) if k != "pos" else \
            torch.equal(cache[k][1], before[k][1])


def _cross_pool(cfg, rows, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, rows, cfg.encoder_seq, cfg.num_kv_heads,
             cfg.head_dim)
    return {k: rng.standard_normal(shape, dtype=np.float32)
            for k in ("cross_k", "cross_v")}


def test_encode_prechunk_matches_reference(bundle):
    """Two requests' frames into rows 2 and 3 of a 3-row pool (row 3 is
    out of range: it writes nothing): rows 0-1 keep their stale cross K/V
    byte for byte, row 2 holds the reference's."""
    jmodel, jparams, model, params = bundle
    cfg = model.cfg
    pool = _cross_pool(cfg, 3, seed=4)
    shape = (cfg.num_layers, 4, 4, cfg.num_kv_heads, cfg.head_dim)
    pool.update(k=np.zeros(shape, np.float32), v=np.zeros(shape, np.float32))
    frames = tp.prompt(cfg, 2, 1, seed=5)["frames"]
    tpool = {k: torch.as_tensor(v.copy()) for k, v in pool.items()}
    model.encode_prechunk(params, tpool, torch.as_tensor(frames), [2, 3])
    jpool = jmodel.encode_prechunk(jparams, {k: jnp.asarray(v) for k, v in
                                             pool.items()},
                                   jnp.asarray(frames),
                                   jnp.asarray([2, 3], jnp.int32))
    for k in ("cross_k", "cross_v"):
        tp.close(tpool[k], jpool[k])
        assert np.array_equal(tpool[k][:, :2].numpy(), pool[k][:, :2])


def test_paged_chunk_and_decode_match_reference(bundle):
    """The decoder chunk (rows 2 and 0 gathered from the carried cross
    K/V, a padding row past the last row) and full-width decode with a
    parked row; the cross leaves are read-only."""
    cfg = bundle[2].cfg
    pool = _cross_pool(cfg, 3, seed=6)
    after_chunk, after_decode = tp.check_paged_steps(bundle, pool=pool)
    for k in ("cross_k", "cross_v"):
        assert np.array_equal(after_chunk[k], pool[k])
        assert np.array_equal(after_decode[k], pool[k])


@pytest.mark.parametrize("layout", ["paged", "slot-monolithic"])
def test_engines_step_by_step_match_reference(bundle, layout):
    """The reference's admissions, tables and tokens; on the paged layout
    each admission runs the encoder pre-chunk once."""
    encdec.reset_counters()
    tp.check_engine(bundle, layout)
    assert encdec.encode_calls == 6


def test_static_engine_and_capabilities_match_reference(bundle):
    """The static engine's tokens; a slot chunk raises the reference's
    message; the carried cross K/V is priced as the reference prices
    it."""
    jmodel, jparams, model, params = bundle
    batch = tp.prompt(model.cfg, 3, 13, seed=7)
    ref = JaxStatic(jmodel, jparams, cache_len=24).generate(
        tp.jbatch(batch), 6)
    out = StaticEngine(model, params, cache_len=24,
                       device="cpu").generate(batch, 6)
    assert np.array_equal(out, np.asarray(ref))
    with pytest.raises(ValueError) as ours:
        ContinuousEngine(model, params, cache_len=24, num_slots=2,
                         prefill_chunk=8, device="cpu")
    with pytest.raises(ValueError) as theirs:
        JaxEngine(jmodel, jparams, cache_len=24, num_slots=2,
                  prefill_chunk=8)
    assert str(ours.value) == str(theirs.value)
    assert "slot_chunk" in str(ours.value)
    for layout in ("slot", "paged"):
        kw = dict(cache_len=32, num_slots=3, prefill_chunk=8 if layout ==
                  "paged" else 0, kv_layout=layout, block_size=8)
        a = ContinuousEngine(model, params, device="cpu", **kw)
        b = JaxEngine(jmodel, jparams, **kw)
        assert a._carried_state_bytes() == b._carried_state_bytes() > 0
        assert a.scheduler.state_bytes == b.scheduler.state_bytes


def _patch_prompts(monkeypatch, arch):
    """Both launchers draw the same prompts and frontend inputs: the
    port's sources patched to the reference's ``make_synthetic_batch``."""
    from repro.models.registry import make_synthetic_batch
    from repro_torch.launch import serve as launch
    jcfg = jax_smoke_config(arch)

    def batch(b, s, seed):
        return make_synthetic_batch(jcfg, b, s, seed=seed,
                                    compute_dtype="float32")

    monkeypatch.setattr(launch, "synthetic_tokens", lambda cfg, b, s, seed:
                        np.asarray(batch(b, s, seed)["tokens"], np.int32))
    monkeypatch.setattr(launch, "frontend_arrays", lambda cfg, b, seed: {
        k: np.asarray(v, np.float32) for k, v in batch(b, 1, seed).items()
        if k in ("frames", "patch_embeds")})


def test_run_traffic_matches_reference(monkeypatch):
    """whisper-smoke through both launchers (the slot arm monolithic, the
    paged arm chunked after the pre-chunk, the static arm and the parity
    batch), same prompts, frames and parameters: every arm's tokens and
    every identity flag equal the reference's."""
    import repro.launch.serve as jlaunch
    from repro_torch.launch import serve as launch
    _patch_prompts(monkeypatch, ARCH)
    seen = []

    def rec(fn):
        def wrapped(eng, reqs, *a, **kw):
            out = fn(eng, reqs, *a, **kw)
            seen.append([r.output[:r.generated].tolist() for r in reqs])
            return out
        return wrapped

    monkeypatch.setattr(jlaunch, "drive_continuous",
                        rec(jlaunch.drive_continuous))
    monkeypatch.setattr(jlaunch, "drive_static", rec(jlaunch.drive_static))
    kw = dict(smoke=True, requests=4, slots=2, prompt_len=(9, 20),
              max_new=(3, 6), rate=400.0, seed=0, prefill_chunk=8,
              block_size=4)
    ref = jlaunch.run_traffic(ARCH, prefix_compare=False,
                              spec_compare=False, **kw)
    res = launch.run_traffic(ARCH, device="cpu",
                             params=tp.bundle(ARCH)[3], prefix_compare=False,
                             spec_compare=False, **kw)
    arms = res["outputs_by_arm"]
    assert [arms["continuous"], arms["continuous_paged"],
            arms["static"]] == seen
    assert "continuous_monolithic" not in res and res["prefill_chunk"] == 0
    for key in ("parity_token_identical", "parity_token_identical_paged",
                "paged_token_identical_trace", "cache_len"):
        assert res[key] == ref[key], key
    assert res["parity_token_identical_paged"]
    assert res["kernels"]["encode_calls"] > 0


def test_run_family_rows_match_reference(monkeypatch):
    """The five ``--config`` families on both sides, the same prompts (and
    frames): every row is served (none skipped), with the reference's
    capability flags, chunk and state bytes, token-identical to its
    static baseline."""
    import repro.launch.serve as jlaunch
    from repro_torch.launch import serve as launch
    rows = launch.run_family_rows(device="cpu")
    ref = jlaunch.run_family_rows()
    assert [r["family"] for r in rows] == [r["family"] for r in ref]
    for row, jrow in zip(rows, ref):
        assert "skipped" not in row and "skipped" not in jrow
        for key in ("block", "chunked_prefill", "paged_decode",
                    "carried_state", "prefix_cache", "kv_migration",
                    "speculative", "prefill_chunk", "static_tok_identical",
                    "state_bytes_per_slot"):
            assert row[key] == jrow[key], (row["family"], key)
        assert row["static_tok_identical"] and row["n"] == 6.0
    assert rows[-1]["kernels"]["encode_calls"] == 6 + 1
