"""Port dense configs (yi-9b, qwen3-14b with its per-head q/k norm,
qwen2.5-14b with its q/k/v biases) and internvl2-76b's patch_stub
frontend vs the JAX reference, on their smoke configs in float32 on the
CPU.

Both sides run the reference's parameters (the q/k/v biases and q/k norm
weights redrawn off their zero / unit init so they act); inputs are made
by numpy from a seed. Logits and cache entries are held to 1e-5 (the
frameworks sum in different orders): ``project_qkv`` with biases, q/k
norm and cross-attention inputs; the monolithic prefill (internvl2's with
its patch embeddings prepended); slot decode and slot chunks; paged
chunks and decode. The engines emit the reference's greedy tokens with
the same admissions and block tables, step by step. The registry: every
architecture's config and capabilities equal the reference's, and every
published config builds. A yi-smoke drafter for a qwen3-smoke target
(both of vocabulary 256) is held to the reference's ``run_traffic``.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.configs import ARCH_NAMES as JAX_ARCH_NAMES
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro.models.registry import derive_capabilities as jax_caps
from repro.serve import ContinuousEngine as JaxEngine
from repro.serve import StaticEngine as JaxStatic
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.models import layers as L
from repro_torch.models.registry import build_model, derive_capabilities
from repro_torch.serve import ContinuousEngine, StaticEngine

DENSE = ["yi-9b", "qwen3-14b", "qwen2.5-14b"]
PERTURBED = ("bq", "bk", "bv", "q_norm", "k_norm")


@functools.lru_cache(maxsize=None)
def _bundle(arch):
    return tp.bundle(arch, perturbed=PERTURBED)


@pytest.fixture(params=DENSE + ["internvl2-76b"])
def bundle(request):
    """Every config of this file; internvl2 has no slot chunk or paged
    path (its capabilities), so the tests of those take ``dense``."""
    return _bundle(request.param)


@pytest.fixture(params=DENSE)
def dense(request):
    return _bundle(request.param)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", JAX_ARCH_NAMES)
def test_configs_and_capabilities_equal_reference(arch):
    """Field by field, smoke and published; ``reason`` verbatim; the
    published config builds, with exactly the paths its capabilities
    allow (no parameter is drawn)."""
    assert ARCH_NAMES == JAX_ARCH_NAMES
    for ours, theirs in ((get_config(arch), jax_get_config(arch)),
                         (get_smoke_config(arch), jax_smoke_config(arch))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert derive_capabilities(ours)._asdict() == \
            jax_caps(theirs)._asdict()
    model = build_model(get_config(arch), tp.F32, device="cpu")
    caps = model.capabilities
    assert (model.prefill_chunk is not None) == caps.slot_chunk
    assert (model.decode_step_paged is not None) == caps.paged_decode
    assert (model.verify_step_paged is not None) == (
        caps.paged_decode and caps.speculative)
    assert (model.clone_paged_block is not None) == (
        caps.paged_decode and caps.prefix_cache)
    assert (model.encode_prechunk is not None) == caps.encoder_prechunk


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qkv_bias,qk_norm", [(True, False), (False, True),
                                              (True, True)])
def test_project_qkv_bias_norm_and_cross(qkv_bias, qk_norm):
    """Biases, then the per-head RMS norm (eps 1e-6), then RoPE — against
    the reference's, also with keys and values from another sequence at
    their own positions, and without RoPE."""
    cfg = dataclasses.replace(get_smoke_config("qwen3-14b"),
                              qkv_bias=qkv_bias, qk_norm=qk_norm)
    rng = np.random.default_rng(3)
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    p = {"wq": rng.standard_normal((d, h, hd)) * d ** -0.5,
         "wk": rng.standard_normal((d, hkv, hd)) * d ** -0.5,
         "wv": rng.standard_normal((d, hkv, hd)) * d ** -0.5,
         "bq": rng.standard_normal((h, hd)), "bk": rng.standard_normal(
             (hkv, hd)), "bv": rng.standard_normal((hkv, hd)),
         "q_norm": 1 + 0.3 * rng.standard_normal(hd),
         "k_norm": 1 + 0.3 * rng.standard_normal(hd)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    xkv = rng.standard_normal((2, 7, d)).astype(np.float32)
    pos, kvpos = np.arange(3, 8), np.arange(7)
    tpar = {k: torch.as_tensor(v) for k, v in p.items()}
    jpar = {k: jnp.asarray(v) for k, v in p.items()}
    for kw in (dict(), dict(x_kv=xkv, kv_positions=kvpos),
               dict(x_kv=xkv, use_rope=False)):
        ours = L.project_qkv(tpar, torch.as_tensor(x), cfg,
                             torch.as_tensor(pos),
                             **{k: torch.as_tensor(v) if k != "use_rope"
                                else v for k, v in kw.items()})
        theirs = JL.project_qkv(jpar, jnp.asarray(x), cfg, jnp.asarray(pos),
                                **{k: jnp.asarray(v) if k != "use_rope"
                                   else v for k, v in kw.items()})
        for a, b in zip(ours, theirs):
            tp.close(a, b)


# ---------------------------------------------------------------------------
# monolithic prefill, slot decode and chunks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [11, 16])
def test_prefill_matches_reference(bundle, S):
    """Logits and the whole slot cache; internvl2's patch embeddings are
    prepended, so its cache holds num_frontend_tokens + S positions."""
    jmodel, jparams, model, params = bundle
    cfg = model.cfg
    batch = tp.prompt(cfg, 2, S, seed=S)
    inputs = {k: torch.as_tensor(v) for k, v in batch.items()
              if k != "tokens"}
    logits, cache = model.prefill(params, torch.as_tensor(batch["tokens"]),
                                  40, **inputs)
    jl, jc = jmodel.prefill(jparams, tp.jbatch(batch), 40)
    tp.close(logits, jl)
    tp.check_slot_cache(cache, jc)
    assert int((cache["pos"][0] >= 0).sum()) == S + cfg.num_frontend_tokens


def test_slot_decode_and_chunk_match_reference(dense):
    """Slot decode at per-row positions (a parked row writes nothing) and
    two slot chunks per row (a full one, then a partial one) against the
    reference's per-request steps."""
    tp.check_slot_steps(dense)


def test_paged_chunk_and_decode_match_reference(dense):
    """A chunk (rows 2 and 0, pos0 0 and 8, a padding row with an all -1
    table), then full-width decode with a parked row: logits of the live
    rows and the whole pool (padding and parked queries write nothing)."""
    tp.check_paged_steps(dense)


@pytest.mark.parametrize("layout", ["paged", "slot", "slot-monolithic"])
def test_engines_step_by_step_match_reference(dense, layout):
    """One Poisson trace through the port's and the reference's continuous
    engine, step by step: the same admissions, finishes and block tables
    after every step, the same greedy tokens."""
    tp.check_engine(dense, layout)


def test_internvl2_paths_match_reference():
    """internvl2: the static and slot-monolithic engines emit the
    reference's tokens (cache sized for the prepended patch tokens, so
    neither side wraps); the paths its capabilities forbid raise the
    reference's messages."""
    jmodel, jparams, model, params = tp.bundle("internvl2-76b")
    batch = tp.prompt(model.cfg, 3, 20, seed=5)
    cache_len = 20 + model.cfg.num_frontend_tokens + 6
    ref = JaxStatic(jmodel, jparams, cache_len=cache_len).generate(
        tp.jbatch(batch), 6)
    out = StaticEngine(model, params, cache_len=cache_len,
                       device="cpu").generate(batch, 6)
    assert np.array_equal(out, np.asarray(ref))
    mono = ContinuousEngine(model, params, cache_len=cache_len, num_slots=2,
                            prefill_chunk=0, device="cpu").generate(batch, 6)
    assert np.array_equal(mono, out)
    for kw in (dict(prefill_chunk=8), dict(prefill_chunk=8,
                                           kv_layout="paged")):
        with pytest.raises(ValueError) as ours:
            ContinuousEngine(model, params, cache_len=32, num_slots=2,
                             device="cpu", **kw)
        with pytest.raises(ValueError) as theirs:
            JaxEngine(jmodel, jparams, cache_len=32, num_slots=2, **kw)
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="patch_stub"):
        from repro_torch.models import transformer
        transformer.init_paged_cache(model.cfg, 4, 4, device="cpu",
                                     dtype=torch.float32)


def test_run_traffic_and_drafter_match_reference(monkeypatch):
    """``run_traffic`` on qwen3-smoke with a yi-smoke drafter (both of
    vocabulary 256), on both sides, with the same prompts and the same
    parameters for target and drafter: every arm's tokens equal the
    reference's arm, and the speculative arm keeps the paged arm's
    tokens."""
    import repro.launch.serve as jlaunch
    from repro.models.registry import make_synthetic_batch
    from repro_torch.launch import serve as launch
    jcfg = jax_smoke_config("qwen3-14b")
    monkeypatch.setattr(launch, "synthetic_tokens", lambda cfg, b, s, seed:
                        np.asarray(make_synthetic_batch(
                            jcfg, b, s, seed=seed,
                            compute_dtype="float32")["tokens"], np.int32))
    seen = []

    def recording(eng, reqs, *a, **kw):
        out = jlaunch_drive(eng, reqs, *a, **kw)
        seen.append([r.output[:r.generated].tolist() for r in reqs])
        return out

    jlaunch_drive = jlaunch.drive_continuous
    monkeypatch.setattr(jlaunch, "drive_continuous", recording)
    kw = dict(smoke=True, requests=4, slots=2, prompt_len=(9, 20),
              max_new=(3, 6), rate=400.0, seed=0, prefill_chunk=8,
              block_size=4, speculate=2, draft_arch="yi-9b")
    ref = jlaunch.run_traffic("qwen3-14b", prefix_compare=False,
                              spec_compare=True, engine="continuous",
                              chunk_compare=False, parity_check=False, **kw)
    _, _, _, params = tp.bundle("qwen3-14b")
    _, _, dmodel, dparams = tp.bundle("yi-9b")
    monkeypatch.setattr(launch, "_drafter",
                        lambda *a, **k: (dmodel, dparams))
    res = launch.run_traffic("qwen3-14b", device="cpu", params=params,
                             prefix_compare=False,
                             spec_compare=True, engine="continuous",
                             chunk_compare=False, parity_check=False, **kw)
    arms = res["outputs_by_arm"]
    assert arms["continuous"] == seen[0]
    assert arms["continuous_paged"] == seen[1]
    assert arms["continuous_spec"] == seen[2]
    assert res["spec_token_identical_trace"] and res["draft_arch"] == "yi-9b"
    assert res["spec_accepted_per_dispatch"] == pytest.approx(
        ref["spec_accepted_per_dispatch"])
