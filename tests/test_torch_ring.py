"""Port ring-buffer slot caches vs the JAX reference's: prompts longer
than ``cache_len`` on the hymba-1.5b smoke config (window 16, global
layer 0) and the gemma-2b smoke config (no window: the prefill keeps the
last ``cache_len`` entries all the same, as the reference's does).

Parameters move from the reference through ``interop.params_from_numpy``;
tokens are made by numpy from a seed. Float32 on the CPU: logits and
cache entries are held to 1e-5 (the two frameworks sum in different
orders), argmax and greedy tokens exactly, positions exactly. The port's
scratch column stays invisible (position -1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ServeConfig as JServeConfig
from repro.config import ShapeConfig as JShapeConfig
from repro.config import TrainConfig
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.registry import build_model as jax_build_model
from repro.models.registry import cache_len_for as jax_cache_len_for
from repro.serve import ContinuousEngine as JaxEngine
from repro.serve import StaticEngine as JaxStatic
from repro_torch.config import ServeConfig, ShapeConfig
from repro_torch.configs import get_smoke_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import transformer as T
from repro_torch.models.registry import build_model, cache_len_for
from repro_torch.serve import ContinuousEngine, StaticEngine

TOL = 1e-5
TRAIN = TrainConfig(param_dtype="float32", compute_dtype="float32",
                    loss_chunk=16, attn_chunk_threshold=4096, attn_chunk=16,
                    remat=False)
ARCHS = ("hymba-1.5b", "gemma-2b")


def _serve(ring=True):
    return ServeConfig(param_dtype="float32", compute_dtype="float32",
                       attn_chunk_threshold=4096, ring_buffer=ring)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    arch = request.param
    jcfg = jax_smoke_config(arch)
    jmodel = jax_build_model(jcfg, TRAIN, JServeConfig(ring_buffer=True),
                             tp=1)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config(arch)
    model = build_model(cfg, _serve(), device="cpu")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               cfg)
    return jmodel, jparams, model, params


def _tokens(B, S, seed, vocab):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(B, S)).astype(np.int32)


def _close_cache(port, ref, W):
    """The port's ring cache against the reference's: k/v on the first W
    columns, the position row (one per cache row, the reference's shared
    one), the scratch column invisible, the carried state if any."""
    for name in ("k", "v"):
        np.testing.assert_allclose(port[name][:, :, :W].numpy(),
                                   np.asarray(ref[name]), atol=TOL, rtol=TOL)
    pos = port["pos"].numpy()
    ref_pos = np.asarray(ref["pos"])
    assert (pos[:, :W] == ref_pos[0][None]).all()
    assert (pos[:, W] == -1).all()
    for name in ("conv", "ssm"):
        if name in ref:
            np.testing.assert_allclose(port[name].numpy(),
                                       np.asarray(ref[name]), atol=TOL,
                                       rtol=TOL)


@pytest.mark.parametrize("S", [17, 24, 41])
def test_ring_prefill_matches_reference(models, S):
    """Prompts past the 16-entry cache: last-position logits, the rotated
    k/v (token t at column t % 16) and its absolute positions equal the
    reference's ring prefill."""
    jmodel, jparams, model, params = models
    W = 16
    tok = _tokens(2, S, S, model.cfg.vocab_size)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(tok)}, W)
    T.reset_counters()
    tl, tc = model.prefill(params, torch.as_tensor(tok), W)
    assert T.prefill_calls == 1
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    assert (tl.argmax(-1).numpy() == np.asarray(jl).argmax(-1)).all()
    _close_cache(tc, jax.tree_util.tree_map(np.asarray, jc), W)
    pos = tc["pos"][0, :W].numpy()
    assert sorted(pos.tolist()) == list(range(S - W, S))
    assert ((pos % W) == np.arange(W)).all()


def test_ring_decode_recycles_like_reference(models):
    """Decode past the window after a ring prefill: every step's logits
    and the recycled cache (column pos % 16) equal the reference's."""
    jmodel, jparams, model, params = models
    W, S = 16, 20
    tok = _tokens(2, S, 7, model.cfg.vocab_size)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(tok)}, W)
    tl, tc = model.prefill(params, torch.as_tensor(tok), W)
    nxt = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
    step = jax.jit(jmodel.decode_step)
    for t in range(W + 3):
        jl, jc = step(jparams, jc, jnp.asarray(nxt), jnp.int32(S + t))
        tl = model.decode_step(params, tc, torch.as_tensor(nxt),
                               torch.full((2,), S + t))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        nxt = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
        assert (tl.argmax(-1).numpy() == nxt[:, 0]).all()
    _close_cache(tc, jax.tree_util.tree_map(np.asarray, jc), W)


def test_ring_engines_token_identical_to_reference(models):
    """The static engine and the slot continuous engine, chunked and
    monolithic, on prompts past a 16-entry ring, decoding past it again:
    greedy tokens equal the reference's engines' one for one."""
    jmodel, jparams, model, params = models
    W = 16
    prompt = {"tokens": _tokens(2, 24, 11, model.cfg.vocab_size)}
    chunk = 8
    ref = {"static": JaxStatic(jmodel, jparams, W).generate(prompt, 20)}
    port = {"static": StaticEngine(model, params, W,
                                   device="cpu").generate(prompt, 20)}
    for name, c in (("chunked", chunk), ("monolithic", 0)):
        ref[name] = JaxEngine(jmodel, jparams, cache_len=W, num_slots=2,
                              prefill_chunk=c).generate(prompt, 20)
        port[name] = ContinuousEngine(model, params, cache_len=W,
                                      num_slots=2, prefill_chunk=c,
                                      device="cpu").generate(prompt, 20)
    for name in ref:
        assert np.array_equal(port[name], np.asarray(ref[name])), name
    # the whole prompt attends in a monolithic prefill: static and
    # monolithic slot arms agree with each other, as in the reference
    assert np.array_equal(port["static"], port["monolithic"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("seq_len", [8, 16, 2048])
def test_cache_len_for_matches_reference(arch, ring, seq_len):
    got = cache_len_for(get_smoke_config(arch),
                        ShapeConfig("decode", seq_len, 1, "decode"),
                        _serve(ring))
    want = jax_cache_len_for(jax_smoke_config(arch),
                             JShapeConfig("decode", seq_len, 1, "decode"),
                             JServeConfig(ring_buffer=ring))
    assert got == want


def test_run_traffic_ring_reproduces_reference(monkeypatch):
    """``run_traffic(ring=True)`` on hymba-smoke with prompts past its
    window, on both sides with the same trace, prompts (the port's prompt
    source patched to the reference's) and parameters: the same cache
    length and chunk, every continuous arm's and the static arm's tokens,
    and the same parity flag. A paged arm cannot hold a prompt longer
    than the ring on either side."""
    import repro.launch.serve as jlaunch
    from repro.models.registry import make_synthetic_batch
    from repro_torch.launch import serve as launch
    jcfg = jax_smoke_config("hymba-1.5b")
    monkeypatch.setattr(launch, "synthetic_tokens", lambda cfg, b, s, seed:
                        np.asarray(make_synthetic_batch(
                            jcfg, b, s, seed=seed,
                            compute_dtype="float32")["tokens"], np.int32))
    seen = {}

    def recording(name, fn):
        def wrapped(eng, reqs, *a, **kw):
            out = fn(eng, reqs, *a, **kw)
            seen.setdefault(name, []).append(
                [r.output[:r.generated].tolist() for r in reqs])
            return out
        return wrapped

    monkeypatch.setattr(jlaunch, "drive_continuous",
                        recording("continuous", jlaunch.drive_continuous))
    monkeypatch.setattr(jlaunch, "drive_static",
                        recording("static", jlaunch.drive_static))
    kw = dict(smoke=True, requests=4, slots=2, prompt_len=24,
              max_new=(2, 6), rate=400.0, seed=0, ring=True,
              paged_compare=False)
    ref = jlaunch.run_traffic("hymba-1.5b", **kw)
    jparams = jax_build_model(jcfg, TRAIN, JServeConfig(), tp=1).init(
        jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               get_smoke_config("hymba-1.5b"))
    res = launch.run_traffic("hymba-1.5b", device="cpu", params=params,
                             prefix_compare=False, spec_compare=False, **kw)
    arms = res["outputs_by_arm"]
    assert arms["continuous"] == seen["continuous"][0]
    assert arms["continuous_monolithic"] == seen["continuous"][1]
    assert arms["static"] == seen["static"][0]
    for key in ("cache_len", "prefill_chunk", "parity_token_identical",
                "parity_prompt_len"):
        assert res[key] == ref[key], key
    assert res["cache_len"] == 16 and res["ring"]
    assert arms["static"] == arms["continuous_monolithic"]
    # a paged arm: the prompt and its budget exceed the ring's capacity
    with pytest.raises(ValueError, match="admittable capacity"):
        launch.run_traffic("hymba-1.5b", device="cpu", params=params,
                           prefix_compare=False, spec_compare=False,
                           **{**kw, "paged_compare": True})


def test_ring_with_every_layer_windowed():
    """The reference's long-context serving mode (every layer windowed):
    ring prefill and decode far past the window stay equal to it."""
    jcfg = dataclasses.replace(jax_smoke_config("hymba-1.5b"),
                               global_layers=())
    cfg = dataclasses.replace(get_smoke_config("hymba-1.5b"),
                              global_layers=())
    jmodel = jax_build_model(jcfg, TRAIN, JServeConfig(ring_buffer=True),
                             tp=1)
    jparams = jmodel.init(jax.random.PRNGKey(2))
    model = build_model(cfg, _serve(), device="cpu")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               cfg)
    W = cfg.swa_window
    prompt = {"tokens": _tokens(2, 8, 3, cfg.vocab_size)}
    ref = JaxStatic(jmodel, jparams, W).generate(prompt, 3 * W)
    out = StaticEngine(model, params, W, device="cpu").generate(prompt,
                                                                3 * W)
    assert np.array_equal(out, np.asarray(ref))
