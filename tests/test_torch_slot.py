"""Port slot-layout model paths vs the JAX reference's, on the gemma-2b
smoke config: the plain attention layers, monolithic ``prefill``, slot
``decode_step`` and slot ``prefill_chunk``.

The reference model is built and initialised as the reference's own
tests do; its parameters move to the port through
``interop.params_from_numpy`` and its slot caches through
``interop.slot_cache_from_numpy``. Tokens and activations are made by
numpy from a seed. Float32 on the CPU: logits and cache entries are held
to 1e-5 (the two frameworks sum in different orders), argmax exactly.
Entries no valid query writes must stay as they were, and the port's
scratch column must stay invisible (position -1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ServeConfig as JServeConfig
from repro.config import TrainConfig
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro.models.registry import build_model as jax_build_model
from repro_torch.config import ServeConfig
from repro_torch.configs import get_smoke_config
from repro_torch.interop import params_from_numpy, slot_cache_from_numpy
from repro_torch.models import layers as TL
from repro_torch.models import transformer as T
from repro_torch.models.registry import build_model

TOL = 1e-5
W = 40                          # cache_len of every cache here
TRAIN = TrainConfig(param_dtype="float32", compute_dtype="float32",
                    loss_chunk=16, attn_chunk_threshold=64, attn_chunk=16,
                    remat=False)
SERVE = ServeConfig(param_dtype="float32", compute_dtype="float32",
                    attn_chunk_threshold=64, attn_chunk=16)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke_config("gemma-2b")
    jmodel = jax_build_model(jcfg, TRAIN, JServeConfig(), tp=1)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config("gemma-2b")
    model = build_model(cfg, SERVE, device="cpu")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               cfg)
    return jmodel, jparams, model, params


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(B, S, seed):
    return np.random.default_rng(seed).integers(
        0, 256, size=(B, S)).astype(np.int32)


def _close_cache(port, ref, tol=TOL):
    """The port's cache (scratch column included) against the reference's:
    k/v on the first W columns, one position row per cache row equal to
    the reference's (shared) row, the scratch column invisible."""
    for name in ("k", "v"):
        np.testing.assert_allclose(port[name][:, :, :W].numpy(),
                                   np.asarray(ref[name]), atol=tol, rtol=tol)
    pos = port["pos"].numpy()
    ref_pos = np.asarray(ref["pos"])
    assert (ref_pos == ref_pos[0]).all()
    assert (pos[:, :W] == ref_pos[0][None]).all()
    assert (pos[:, W] == -1).all()


# ---------------------------------------------------------------------------
# plain attention layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,softcap", [(None, 0.0), (6, 0.0),
                                            (None, 20.0)])
def test_full_attention_matches_reference(window, softcap):
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, 12, 4, 16), dtype=np.float32)
               for _ in range(3))
    pos = np.arange(12)
    mask = rng.random((2, 12)) > 0.2
    mask[:, 0] = True
    ref = JL.full_attention(*map(jnp.asarray, (q, k, v)),
                            q_pos=jnp.asarray(pos), k_pos=jnp.asarray(pos),
                            window=window, softcap=softcap,
                            extra_mask=jnp.asarray(mask))
    port = TL.full_attention(*map(torch.as_tensor, (q, k, v)),
                             q_pos=torch.as_tensor(pos),
                             k_pos=torch.as_tensor(pos), window=window,
                             softcap=softcap,
                             extra_mask=torch.as_tensor(mask))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("S,T,chunk_q,chunk_k,window,softcap,causal", [
    (37, 37, 16, 8, None, 0.0, True),       # ragged tails both ways
    (32, 32, 16, 16, 5, 0.0, True),
    (20, 29, 8, 8, None, 30.0, False),      # padded keys, non-causal
])
def test_chunked_attention_matches_reference(S, T, chunk_q, chunk_k, window,
                                             softcap, causal):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, S, 4, 16), dtype=np.float32)
    k, v = (rng.standard_normal((2, T, 4, 16), dtype=np.float32)
            for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=softcap,
              chunk_q=chunk_q, chunk_k=chunk_k)
    ref = JL.chunked_attention(*map(jnp.asarray, (q, k, v)),
                               q_pos=jnp.arange(S), k_pos=jnp.arange(T), **kw)
    port = TL.chunked_attention(*map(torch.as_tensor, (q, k, v)),
                                q_pos=torch.arange(S), k_pos=torch.arange(T),
                                **kw)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


# ---------------------------------------------------------------------------
# prefill / decode / chunk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [17, 70])   # full attention, then chunked
def test_prefill_matches_reference(models, S):
    jmodel, jparams, model, params = models
    tok = _tokens(2, S if S <= W else S, seed=S)
    cache_len = max(W, S)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(tok)}, cache_len)
    T.reset_counters()
    tl, tc = model.prefill(params, torch.as_tensor(tok), cache_len)
    assert T.prefill_calls == 1
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    assert (tl.argmax(-1).numpy() == np.asarray(jl).argmax(-1)).all()
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name][:, :, :cache_len].numpy(),
                                   np.asarray(jc[name]), atol=TOL, rtol=TOL)
    assert (tc["pos"][:, :cache_len].numpy()
            == np.asarray(jc["pos"])[0][None]).all()


def test_prefill_longer_than_cache_raises(models):
    """A prompt longer than the cache no longer raises: it is a ring
    buffer, the last ``cache_len`` entries kept at columns ``pos %
    cache_len``, as the reference's prefill keeps them (its name is kept
    from when this path raised; ``tests/test_torch_ring.py`` covers the
    ring in full)."""
    jmodel, jparams, model, params = models
    tok = _tokens(1, 12, 0)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(tok)}, 8)
    tl, tc = model.prefill(params, torch.as_tensor(tok), 8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name][:, :, :8].numpy(),
                                   np.asarray(jc[name]), atol=TOL, rtol=TOL)
    assert (tc["pos"][0, :8].numpy() == np.asarray(jc["pos"])[0]).all()
    assert sorted(tc["pos"][0, :8].tolist()) == list(range(4, 12))
    assert tc["pos"][0, 8] == -1


def test_decode_step_matches_reference(models):
    """Three decode steps from a prefilled cache, per-row positions equal
    (the reference's decode takes one position for the batch)."""
    jmodel, jparams, model, params = models
    S = 15
    tok = _tokens(3, S, seed=3)
    _, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(tok)}, W)
    tc = slot_cache_from_numpy(_np(jc))
    nxt = _tokens(3, 1, seed=4)
    for step in range(3):
        jl, jc = jmodel.decode_step(jparams, jc, jnp.asarray(nxt),
                                    jnp.int32(S + step))
        tl = model.decode_step(params, tc, torch.as_tensor(nxt),
                               torch.full((3,), S + step))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        _close_cache(tc, _np(jc))
        nxt = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)


def test_parked_decode_row_writes_nothing(models):
    """A row at a negative position leaves its cache row as it was; the
    other rows match the reference's decode of the same rows."""
    jmodel, jparams, model, params = models
    tok = _tokens(2, 9, seed=5)
    _, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(tok)}, W)
    tc = slot_cache_from_numpy(_np(jc))
    before = {k: v.clone() for k, v in tc.items()}
    nxt = _tokens(2, 1, seed=6)
    tl = model.decode_step(params, tc, torch.as_tensor(nxt),
                           torch.tensor([9, -(2 ** 30)]))
    jl, _ = jmodel.decode_step(jparams, jc, jnp.asarray(nxt), jnp.int32(9))
    np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl)[0], atol=TOL,
                               rtol=TOL)
    for name in ("k", "v"):
        assert torch.equal(tc[name][:, 1, :W], before[name][:, 1, :W])
    assert torch.equal(tc["pos"][1], before["pos"][1])
    assert tc["pos"][0, 9] == 9


def test_prefill_chunk_matches_reference(models):
    """One batched port chunk over two rows against the reference's
    per-request chunk: row 0 resumes a prefilled prompt at pos0=10 with a
    full chunk, row 1 starts a fresh cache with 5 valid tokens of 8 (the
    padding must write nothing visible)."""
    jmodel, jparams, model, params = models
    C = 8
    _, jc0 = jmodel.prefill(jparams, {"tokens": jnp.asarray(
        _tokens(1, 10, seed=7))}, W)
    jc1 = jmodel.init_cache(1, W)
    chunk = _tokens(2, C, seed=8)
    pos0, n_valid = np.array([10, 0]), np.array([C, 5])
    rows = [slot_cache_from_numpy(_np(c)) for c in (jc0, jc1)]
    tc = {k: torch.cat([r[k] for r in rows], dim=0 if k == "pos" else 1)
          for k in ("k", "v", "pos")}
    tl = model.prefill_chunk(params, tc, torch.as_tensor(chunk),
                             torch.as_tensor(pos0), torch.as_tensor(n_valid))
    for b, jc in enumerate((jc0, jc1)):
        jl, jc_new = jmodel.prefill_chunk(
            jparams, jc, jnp.asarray(chunk[b]), jnp.int32(pos0[b]),
            jnp.int32(n_valid[b]))
        np.testing.assert_allclose(tl[b].numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        _close_cache({k: (v[:, b:b + 1] if k != "pos" else v[b:b + 1])
                      for k, v in tc.items()}, _np(jc_new))
    assert (tc["pos"][1, :5] == torch.arange(5)).all()
    assert (tc["pos"][1, 5:] == -1).all()
