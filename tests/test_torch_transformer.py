"""Port paged decode step and prefill chunk vs the JAX reference's, on the
gemma-2b smoke config.

The reference model is built and initialised as the reference's own
tests do; its parameters move to the port through
``interop.params_from_numpy``. Pools, tables and tokens are made by
numpy from a seed. Float32 on the CPU: logits and the written pool
entries are held to 1e-5 (different summation orders), argmax exactly,
and every pool entry that no valid query writes must stay byte-identical
(parked rows, chunk padding, all -1 padding rows).
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
from repro_torch.config import ServeConfig
from repro_torch.configs import get_smoke_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import transformer as T
from repro_torch.models.registry import build_model

TOL = 1e-5
TRAIN = TrainConfig(param_dtype="float32", compute_dtype="float32",
                    loss_chunk=16, attn_chunk_threshold=64, attn_chunk=16,
                    remat=False)
P, BS, NB = 16, 4, 6            # pool blocks, block size, table width


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke_config("gemma-2b")
    jmodel = jax_build_model(jcfg, TRAIN, JServeConfig(), tp=1)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config("gemma-2b")
    model = build_model(cfg, ServeConfig(param_dtype="float32",
                                         compute_dtype="float32"),
                        device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    params = params_from_numpy(tree, cfg, device="cpu", dtype=torch.float32)
    return jmodel, jparams, model, params


def _pool(cfg, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, P, BS, cfg.num_kv_heads, cfg.head_dim)
    return {"k": rng.standard_normal(shape, dtype=np.float32),
            "v": rng.standard_normal(shape, dtype=np.float32)}


def _run_both(models, kind, pool, *args):
    """Run one step on both sides from the same pool; returns (port
    logits, reference logits, port pool, reference pool) as numpy."""
    jmodel, jparams, model, params = models
    tpool = {k: torch.as_tensor(v.copy()) for k, v in pool.items()}
    jpool = {k: jnp.asarray(v) for k, v in pool.items()}
    targs = [torch.as_tensor(a) for a in args]
    jargs = [jnp.asarray(a) for a in args]
    if kind == "decode":
        port = model.decode_step_paged(params, tpool, *targs)
        ref, jpool = jmodel.decode_step_paged(jparams, jpool, *jargs)
    else:
        tokens, tables, pos0, n_valid = args
        rows = np.arange(len(pos0), dtype=np.int32)
        port = model.prefill_chunk_paged(params, tpool, *targs[:2],
                                         torch.as_tensor(rows), *targs[2:])
        ref, jpool = jmodel.prefill_chunk_paged(
            jparams, jpool, *jargs[:2], jnp.asarray(rows), *jargs[2:])
    return (port.numpy(), np.asarray(ref),
            {k: v.numpy() for k, v in tpool.items()},
            {k: np.asarray(v) for k, v in jpool.items()})


def _written(tables, qpos, wvalid):
    """(block, offset) pairs the valid queries write."""
    out = set()
    for b in range(qpos.shape[0]):
        for j in range(qpos.shape[1]):
            if wvalid[b, j] and qpos[b, j] >= 0:
                blk = tables[b, min(qpos[b, j] // BS, NB - 1)]
                if blk >= 0:
                    out.add((int(blk), int(qpos[b, j] % BS)))
    return out


def _check_pool(pool, tpool, jpool, written):
    keep = np.ones((P, BS), bool)
    for blk, off in written:
        keep[blk, off] = False
    for name in ("k", "v"):
        # entries no valid query writes: byte-identical to the input
        assert np.array_equal(tpool[name][:, keep], pool[name][:, keep])
        np.testing.assert_allclose(tpool[name], jpool[name], atol=TOL,
                                   rtol=TOL)


def _tables():
    t = np.full((4, NB), -1, np.int32)
    t[0, :4] = [3, 7, 1, 12]          # 16 tokens
    t[1, :2] = [0, 5]                 # 8 tokens
    t[2, :3] = [2, 9, 14]             # parked row: mid-prefill, valid table
    return t                          # row 3: free row, all -1


def test_decode_step_matches_reference(models):
    cfg = models[2].cfg
    pool = _pool(cfg, 0)
    tables = _tables()
    positions = np.array([13, 6, -(2 ** 30), -(2 ** 30)], np.int32)
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(4, 1)).astype(np.int32)
    port, ref, tpool, jpool = _run_both(models, "decode", pool, tokens,
                                        positions, tables)
    assert port.shape == (4, cfg.padded_vocab)
    np.testing.assert_allclose(port, ref, atol=TOL, rtol=TOL)
    assert np.array_equal(port[:2].argmax(-1), ref[:2].argmax(-1))
    _check_pool(pool, tpool, jpool,
                _written(tables, positions[:, None], positions[:, None] >= 0))


def test_prefill_chunk_matches_reference(models):
    cfg = models[2].cfg
    C = 8
    pool = _pool(cfg, 2)
    tables = _tables()
    tables[3] = -1                                # chunk padding row
    pos0 = np.array([0, 4, 8, 0], np.int32)
    n_valid = np.array([8, 3, 5, 0], np.int32)    # row 1: partial chunk
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(4, C)).astype(np.int32)
    port, ref, tpool, jpool = _run_both(models, "chunk", pool, tokens,
                                        tables, pos0, n_valid)
    np.testing.assert_allclose(port, ref, atol=TOL, rtol=TOL)
    assert np.array_equal(port[:3].argmax(-1), ref[:3].argmax(-1))
    qpos = pos0[:, None] + np.arange(C)[None, :]
    wvalid = np.arange(C)[None, :] < n_valid[:, None]
    _check_pool(pool, tpool, jpool, _written(tables, qpos, wvalid))


def test_chunks_then_decode_track_reference(models):
    """A 13-token prompt deposited in chunks of 8, then three decode
    steps, each step from the pool the previous one left: logits and
    pools stay with the reference throughout."""
    jmodel, jparams, model, params = models
    cfg = model.cfg
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab_size, size=13).astype(np.int32)
    tables = np.array([[4, 11, 6, 2, 8, -1]], np.int32)
    tpool = {k: torch.zeros(cfg.num_layers, P, BS, 1, cfg.head_dim)
             for k in ("k", "v")}
    jpool = {k: jnp.zeros((cfg.num_layers, P, BS, 1, cfg.head_dim))
             for k in ("k", "v")}
    rows = jnp.zeros((1,), jnp.int32)
    for off in (0, 8):
        n = min(8, 13 - off)
        tok = np.zeros((1, 8), np.int32)
        tok[0, :n] = prompt[off:off + n]
        pos0, nv = np.array([off], np.int32), np.array([n], np.int32)
        port = model.prefill_chunk_paged(
            params, tpool, torch.as_tensor(tok), torch.as_tensor(tables),
            torch.zeros(1, dtype=torch.int64), torch.as_tensor(pos0),
            torch.as_tensor(nv))
        ref, jpool = jmodel.prefill_chunk_paged(
            jparams, jpool, jnp.asarray(tok), jnp.asarray(tables), rows,
            jnp.asarray(pos0), jnp.asarray(nv))
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=TOL,
                                   rtol=TOL)
    nxt = int(np.asarray(ref).argmax(-1)[0])
    for pos in (13, 14, 15):
        tok = np.array([[nxt]], np.int32)
        port = model.decode_step_paged(
            params, tpool, torch.as_tensor(tok),
            torch.as_tensor(np.array([pos], np.int32)),
            torch.as_tensor(tables))
        ref, jpool = jmodel.decode_step_paged(
            jparams, jpool, jnp.asarray(tok), jnp.asarray([pos], jnp.int32),
            jnp.asarray(tables))
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=TOL,
                                   rtol=TOL)
        assert int(port.argmax(-1)[0]) == int(np.asarray(ref).argmax(-1)[0])
        nxt = int(np.asarray(ref).argmax(-1)[0])
    for name in ("k", "v"):
        np.testing.assert_allclose(tpool[name].numpy(),
                                   np.asarray(jpool[name]), atol=TOL,
                                   rtol=TOL)


def test_logits_masked_past_vocab(models):
    cfg = models[2].cfg
    pool = _pool(cfg, 5)
    port, _, _, _ = _run_both(
        models, "decode", pool, np.zeros((4, 1), np.int32),
        np.array([3, 2, 1, 0], np.int32), _tables())
    assert (port[:, cfg.vocab_size:] == -1e30).all()


def test_kv_store_heads_and_layer_flags_match_reference():
    from repro.models import transformer as JT
    cfg = get_smoke_config("gemma-2b")
    jcfg = jax_smoke_config("gemma-2b")
    for tp in (1, 2, 4):
        assert T.kv_store_heads(cfg, tp) == JT.kv_store_heads(jcfg, tp)
    assert T.layer_flags(cfg) == [bool(f) for f in JT.layer_flags(jcfg)]


def test_init_paged_cache_matches_reference_shape():
    from repro.models import transformer as JT
    cfg = get_smoke_config("gemma-2b")
    jcfg = jax_smoke_config("gemma-2b")
    port = T.init_paged_cache(cfg, 10, 4, device="cpu", dtype=torch.float32)
    ref = JT.init_paged_cache(jcfg, 10, 4, 1, jnp.float32)
    assert set(port) == set(ref)
    for k in port:
        assert tuple(port[k].shape) == ref[k].shape
        assert not port[k].any()


def test_seeded_init_is_deterministic_and_reference_scaled():
    model = build_model(get_smoke_config("gemma-2b"),
                        ServeConfig(param_dtype="float32",
                                    compute_dtype="float32"), device="cpu")
    a, b, c = model.init(0), model.init(0), model.init(1)
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], c["embed"])
    wq = a["blocks"][0]["attn"]["wq"]
    d = model.cfg.d_model
    assert wq.abs().max() <= 3 * d ** -0.5 + 1e-6          # truncated at 3 std
    # a normal truncated at +-3 std keeps 0.9866 of its std; 8192 draws
    # estimate it to ~1%
    assert abs(float(wq.std()) / (d ** -0.5 * 0.9866) - 1) < 0.03
    assert not a["final_norm"]["w"].any()                   # (1 + w) norms
