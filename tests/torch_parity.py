"""Shared pieces of the port-vs-reference tests of the model families
(``test_torch_dense_family.py``, ``test_torch_moe.py``,
``test_torch_encdec.py``): both sides built at a smoke config in float32
on the CPU, the reference's parameters moved to the port through
``interop.params_from_numpy``, inputs made by numpy from a seed, and a
step-by-step engine replay that records admissions and block tables."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.config import ServeConfig as JServeConfig
from repro.config import TrainConfig
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.registry import build_model as jax_build_model
from repro_torch.config import ServeConfig
from repro_torch.configs import get_smoke_config
from repro_torch.interop import params_from_numpy, slot_cache_from_numpy
from repro_torch.launch.serve import frontend_arrays
from repro_torch.models.registry import build_model

TOL = 1e-5
TRAIN = TrainConfig(param_dtype="float32", compute_dtype="float32",
                    loss_chunk=16, attn_chunk_threshold=64, attn_chunk=16,
                    remat=False)
F32 = ServeConfig(param_dtype="float32", compute_dtype="float32",
                  attn_chunk_threshold=64, attn_chunk=16)
PARK = -(2 ** 30)


def bundle(arch, seed=0, perturbed=()):
    """(reference model, its parameters, port model, the same parameters)
    at ``arch``'s smoke config; the leaves named in ``perturbed`` are
    redrawn (:func:`perturb`)."""
    jmodel = jax_build_model(jax_smoke_config(arch), TRAIN, JServeConfig(),
                             tp=1)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    if perturbed:
        jparams = perturb(jparams, perturbed)
    cfg = get_smoke_config(arch)
    model = build_model(cfg, F32, device="cpu")
    return jmodel, jparams, model, moved(jparams, cfg)


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


def tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape).astype(np.int32)


def prompt(cfg, B, S, seed):
    """A prompt batch with the frontend's inputs, numpy."""
    return {"tokens": tokens(cfg, (B, S), seed),
            **frontend_arrays(cfg, B, seed)}


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def check_slot_cache(cache, jcache, rows=None):
    """The port's slot cache against a reference cache (numpy leaves),
    the k/v scratch column left out (its position stays -1)."""
    ref = slot_cache_from_numpy(jax.tree_util.tree_map(np.asarray, jcache))
    assert set(ref) == set(cache)
    for k, v in ref.items():
        got = cache[k]
        if rows is not None:
            got = got[rows] if k == "pos" else got[:, rows]
        if k == "pos":
            assert np.array_equal(np.asarray(got), np.asarray(v))
        elif k in ("k", "v"):
            close(got[:, :, :-1], v[:, :, :-1])
        else:
            close(got, v)


def requests(cls, cfg, trace, seed=100):
    """One request per trace entry, prompts and frontend inputs from
    ``seed + rid``, sampled at the entry's temperature; an entry of a
    shared-prefix group opens with its group's template (from ``seed - 1
    - group``)."""
    out = []
    for rid, e in enumerate(trace):
        batch = prompt(cfg, 1, e.prompt_len, seed + rid)
        if e.prefix_group >= 0 and e.prefix_len > 0:
            batch["tokens"][:, :e.prefix_len] = tokens(
                cfg, (1, e.prefix_len), seed - 1 - e.prefix_group)
        out.append(cls(rid=rid, batch=batch, max_new_tokens=e.max_new,
                       temperature=e.temperature, seed=0,
                       arrival=e.arrival))
    return out


def drive(eng, reqs, steps_per_s=2000.0):
    """Deterministic replay: request i is submitted before the step whose
    index reaches its arrival; returns per-step (tables or None, admitted
    rids, finished rids)."""
    log, i, step = [], 0, 0
    pending = sorted(reqs, key=lambda r: r.arrival)
    while i < len(pending) or not eng.idle:
        while i < len(pending) and pending[i].arrival * steps_per_s <= step:
            eng.submit(pending[i], float(step))
            i += 1
        done = eng.step(float(step))
        admitted = sorted(r.rid for r in reqs if r.admit_time == step)
        tables = getattr(eng.kv, "_tables", None)
        log.append((None if tables is None else np.array(tables), admitted,
                    sorted(r.rid for r in done)))
        step += 1
        assert step < 1000
    return log


def same_log(a, b):
    assert len(a) == len(b)
    for (ta, aa, fa), (tb, ab, fb) in zip(a, b):
        assert aa == ab and fa == fb
        assert (ta is None) == (tb is None)
        if ta is not None:
            assert np.array_equal(ta, tb)


def perturb(jparams, names, seed=7):
    """The reference's parameters with every leaf named in ``names``
    (zero-initialised biases, unit norm weights) redrawn around its init,
    so a test sees them act; numpy draws, jnp leaves."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in names:
                a = np.asarray(v)
                out[k] = jnp.asarray(a + 0.2 * rng.standard_normal(
                    a.shape).astype(a.dtype))
            else:
                out[k] = v
        return out

    return walk(jparams)


def moved(jparams, cfg):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             cfg)


# ---------------------------------------------------------------------------
# step checks shared by the decoder-only families
# ---------------------------------------------------------------------------

def check_slot_steps(bundle):
    """Slot decode at per-row positions (a parked row writes nothing) and
    two slot chunks per row (a full one, then a partial one) against the
    reference's per-request steps."""
    jmodel, jparams, model, params = bundle
    cfg = model.cfg
    tok = tokens(cfg, (2, 13), seed=3)
    _, cache = model.prefill(params, torch.as_tensor(tok), 24)
    _, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(tok)}, 24)
    before = {k: v.clone() for k, v in cache.items()}
    nxt = tokens(cfg, (2, 1), seed=4)
    logits = model.decode_step(params, cache, torch.as_tensor(nxt),
                               torch.tensor([13, PARK]))
    row0 = {k: (v if k == "pos" else v[:, :1]) for k, v in jc.items()}
    jl, jrow = jmodel.decode_step(jparams, row0, jnp.asarray(nxt[:1]),
                                  jnp.int32(13))
    close(logits[:1], jl)
    check_slot_cache(cache, jrow, rows=[0])
    for k in ("k", "v"):
        assert torch.equal(cache[k][:, 1, :-1], before[k][:, 1, :-1])
    assert torch.equal(cache["pos"][1], before["pos"][1])

    C = 8
    prompts = tokens(cfg, (2, 2 * C), seed=5)
    cache = model.init_cache(2, 24)
    jcs = [jmodel.init_cache(1, 24) for _ in range(2)]
    for pos0, n_valid in (([0, 0], [C, C]), ([C, C], [C, 5])):
        t = np.stack([prompts[b, pos0[b]:pos0[b] + C] for b in range(2)])
        logits = model.prefill_chunk(params, cache, torch.as_tensor(t),
                                     torch.tensor(pos0),
                                     torch.tensor(n_valid))
        for b in range(2):
            jl, jcs[b] = jmodel.prefill_chunk(
                jparams, jcs[b], jnp.asarray(t[b]), jnp.int32(pos0[b]),
                jnp.int32(n_valid[b]))
            close(logits[b], jl)
            check_slot_cache(cache, jcs[b], rows=[b])


P, BS, NB = 12, 4, 6


def paged_tables():
    t = np.full((3, NB), -1, np.int32)
    t[0, :4] = [3, 7, 1, 10]
    t[1, :3] = [0, 5, 9]
    t[2, :5] = [2, 11, 4, 6, 8]
    return t


def run_paged(bundle, pool, kind, *args):
    """One paged step on both sides from the same pool: (port logits,
    reference logits, port pool, reference pool) as numpy."""
    jmodel, jparams, model, params = bundle
    tpool = {k: torch.as_tensor(v.copy()) for k, v in pool.items()}
    jpool = {k: jnp.asarray(v) for k, v in pool.items()}
    targs = [torch.as_tensor(a) for a in args]
    jargs = [jnp.asarray(a) for a in args]
    fn = "decode_step_paged" if kind == "decode" else "prefill_chunk_paged"
    port = getattr(model, fn)(params, tpool, *targs)
    ref, jpool = getattr(jmodel, fn)(jparams, jpool, *jargs)
    return (port.numpy(), np.asarray(ref),
            {k: v.numpy() for k, v in tpool.items()},
            {k: np.asarray(v) for k, v in jpool.items()})


def check_paged_steps(bundle, pool=None):
    """A chunk (rows 2 and 0, pos0 0 and 8, a padding row aimed past the
    last row with an all -1 table), then full-width decode with a parked
    row: logits of the live rows and every pool leaf (padding and parked
    queries write nothing). ``pool``: extra row-aligned leaves."""
    cfg = bundle[2].cfg
    rng = np.random.default_rng(10)
    shape = (cfg.num_layers, P, BS, cfg.num_kv_heads, cfg.head_dim)
    pool = dict(pool or {})
    pool.update({k: rng.standard_normal(shape, dtype=np.float32)
                 for k in ("k", "v")})
    tables = paged_tables()
    C = 8
    tok = tokens(cfg, (3, C), seed=11)
    ctab = np.stack([tables[2], tables[0], np.full(NB, -1, np.int32)])
    port, ref, tpool, jpool = run_paged(
        bundle, pool, "chunk", tok, ctab, np.array([2, 0, 3], np.int32),
        np.array([0, 8, 0], np.int32), np.array([C, 5, 0], np.int32))
    close(port[:2], ref[:2])
    for k in tpool:
        close(tpool[k], jpool[k])
    tok = tokens(cfg, (3, 1), seed=21)
    port, ref, tpool2, jpool2 = run_paged(
        bundle, tpool, "decode", tok, np.array([13, PARK, 19], np.int32),
        tables)
    close(port[[0, 2]], ref[[0, 2]])
    for k in tpool2:
        close(tpool2[k], jpool2[k])
    return tpool, tpool2


ENGINE_KW = dict(cache_len=36, num_slots=3, prefill_chunk=8, block_size=4,
                 max_prefill_per_step=2)


def check_engine(bundle, layout, shared_prefix_len=0, comm=None,
                 trace_kw=None, **extra):
    """One Poisson trace through the port's and the reference's continuous
    engine (``layout``: paged, slot, or slot-monolithic), step by step:
    the same admissions, finishes and block tables after every step, the
    same greedy tokens. ``shared_prefix_len``: most prompts open with one
    of two templates of that length. ``comm``: a pair (the port's
    communicator, the reference's) each engine is bound to.
    ``trace_kw``: more arguments of ``make_trace`` (``arrival``,
    ``burst``, ``temperature``); a sampled trace holds the admissions,
    finishes and tables alone (``eos_id=-1``: they do not depend on the
    tokens, whose bits the two samplers do not share). Returns the
    port's engine."""
    from repro.serve import ContinuousEngine as JaxEngine
    from repro.serve import ServeRequest as JaxRequest
    from repro_torch.serve import ContinuousEngine, ServeRequest, make_trace
    jmodel, jparams, model, params = bundle
    cfg = model.cfg
    kw = dict(ENGINE_KW, kv_layout=layout.split("-")[0], **extra)
    if layout == "slot-monolithic":
        kw["prefill_chunk"] = 0
    trace = make_trace(6, prompt_len=(5, 19), max_new=(2, 7), rate=400.0,
                       seed=0, shared_prefix_len=shared_prefix_len,
                       share_ratio=0.9, prefix_groups=2, **(trace_kw or {}))
    ours = requests(ServeRequest, cfg, trace)
    theirs = requests(JaxRequest, cfg, trace)
    ocomm, tcomm = comm or (None, None)
    eng = ContinuousEngine(model, params, device="cpu", comm=ocomm, **kw)
    a = drive(eng, ours)
    b = drive(JaxEngine(jmodel, jparams, comm=tcomm, **kw), theirs)
    same_log(a, b)
    if any(e.temperature > 0 for e in trace):
        return eng
    for r, j in zip(ours, theirs):
        assert np.array_equal(r.output[:r.generated],
                              np.asarray(j.output)[:j.generated])
    return eng
