"""Port mixture-of-experts family (olmoe-1b-7b: 8 experts top-2 at the
smoke config, MHA with q/k norm; dbrx-132b: 4 experts top-2, GQA) vs the
JAX reference, on their smoke configs in float32 on the CPU.

* ``moe_apply_dropless`` (the top-k dispatch's plain version) against the
  reference's dense sum with zero gates: float32 router, softmax, top-k,
  renormalised gates — outputs within 1e-5 and the same expert ids, also
  with an expert no token picks, with every token on one expert and at
  T = 1; a prompt split at every chunk boundary routes every token as the
  whole prompt does; exact ties keep the lower expert first, as
  ``jax.lax.top_k`` does. The dispatch tables (counts, offsets,
  permutation, row tiles) by hand on a small example.
* ``init_moe``'s leaves: the reference's shapes and dtypes (the router
  float32).
* The MoE block on every path: monolithic prefill, slot decode and
  chunks, paged chunks and decode, and the engines step by step (the same
  admissions, block tables and greedy tokens).
* olmoe with prefix caching and with speculation (k = 2) against the
  reference's engines, and ``run_traffic`` / ``run_family_rows`` rows.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.models import moe as jmoe
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.moe import ref as moe_ref
from repro_torch.models import moe

ARCHS = ["olmoe-1b-7b", "dbrx-132b"]


@functools.lru_cache(maxsize=None)
def _bundle(arch):
    return tp.bundle(arch, perturbed=("q_norm", "k_norm"))


@pytest.fixture(params=ARCHS)
def bundle(request):
    return _bundle(request.param)


def _moe_params(cfg, seed):
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {"router": rng.standard_normal((d, e)).astype(np.float32),
            "w_gate": (rng.standard_normal((e, d, f)) * d ** -0.5).astype(
                np.float32),
            "w_up": (rng.standard_normal((e, d, f)) * d ** -0.5).astype(
                np.float32),
            "w_down": (rng.standard_normal((e, f, d)) * f ** -0.5).astype(
                np.float32)}


#: routing cases of the dropless layer: (tokens, router bias of one
#: expert on a constant feature); +60 puts expert 0 first for every token,
#: -60 leaves the last expert unpicked
ROUTING_CASES = {"random": ((3, 7), None), "one_expert": ((3, 7), (0, 60.0)),
                 "unpicked_expert": ((3, 7), (-1, -60.0)),
                 "single_token": ((1, 1), None)}


@pytest.mark.parametrize("case", sorted(ROUTING_CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_dropless_matches_reference(arch, case):
    cfg = get_smoke_config(arch)
    p = _moe_params(cfg, 1)
    shape, bias = ROUTING_CASES[case]
    x = np.random.default_rng(2).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)
    if bias is not None:
        x[..., 0] = 1.0
        p["router"][0, bias[0]] = bias[1]
    ours = moe.moe_apply_dropless({k: torch.as_tensor(v) for k, v in
                                   p.items()}, torch.as_tensor(x), cfg)
    theirs, _ = jmoe.moe_apply_dropless({k: jnp.asarray(v) for k, v in
                                         p.items()}, jnp.asarray(x), cfg)
    tp.close(ours, theirs)
    flat = x.reshape(-1, cfg.d_model)
    idx, gates = moe.route({k: torch.as_tensor(v) for k, v in p.items()},
                           torch.as_tensor(flat), cfg)
    probs = jax.nn.softmax(jnp.asarray(flat) @ jnp.asarray(p["router"]), -1)
    jg, ji = jax.lax.top_k(probs, cfg.top_k)
    assert np.array_equal(idx.numpy(), np.asarray(ji))
    tp.close(gates, np.asarray(jg) / np.asarray(jg).sum(-1, keepdims=True))
    picked = (idx[..., None] == torch.arange(cfg.num_experts)).any(dim=1)
    if case == "one_expert":
        assert picked[:, 0].all()
    if case == "unpicked_expert":
        assert not picked[:, -1].any()


def test_dispatch_tables_by_hand():
    """Six assignments over five experts, row tiles of 2: the counts'
    prefix, the assignments expert by expert in (token, slot) order, one
    tile an expert that has rows, none for expert 4, none past them."""
    idx = torch.tensor([[2, 0], [0, 3], [2, 1]])
    offsets, perm, tiles = moe_ref.dispatch_ref(idx, 5, 2)
    assert offsets.tolist() == [0, 2, 3, 5, 6, 6]
    # a = t * K + k: e0 <- a1, a2; e1 <- a5; e2 <- a0, a4; e3 <- a3
    assert perm.tolist() == [1, 2, 5, 0, 4, 3]
    assert tiles.tolist() == [[0, 0], [1, 2], [2, 3], [3, 5]] + [[-1, 0]] * 4
    # three rows of expert 0 in tiles of 2: two tiles, the second partial
    idx = torch.tensor([[0, 1], [0, 1], [1, 0]])
    offsets, perm, tiles = moe_ref.dispatch_ref(idx, 2, 2)
    assert offsets.tolist() == [0, 3, 6]
    assert perm.tolist() == [0, 2, 5, 1, 3, 4]
    assert tiles.tolist() == [[0, 0], [0, 2], [1, 3], [1, 5], [-1, 0]]


@pytest.mark.parametrize("arch", ARCHS)
def test_routing_holds_at_every_chunk_boundary(arch):
    """A 24-token prompt split at every boundary: each token's experts and
    output are those of the whole prompt (the reference's on the whole
    prompt within 1e-5)."""
    cfg = get_smoke_config(arch)
    p = {k: torch.as_tensor(v) for k, v in _moe_params(cfg, 3).items()}
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (1, 24, cfg.d_model)).astype(np.float32))
    whole_idx, _ = moe.route(p, x[0], cfg)
    whole = moe.moe_apply_dropless(p, x, cfg)
    theirs, _ = jmoe.moe_apply_dropless(
        {k: jnp.asarray(v.numpy()) for k, v in p.items()},
        jnp.asarray(x.numpy()), cfg)
    tp.close(whole, theirs)
    for c in range(1, 24):
        parts = [x[:, :c], x[:, c:]]
        idx = torch.cat([moe.route(p, part[0], cfg)[0] for part in parts])
        assert torch.equal(idx, whole_idx), c
        out = torch.cat([moe.moe_apply_dropless(p, part, cfg)
                         for part in parts], dim=1)
        tp.close(out, whole)


def test_top_k_ties_keep_the_lower_expert():
    """Equal router probabilities (a zero router): the port picks experts
    0..K-1 in order, as ``jax.lax.top_k`` does."""
    cfg = get_smoke_config("olmoe-1b-7b")
    p = {"router": torch.zeros((cfg.d_model, cfg.num_experts))}
    flat = torch.randn(5, cfg.d_model, generator=torch.Generator()
                       .manual_seed(0))
    idx, gates = moe.route(p, flat, cfg)
    _, ji = jax.lax.top_k(jnp.full((5, cfg.num_experts),
                                   1.0 / cfg.num_experts), cfg.top_k)
    assert np.array_equal(idx.numpy(), np.asarray(ji))
    assert np.array_equal(idx.numpy(), np.tile(np.arange(cfg.top_k), (5, 1)))
    tp.close(gates, np.full((5, cfg.top_k), 1.0 / cfg.top_k))
    p = {k: torch.as_tensor(v) for k, v in _moe_params(cfg, 5).items()}
    p["router"] = torch.zeros((cfg.d_model, cfg.num_experts))
    theirs, _ = jmoe.moe_apply_dropless(
        {k: jnp.asarray(v.numpy()) for k, v in p.items()},
        jnp.asarray(flat.numpy()[None]), cfg)
    tp.close(moe.moe_apply_dropless(p, flat[None], cfg), theirs)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_leaves_match_reference(arch):
    cfg = get_smoke_config(arch)
    gen = torch.Generator().manual_seed(0)
    ours = moe.init_moe(cfg, gen, "cpu", torch.bfloat16)
    theirs = jax.eval_shape(lambda k: jmoe.init_moe(cfg, k, jnp.bfloat16),
                            jax.random.PRNGKey(0))
    assert set(ours) == set(theirs)
    for k, v in ours.items():
        assert tuple(v.shape) == theirs[k].shape
        assert str(v.dtype).split(".")[-1] == str(theirs[k].dtype), k
    assert ours["router"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the MoE block on every path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [11, 16])
def test_prefill_matches_reference(bundle, S):
    jmodel, jparams, model, params = bundle
    batch = tp.prompt(model.cfg, 2, S, seed=S)
    logits, cache = model.prefill(params, torch.as_tensor(batch["tokens"]),
                                  24)
    jl, jc = jmodel.prefill(jparams, tp.jbatch(batch), 24)
    tp.close(logits, jl)
    tp.check_slot_cache(cache, jc)


def test_slot_decode_and_chunk_match_reference(bundle):
    tp.check_slot_steps(bundle)


def test_paged_chunk_and_decode_match_reference(bundle):
    tp.check_paged_steps(bundle)


@pytest.mark.parametrize("layout", ["paged", "slot", "slot-monolithic"])
def test_engines_step_by_step_match_reference(bundle, layout):
    tp.check_engine(bundle, layout)


def test_prefix_cache_and_speculation_match_reference():
    """olmoe-smoke with the radix prefix cache and with k = 2 speculation
    (self-drafted): the reference's admissions, tables and tokens, step by
    step; the prefix cache hits (shared prompt openings) and the rounds
    accept."""
    bundle = _bundle("olmoe-1b-7b")
    eng = tp.check_engine(bundle, "paged", prefix_cache=True,
                          num_blocks=40, shared_prefix_len=12)
    assert eng.prefix_stats()["prefix_hits"] > 0
    eng = tp.check_engine(bundle, "paged", speculate=2, num_blocks=40)
    assert eng.spec_rounds > 0


def test_run_traffic_and_family_row_match_reference(monkeypatch):
    """``run_traffic`` on olmoe-smoke on both sides with the same prompts
    and parameters: every arm's tokens equal the reference's; its
    ``--config`` row equals the reference's flags and is token-identical
    to its static baseline."""
    import repro.launch.serve as jlaunch
    from repro.models.registry import make_synthetic_batch
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro_torch.launch import serve as launch
    jcfg = jax_smoke_config("olmoe-1b-7b")
    monkeypatch.setattr(launch, "synthetic_tokens", lambda cfg, b, s, seed:
                        np.asarray(make_synthetic_batch(
                            jcfg, b, s, seed=seed,
                            compute_dtype="float32")["tokens"], np.int32))
    seen = []
    drive = jlaunch.drive_continuous
    static = jlaunch.drive_static

    def rec(fn):
        def wrapped(eng, reqs, *a, **kw):
            out = fn(eng, reqs, *a, **kw)
            seen.append([r.output[:r.generated].tolist() for r in reqs])
            return out
        return wrapped

    monkeypatch.setattr(jlaunch, "drive_continuous", rec(drive))
    monkeypatch.setattr(jlaunch, "drive_static", rec(static))
    kw = dict(smoke=True, requests=4, slots=2, prompt_len=(9, 20),
              max_new=(3, 6), rate=400.0, seed=0, prefill_chunk=8,
              block_size=4)
    ref = jlaunch.run_traffic("olmoe-1b-7b", prefix_compare=False,
                              spec_compare=False, **kw)
    # the reference's run_traffic draws its own parameters: seed 0, as
    # they are
    params = tp.bundle("olmoe-1b-7b")[3]
    res = launch.run_traffic("olmoe-1b-7b", device="cpu", params=params,
                             prefix_compare=False, spec_compare=False, **kw)
    arms = res["outputs_by_arm"]
    assert [arms["continuous"], arms["continuous_monolithic"],
            arms["continuous_paged"], arms["static"]] == seen
    for key in ("parity_token_identical", "parity_token_identical_paged",
                "paged_token_identical_trace", "cache_len", "prefill_chunk"):
        assert res[key] == ref[key], key
    row = launch.run_family_rows(("olmoe-1b-7b",), device="cpu")[0]
    jrow = jlaunch.run_family_rows(("olmoe-1b-7b",))[0]
    for key in ("family", "block", "chunked_prefill", "paged_decode",
                "carried_state", "prefix_cache", "kv_migration",
                "speculative", "prefill_chunk", "static_tok_identical",
                "state_bytes_per_slot"):
        assert row[key] == jrow[key], key
    assert row["static_tok_identical"]

