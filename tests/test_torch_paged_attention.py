"""Port paged attention vs the JAX reference.

On the CPU the port's wrapper (``repro_torch.kernels.paged_attention.
ops.paged_attention``) takes its plain version, ``ref.py``; it is held
against the reference's oracle (``paged_attention_ref``) and against the
reference's Pallas kernel run in interpret mode, on the same inputs made
by numpy from a seed. Everything is float32; the tolerance (2e-5) is
the one the reference's own kernel tests use: the three compute the
same sums in different orders.

The CUDA kernels split the block table across CTAs and merge the
splits' partials; the launch plan (``ops.plan``) is plain Python and is
checked here, and so is a step-by-step float32 emulation of the split
and combine arithmetic (``ref.paged_attention_split_ref``), against the
same oracle and Pallas kernel.

The CUDA kernels run only on the card: the ``cuda`` tests skip without
one. The JAX side is imported inside the tests that use it, so the
``cuda`` tests also run where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref,
    paged_attention_split_ref,
    visible_entries,
)

TOL = 2e-5


def _inputs(B, H, Hkv, hd, P, bs, NB, K=0, seed=0, holes=False,
            parked=False):
    """Pool, tables and lengths from numpy. Each row gets a random
    length and a table of distinct pool blocks; ``holes`` punches -1
    entries inside live ranges, ``parked`` gives row 0 length 0 and an
    all -1 table. K = 0 makes a 3-D q; K >= 1 a (B, K, H, hd) q-block."""
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((P, bs, Hkv, hd), dtype=np.float32)
    vp = rng.standard_normal((P, bs, Hkv, hd), dtype=np.float32)
    qshape = (B, H, hd) if K == 0 else (B, K, H, hd)
    q = rng.standard_normal(qshape, dtype=np.float32)
    lengths = rng.integers(max(1, K), NB * bs + 1, size=B).astype(np.int32)
    tables = np.full((B, NB), -1, np.int32)
    for b in range(B):
        nb = -(-int(lengths[b]) // bs)
        tables[b, :nb] = rng.choice(P, size=nb, replace=False)
        if holes and nb > 1:
            tables[b, rng.integers(0, nb - 1)] = -1
    if parked:
        lengths[0] = 0
        tables[0] = -1
    return q, kp, vp, tables, lengths


def _both(args, **kw):
    import jax.numpy as jnp
    from repro.kernels.paged_attention.ops import paged_attention as jax_paged
    from repro.kernels.paged_attention.ref import (
        paged_attention_ref as jax_paged_ref,
    )
    q, kp, vp, tables, lengths = args
    port = ops.paged_attention(
        torch.as_tensor(q), torch.as_tensor(kp), torch.as_tensor(vp),
        torch.as_tensor(tables), torch.as_tensor(lengths), **kw).numpy()
    jargs = [jnp.asarray(a) for a in args]
    oracle = np.asarray(jax_paged_ref(*jargs, **kw))
    pallas = np.asarray(jax_paged(*jargs, interpret=True, **kw))
    return port, oracle, pallas


CASES = [
    (2, 4, 4, 16, 10, 8, 4),            # MHA
    (3, 4, 2, 32, 16, 16, 4),           # GQA
    (2, 8, 1, 64, 12, 8, 4),            # MQA (gemma's head grouping)
]


@pytest.mark.parametrize("B,H,Hkv,hd,P,bs,NB", CASES)
@pytest.mark.parametrize("K", [0, 1, 2, 4])
def test_port_matches_oracle_and_pallas(B, H, Hkv, hd, P, bs, NB, K):
    port, oracle, pallas = _both(_inputs(B, H, Hkv, hd, P, bs, NB, K=K))
    np.testing.assert_allclose(port, oracle, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(port, pallas, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("K", [0, 3])
@pytest.mark.parametrize("window", [4, 16])
def test_window(K, window):
    port, oracle, pallas = _both(_inputs(2, 4, 2, 16, 10, 8, 4, K=K, seed=1),
                                 window=window)
    np.testing.assert_allclose(port, oracle, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(port, pallas, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("K", [0, 3])
def test_softcap(K):
    port, oracle, pallas = _both(_inputs(2, 4, 2, 16, 10, 8, 4, K=K, seed=2),
                                 softcap=20.0)
    np.testing.assert_allclose(port, oracle, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(port, pallas, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("K", [0, 2])
def test_table_holes_and_parked_rows(K):
    """-1 entries inside a live range are skipped, and a parked row
    (length 0, all -1 table) yields the reference's finite garbage."""
    args = _inputs(4, 8, 1, 32, 24, 8, 5, K=K, seed=3, holes=True,
                   parked=True)
    port, oracle, pallas = _both(args)
    assert np.isfinite(port).all()
    np.testing.assert_allclose(port, oracle, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(port, pallas, atol=TOL, rtol=TOL)


def test_k1_block_equals_single_query():
    """A (B, 1, H, hd) q goes to the decode path and equals the 3-D call
    exactly; the K=1 q-block of the plain version reduces the same way."""
    q, kp, vp, tables, lengths = _inputs(3, 4, 2, 32, 16, 16, 4, seed=5)
    t = [torch.as_tensor(a) for a in (q, kp, vp, tables, lengths)]
    single = ops.paged_attention(*t)
    block = ops.paged_attention(t[0][:, None], *t[1:])
    assert block.shape == (3, 1, 4, 32)
    assert torch.equal(block[:, 0], single)
    ref_block = paged_attention_ref(t[0][:, None], *t[1:])
    assert torch.equal(ref_block[:, 0], single)


def test_block_scatter_invariance():
    """The output depends only on the table's order, not on where the
    blocks physically live in the pool."""
    q, kp, vp, tables, lengths = _inputs(2, 4, 2, 16, 10, 8, 4, K=3, seed=7)
    t = [torch.as_tensor(a) for a in (q, kp, vp, tables, lengths)]
    out = ops.paged_attention(*t)
    perm = np.random.default_rng(1).permutation(kp.shape[0])
    inv = np.argsort(perm)
    t2 = np.where(tables >= 0, inv[np.maximum(tables, 0)], -1)
    out2 = ops.paged_attention(t[0], torch.as_tensor(kp[perm]),
                               torch.as_tensor(vp[perm]),
                               torch.as_tensor(t2.astype(np.int32)), t[4])
    torch.testing.assert_close(out, out2, atol=2e-6, rtol=2e-6)


def test_cpu_counts_ref_calls_only():
    ops.reset_counters()
    args = _inputs(2, 4, 2, 16, 10, 8, 4, K=2)
    ops.paged_attention(*[torch.as_tensor(a) for a in args])
    assert ops.counters() == {"decode_launches": 0, "mq_launches": 0,
                              "ref_calls": 1}


def test_unsupported_device_raises():
    q = torch.zeros(1, 1, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.paged_attention(q, q, q, q, q)


def _sees_a_token(tables, lengths, K, bs):
    """(B, max(K, 1)) mask of the queries with at least one visible token;
    the others are garbage rows by contract (finite, not compared)."""
    B, NB = tables.shape
    Kq = max(K, 1)
    out = np.zeros((B, Kq), bool)
    for b in range(B):
        for j in range(Kq):
            qpos = int(lengths[b]) - Kq + j
            ents = tables[b, :min(NB, qpos // bs + 1)] if qpos >= 0 else []
            out[b, j] = bool((np.asarray(ents) >= 0).any())
    return out


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("K", [0, 1, 64])
def test_cuda_kernels_match_ref(cuda_device, dtype, tol, K):
    """Both kernels against the plain version on the card, gemma-2b heads
    (MQA, hd 256), with -1 holes and a parked row. Queries that see no
    token (the parked row, a hole under a query's whole range) only need
    to be finite: their garbage differs between the two by contract.
    K = 1 launches ``paged_mq`` directly and must equal the decode
    kernel bit for bit."""
    args = _inputs(6, 8, 1, 256, 64, 16, 8, K=K, seed=11, holes=True,
                   parked=True)
    seen = torch.as_tensor(_sees_a_token(args[3], args[4], K, 16))
    q, kp, vp, tables, lengths = [torch.as_tensor(a).to(cuda_device)
                                  for a in args]
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    out = ops.launch(q, kp, vp, tables, lengths)
    ref = paged_attention_ref(q, kp, vp, tables, lengths)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    o4, r4 = (out, ref) if K else (out[:, None], ref[:, None])
    seen = seen.to(cuda_device)
    torch.testing.assert_close(o4[seen].float(), r4[seen].float(), atol=tol,
                               rtol=tol)
    if K == 1:
        single = ops.launch(q[:, 0], kp, vp, tables, lengths)
        assert torch.equal(single[seen[:, 0]], out[:, 0][seen[:, 0]])


# ---------------------------------------------------------------------------
# the launch plan and the split + combine arithmetic (CPU)
# ---------------------------------------------------------------------------

#: (B, K, H, Hkv, bs, NB): the shapes ``chip_smoke.py`` phase 3 and the
#: serve phases launch (gemma-2b: H=8, Hkv=1; hymba-1.5b: H=25, Hkv=5;
#: hd 128 cases: H=16, Hkv=2); K = 1 is decode
PLAN_SHAPES = [
    (16, 1, 8, 1, 16, 35), (4, 64, 8, 1, 16, 16), (6, 1, 8, 2, 16, 35),
    (3, 64, 8, 2, 16, 32), (8, 1, 8, 1, 16, 19), (2, 64, 8, 1, 16, 19),
    (16, 64, 8, 1, 16, 35), (8, 1, 25, 5, 16, 19), (2, 128, 25, 5, 16, 19),
    (3, 1, 25, 5, 16, 163), (2, 128, 25, 5, 16, 163), (8, 1, 25, 5, 16, 40),
    (3, 128, 25, 5, 16, 40), (8, 1, 16, 2, 16, 40), (3, 64, 16, 2, 16, 40),
    (3, 64, 16, 2, 16, 163), (4, 64, 8, 1, 16, 16), (4, 1, 8, 1, 16, 16),
    (1, 1, 8, 1, 16, 1), (256, 1, 8, 1, 16, 19), (4, 2, 8, 1, 8, 12),
]


@pytest.mark.parametrize("B,K,H,Hkv,bs,NB", PLAN_SHAPES)
def test_plan_covers_every_entry_once(B, K, H, Hkv, bs, NB):
    """The splits cut each table into disjoint whole ring stages covering
    every entry exactly once, none empty; every (query, head) row falls
    in one row tile; and for any length and window the CTAs of a row tile
    read, between them, exactly the entries its queries can see."""
    pl = ops.plan(B, K, H, Hkv, bs, NB)
    R = H // Hkv
    M = 16 * pl.warps
    assert pl.warps == (1 if K * R <= 16 else 4)
    assert pl.row_tiles * M >= K * R > (pl.row_tiles - 1) * M
    assert pl.eps % (ops.TILE_TOKENS // bs) == 0
    ranges = [pl.split_range(s, NB) for s in range(pl.splits)]
    covered = [e for lo, hi in ranges for e in range(lo, hi)]
    assert covered == list(range(NB))
    assert all(lo < hi for lo, hi in ranges)
    # as many splits as bring the grid to the target, within a factor of
    # two (splits are whole stages of equal count), never more
    stages = -(-NB // (ops.TILE_TOKENS // bs))
    wanted = min(stages, -(-ops.TARGET_CTAS // (B * Hkv * pl.row_tiles)))
    assert wanted / 2 <= pl.splits <= wanted
    rng = np.random.default_rng(B * NB + K)
    for length in [-(2 ** 30) + 1, 0, 1, K, NB * bs,
                   *rng.integers(1, NB * bs + 1, size=6)]:
        for window in (0, 5, 3 * bs + 1):
            for rt in range(pl.row_tiles):
                f0, f1 = rt * M, min(rt * M + M, K * R)
                lo, hi = visible_entries(int(length), K, R, f0, f1, bs, NB,
                                         window)
                got = []
                for s in range(pl.splits):
                    a, b = pl.split_range(s, NB)
                    got += range(max(lo, a), min(hi, b))
                assert got == list(range(lo, hi))
                if length < 0:
                    assert hi == 0


def _seen(args, K, window=0):
    """(B, max(K, 1)) mask of the queries with a visible token, window
    included."""
    _, _, _, tables, lengths = args
    B, NB = tables.shape
    bs = args[1].shape[1]
    Kq = max(K, 1)
    out = np.zeros((B, Kq), bool)
    for b in range(B):
        for j in range(Kq):
            qpos = int(lengths[b]) - Kq + j
            lo = max(0, qpos - window + 1) if window > 0 else 0
            out[b, j] = any(t // bs < NB and tables[b, t // bs] >= 0
                            for t in range(lo, qpos + 1))
    return out


#: (label, B, H, Hkv, hd, P, bs, NB, K, window, softcap, target CTAs,
#: holes, parked, padding row)
SPLIT_CASES = [
    ("decode, splits of one stage", 3, 4, 2, 32, 60, 8, 20, 0, 0, 0.0, 10 ** 6,
     False, False, None),
    ("decode, holes and parked", 4, 8, 1, 32, 80, 8, 20, 0, 0, 0.0, 10 ** 6,
     True, True, None),
    ("decode, window, few splits", 3, 4, 2, 16, 60, 8, 20, 0, 9, 0.0, 8,
     False, True, None),
    ("chunk, empty splits", 2, 4, 2, 16, 60, 8, 24, 6, 0, 0.0, 10 ** 6,
     False, False, None),
    ("chunk, window and softcap", 3, 4, 2, 16, 60, 8, 20, 5, 12, 20.0,
     10 ** 6, True, False, None),
    ("chunk, padding row", 3, 8, 1, 16, 60, 16, 10, 4, 0, 0.0, 10 ** 6,
     True, True, 2),
    ("chunk, GQA 25/5, two row tiles", 2, 25, 5, 16, 60, 8, 20, 4, 0, 0.0,
     10 ** 6, False, False, None),
    ("K=1 block, one split", 3, 4, 2, 16, 60, 8, 20, 1, 0, 0.0, 1, True,
     True, None),
]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in
                                                   SPLIT_CASES])
def test_split_combine_matches_oracle_and_pallas(case):
    """The kernels' arithmetic (split table, online softmax per ring
    stage, partials merged in split order), emulated in float32, against
    the port's plain version, the reference's oracle and its Pallas
    kernel (interpret mode), on queries that see a token; the others
    (parked rows, an all -1 padding row, queries whose window holds only
    absent entries) come out as zeros, the kernels' contract."""
    import jax.numpy as jnp
    from repro.kernels.paged_attention.ops import paged_attention as jax_paged
    from repro.kernels.paged_attention.ref import (
        paged_attention_ref as jax_paged_ref,
    )
    (_, B, H, Hkv, hd, P, bs, NB, K, window, softcap, target, holes, parked,
     pad) = case
    args = _inputs(B, H, Hkv, hd, P, bs, NB, K=K, seed=B + NB + K,
                   holes=holes, parked=parked)
    if pad is not None:
        args[3][pad] = -1
    pl = ops.plan(B, max(K, 1), H, Hkv, bs, NB, target_ctas=target)
    kw = dict(window=window, softcap=softcap)
    t = [torch.as_tensor(a) for a in args]
    emu = paged_attention_split_ref(*t, plan=pl, tile_tokens=ops.TILE_TOKENS,
                                    **kw).numpy()
    port = ops.paged_attention(*t, **kw).numpy()
    jargs = [jnp.asarray(a) for a in args]
    oracle = np.asarray(jax_paged_ref(*jargs, **kw))
    pallas = np.asarray(jax_paged(*jargs, interpret=True, **kw))
    seen = _seen(args, K, window)
    if K == 0:
        emu, port, oracle, pallas = (x[:, None] for x in (emu, port, oracle,
                                                          pallas))
    assert seen.any() and not seen.all() or not (parked or pad is not None)
    for other in (port, oracle, pallas):
        np.testing.assert_allclose(emu[seen], other[seen], atol=TOL, rtol=TOL)
    assert not emu[~seen].any()
    if target == 10 ** 6 and NB * bs > ops.TILE_TOKENS:
        assert pl.splits > 1


def test_split_combine_rounds_p_like_the_pallas_kernel():
    """In bfloat16 the emulation rounds p to bf16 before p.v, as the
    Pallas kernel does: on bf16 inputs it agrees with the float32
    emulation to a few bf16 ulps of the output, not bit for bit."""
    args = _inputs(3, 8, 1, 32, 40, 8, 12, K=3, seed=21)
    t = [torch.as_tensor(a) for a in args]
    pl = ops.plan(3, 3, 8, 1, 8, 12, target_ctas=10 ** 6)
    t16 = [x.to(torch.bfloat16) if x.is_floating_point() else x for x in t]
    t32 = [x.float() if x.is_floating_point() else x for x in t16]
    lo = paged_attention_split_ref(*t16, plan=pl,
                                   tile_tokens=ops.TILE_TOKENS).float()
    hi = paged_attention_split_ref(*t32, plan=pl, tile_tokens=ops.TILE_TOKENS)
    err = float((lo - hi).abs().max())
    assert lo.dtype == torch.float32 and 0 < err < 3e-2


@pytest.mark.parametrize("hd,bs,msg", [(96, 16, "head dims"),
                                       (64, 24, "page sizes")])
def test_launch_rejects_unbuilt_shapes(hd, bs, msg):
    """Head dims and page sizes the kernels are not built for raise with
    a message, before any launch: there is no fallback."""
    q = torch.zeros(2, 4, hd)
    pages = torch.zeros(5, bs, 2, hd)
    tables = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match=msg):
        ops.launch(q, pages, pages, tables, torch.ones(2, dtype=torch.int32))


#: card cases at the split boundaries: (label, B, H, Hkv, hd, K, NB,
#: lengths as a function of the split edge (tokens), dead split, window as
#: a function of the edge); mirrors chip_smoke.py's split_edge_specs
EDGE_CASES = [
    (tag, H, Hkv, hd, B, K, kind)
    for tag, H, Hkv, hd in (("hymba", 25, 5, 64), ("hd128", 16, 2, 128))
    for B, K in ((8, 0), (3, 64 if hd == 128 else 128))
    for kind in ("edges", "dead split", "pre-window", "wide table")
]


def _edge_inputs(H, Hkv, hd, B, K, kind, bs=16):
    NB = 163 if kind == "wide table" else 40
    pl = ops.plan(B, max(K, 1), H, Hkv, bs, NB)
    edge = pl.eps * bs
    if kind == "edges":
        lengths = [n * edge + d for n in range(1, NB) for d in (-1, 0, 1)
                   if n * edge - 1 >= max(K, 1)][:B]
    elif kind == "wide table":
        lengths = np.linspace(max(K, 1), 300, B).astype(int).tolist()
    else:
        lengths = [NB * bs - 1 - b for b in range(B)]
    rng = np.random.default_rng(B + K + hd)
    P = NB * B + 8
    perm = rng.permutation(P)
    tables = np.full((B, NB), -1, np.int32)
    for b, n in enumerate(lengths):
        nb = -(-n // bs)
        tables[b, :nb] = perm[b * NB:b * NB + nb]
        if kind == "dead split":
            tables[b, pl.eps:2 * pl.eps] = -1
    kp = rng.standard_normal((P, bs, Hkv, hd), dtype=np.float32)
    vp = rng.standard_normal((P, bs, Hkv, hd), dtype=np.float32)
    qshape = (B, H, hd) if K == 0 else (B, K, H, hd)
    q = rng.standard_normal(qshape, dtype=np.float32)
    window = edge // 2 if kind == "pre-window" else 0
    return (q, kp, vp, tables, np.asarray(lengths, np.int32)), window


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("case", EDGE_CASES,
                         ids=[f"{c[0]}-K{c[5]}-{c[6]}" for c in EDGE_CASES])
def test_cuda_split_edges(cuda_device, dtype, tol, case):
    """Both kernels at the split boundaries of their launch plan: lengths
    at a split's edge and one either side, a split wholly of -1 entries,
    a split wholly before the window, tables far wider than the lengths;
    against the plain version, and twice, bit for bit (the combine merges
    in a fixed order, with no atomics)."""
    tag, H, Hkv, hd, B, K, kind = case
    args, window = _edge_inputs(H, Hkv, hd, B, K, kind)
    seen = torch.as_tensor(_seen(args, K, window)).to(cuda_device)
    q, kp, vp, tables, lengths = [torch.as_tensor(a).to(cuda_device)
                                  for a in args]
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    out = ops.launch(q, kp, vp, tables, lengths, window=window)
    again = ops.launch(q, kp, vp, tables, lengths, window=window)
    ref = paged_attention_ref(q, kp, vp, tables, lengths, window=window)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert torch.isfinite(out.float()).all()
    o4, r4 = (out, ref) if K else (out[:, None], ref[:, None])
    torch.testing.assert_close(o4[seen].float(), r4[seen].float(), atol=tol,
                               rtol=tol)
