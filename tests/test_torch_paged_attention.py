"""Port paged attention vs the JAX reference.

On the CPU the port's wrapper (``repro_torch.kernels.paged_attention.
ops.paged_attention``) takes its plain version, ``ref.py``; it is held
against the reference's oracle (``paged_attention_ref``) and against the
reference's Pallas kernel run in interpret mode, on the same inputs made
by numpy from a seed. Everything is float32; the tolerance (2e-5) is
the one the reference's own kernel tests use: the three compute the
same sums in different orders.

The CUDA kernels run only on the card: ``test_cuda_kernels_match_ref``
is marked ``cuda`` and skips without one. The JAX side is imported inside
the tests that use it, so the ``cuda`` test also runs where JAX is not
installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

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
