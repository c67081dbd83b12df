"""Port msgq message copies vs the JAX reference.

On the CPU the port's wrapper (``repro_torch.kernels.msgq.ops``) takes
its plain version, ``ref.py``. ``msgq_copy`` is held against the
reference's ``msgq_copy`` run in interpret mode (its Pallas kernels) on
the grid of ``tests/test_kernels.py``: the copies must be equal bit for
bit and pick the same protocol. ``msgq_round`` — a whole message round
between the ranks of a rank-stacked region — is held against numpy, bit
for bit. The inputs are made by numpy from a seed.

The CUDA kernels run only on the card: ``test_cuda_kernels_match_ref`` is
marked ``cuda`` and skips without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.msgq.ops import msgq_copy as jmsgq_copy
from repro_torch.kernels.msgq import ops
from repro_torch.kernels.msgq.ref import msgq_copy_ref, msgq_round_ref

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "int32": (torch.int32, jnp.int32)}


def _message(n, name, seed=0):
    rng = np.random.default_rng(seed)
    if name == "int32":
        a = rng.integers(-2 ** 31, 2 ** 31 - 1, size=n, dtype=np.int32)
    else:
        a = rng.standard_normal(n, dtype=np.float32)
    tdt, jdt = DTYPES[name]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a).astype(jdt)


def _bits(t):
    """A tensor's bytes as numpy uint8 (bf16 has no numpy dtype)."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def _jbits(a):
    return np.asarray(a).reshape(-1).view(np.uint8)


@pytest.mark.parametrize("nelems", [17, 256, 1024, 5000, 1 << 15])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_msgq_copy_matches_reference(nelems, dtype):
    msg, jmsg = _message(nelems, dtype, seed=nelems)
    out, proto = ops.msgq_copy(msg)
    jout, jproto = jmsgq_copy(jmsg)
    assert proto == jproto
    np.testing.assert_array_equal(_bits(out), _jbits(jout))
    np.testing.assert_array_equal(_bits(out), _bits(msgq_copy_ref(msg)))


@pytest.mark.parametrize("force", ["eager", "one_copy", "eager_fast",
                                   "rndv"])
def test_msgq_forced_protocols_match_reference(force):
    msg, jmsg = _message(3000, "float32", seed=1)
    out, proto = ops.msgq_copy(msg, force_protocol=force)
    jout, jproto = jmsgq_copy(jmsg, force_protocol=force)
    assert proto == jproto == force
    np.testing.assert_array_equal(_bits(out), _jbits(jout))


def test_msgq_multidim_and_bf16_cell_match_reference():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((7, 33, 5), dtype=np.float32)
    out, proto = ops.msgq_copy(torch.from_numpy(a))
    jout, jproto = jmsgq_copy(jnp.asarray(a))
    assert out.shape == (7, 33, 5) and proto == jproto
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    # bf16: the default cell is 1024 elements = 2048 bytes, so 2049-4096
    # bytes select "eager" (multi-cell), as in the reference
    for n in (1024, 1025, 2048, 2049):
        msg, jmsg = _message(n, "bfloat16", seed=n)
        out, proto = ops.msgq_copy(msg)
        jout, jproto = jmsgq_copy(jmsg)
        assert proto == jproto
        np.testing.assert_array_equal(_bits(out), _jbits(jout))
    assert ops.msgq_copy(_message(1025, "bfloat16")[0])[1] == "eager"


def _numpy_round(x, pairs):
    out = np.zeros_like(x)
    for s, d in pairs:
        out[d] = x[s]
    return out


RING = [(i, (i + 1) % 8) for i in range(8)]
PARTIAL = [(0, 3), (5, 1), (2, 2), (7, 0)]


@pytest.mark.parametrize("proto", ["eager", "one_copy"])
@pytest.mark.parametrize("pairs", [RING, PARTIAL, [], [(4, 4)]],
                         ids=["ring", "partial", "none", "self"])
@pytest.mark.parametrize("shape", [(8,), (8, 0), (8, 3), (8, 17),
                                   (8, 2, 33)])
def test_msgq_round_matches_numpy(proto, pairs, shape):
    x = np.random.default_rng(len(shape)).standard_normal(shape).astype(
        np.float32)
    t = torch.from_numpy(x)
    out = ops.msgq_round(t, pairs, proto=proto)
    assert out.data_ptr() != t.data_ptr() or t.numel() == 0
    np.testing.assert_array_equal(out.numpy(), _numpy_round(x, pairs))


def test_msgq_round_reads_strided_slabs():
    """The halo exchange hands in boundary planes as strided views."""
    x = np.random.default_rng(3).standard_normal((8, 4, 5, 6)).astype(
        np.float32)
    t = torch.from_numpy(x)
    for edge, ex in ((t[:, :1], x[:, :1]), (t[:, -1:], x[:, -1:])):
        assert ops.slab_stride(edge) == 4 * 5 * 6 * 4
        out = ops.msgq_round(edge, RING, proto="one_copy")
        np.testing.assert_array_equal(out.numpy(), _numpy_round(ex, RING))
    assert ops.slab_stride(t[:, :, :1]) is None


def test_msgq_round_counts_and_validates():
    x = torch.arange(8.0)
    ops.reset_counters()
    ops.msgq_round(x, RING, proto="eager_fast")
    ops.msgq_copy(x)
    assert ops.counters() == {"eager_launches": 0, "one_copy_launches": 0,
                              "ref_calls": 2}
    with pytest.raises(ValueError, match="receives twice"):
        ops.msgq_round(x, [(0, 1), (2, 1)], proto="eager")
    with pytest.raises(ValueError, match="outside"):
        ops.msgq_round(x, [(0, 8)], proto="eager")
    with pytest.raises(ValueError, match="unknown protocol"):
        ops.msgq_round(x, RING, proto="bogus")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.msgq_round(torch.zeros(8, device="meta"), RING, proto="eager")
    assert torch.equal(msgq_round_ref(x, [(1, 0)]),
                       torch.tensor([1.0] + [0.0] * 7))


def test_access_width():
    assert ops._width(4096, 256, 64) == 16
    assert ops._width(4096, 68) == 4
    assert ops._width(4096, 6) == 2
    assert ops._width(4096, 17) == 1
    assert ops._width(0, 0) == 16


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("proto", ["eager", "one_copy"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32, torch.uint8])
@pytest.mark.parametrize("shape", [(8,), (8, 0), (8, 3), (8, 17),
                                   (8, 1024), (8, 5000), (8, 16384)])
def test_cuda_kernels_match_ref(cuda_device, proto, dtype, shape):
    """Both kernels against the plain version on the card, bit for bit,
    on a ring and on a partial round."""
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randint(0, 255, shape, generator=g).to(cuda_device, dtype)
    for pairs in (RING, PARTIAL):
        ops.reset_counters()
        out = ops.msgq_round(x, pairs, proto=proto)
        torch.cuda.synchronize()
        c = ops.counters()
        assert (c["eager_launches"], c["one_copy_launches"]) == \
            ((1, 0) if proto == "eager" else (0, 1))
        np.testing.assert_array_equal(
            _bits(out.cpu()), _bits(msgq_round_ref(x, pairs).cpu()))
    msg = x.reshape(-1)
    out, proto_used = ops.msgq_copy(msg, force_protocol=proto)
    torch.cuda.synchronize()
    assert proto_used == proto and torch.equal(out, msgq_copy_ref(msg))
