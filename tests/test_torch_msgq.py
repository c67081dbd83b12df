"""Port msgq message copies vs the JAX reference.

On the CPU the port's wrapper (``repro_torch.kernels.msgq.ops``) takes
its plain version, ``ref.py``. ``msgq_copy`` is held against the
reference's ``msgq_copy`` run in interpret mode (its Pallas kernels) on
the grid of ``tests/test_kernels.py``: the copies must be equal bit for
bit and pick the same protocol. ``msgq_round`` — a whole message round
between the ranks of a rank-stacked region — is held against numpy, bit
for bit. ``msgq_program_ref`` — a collective's rounds folded into one
round program (``kernels/msgq/program.py``) — is held bit for bit against
a composition written here round by round from ``msgq_round_ref`` and
the torch ops the collectives used before the fold, for every folded
schedule, 2 to 8 ranks in one or two families, f32 / bf16 / int32 with
-0.0, NaN, negatives and int32 overflow. The inputs are made by numpy
from a seed.

The CUDA kernels run only on the card: the tests marked ``cuda`` skip
without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.msgq.ops import msgq_copy as jmsgq_copy
from repro_torch.core import collectives as coll
from repro_torch.core import schedules as sch
from repro_torch.core.compat import P, make_mesh, shard_map
from repro_torch.kernels.msgq import ops
from repro_torch.kernels.msgq.program import Program, Round
from repro_torch.kernels.msgq.ref import (msgq_copy_ref, msgq_program_ref,
                                          msgq_round_ref)

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


# ---------------------------------------------------------------------------
# round programs: the folded collectives against their rounds one by one
# ---------------------------------------------------------------------------

def _special(name, shape, seed):
    """Values with the edge cases of each dtype: -0.0, NaN and negatives
    (floats), the extremes that overflow a sum (int32)."""
    rng = np.random.default_rng(seed)
    if name == "int32":
        a = rng.integers(-2 ** 31, 2 ** 31 - 1, size=shape, dtype=np.int64)
        a.reshape(-1)[:4] = [2 ** 31 - 1, 2 ** 31 - 1, -2 ** 31, -1]
        return torch.from_numpy(a.astype(np.int32))
    a = rng.standard_normal(shape).astype(np.float32)
    flat = a.reshape(-1)
    idx = rng.permutation(flat.size)
    flat[idx[: flat.size // 6]] = -0.0
    flat[idx[flat.size // 6: flat.size // 6 + 2]] = np.nan
    flat[idx[-(flat.size // 6):]] *= -1e-30          # tiny negatives
    return torch.from_numpy(a).to(DTYPES[name][0])


def _pairs(F, n, local):
    """Local pairs in every family, as stacked ranks (process-major)."""
    return [(f * n + s, f * n + d) for f in range(F) for s, d in local]


def _local(F, n, device="cpu"):
    return torch.arange(F * n, device=device) % n


def _view(mask, x):
    return mask.reshape((x.shape[0],) + (1,) * (x.dim() - 1))


def _by_rounds(schedule, x, F, n, root):
    """The collective as it ran before the fold: one ``msgq_round_ref`` a
    round and the torch op of its step."""
    def exchange(v, rnd):
        return msgq_round_ref(v, _pairs(F, n, rnd))

    def reduce(v, r):
        for rnd in sch.binomial_reduce_rounds(n, r):
            v = v + exchange(v, rnd)
        return v

    def bcast(v, r):
        for rnd in sch.binomial_bcast_rounds(n, r):
            received = exchange(v, rnd)
            is_dst = torch.isin(_local(F, n, v.device), torch.tensor(
                [d for _, d in rnd], device=v.device))
            v = torch.where(_view(is_dst, v), received, v)
        return v

    if schedule == "barrier":
        for rnd in sch.dissemination_rounds(n):
            x = torch.maximum(x, exchange(x, rnd))
        return x
    if schedule == "reduce":
        return reduce(x, root)
    if schedule == "bcast":
        return bcast(x, root)
    if schedule == "recursive_doubling":
        for rnd in sch.recursive_doubling_rounds(n):
            x = x + exchange(x, rnd)
        return x
    if schedule == "reduce_bcast":
        x = reduce(x, 0)
        x = torch.where(_view(_local(F, n, x.device) == 0, x), x,
                        torch.zeros_like(x))
        return bcast(x, 0)
    # the ring: reduce-scatter and allgather, a chunk a rank a round
    R = x.shape[0]
    flat = x.reshape(R, -1)
    numel = flat.shape[1]
    pad = (-numel) % n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    chunks = flat.reshape(R, n, -1)
    c = chunks.shape[2]
    rank = _local(F, n, x.device)
    ring = sch.ring_rounds(n)[0]

    def at(idx):
        return (idx % n).view(R, 1, 1).expand(R, 1, c)

    for t in range(n - 1):
        blk = chunks.gather(1, at(rank - t))[:, 0]
        chunks = chunks.scatter_add(1, at(rank - t - 1),
                                    exchange(blk, ring)[:, None])
    for t in range(n - 1):
        blk = chunks.gather(1, at(rank - t + 1))[:, 0]
        chunks = chunks.scatter(1, at(rank - t), exchange(blk, ring)[:, None])
    return chunks.reshape(R, -1)[:, :numel].reshape(x.shape)


def _folded(schedule, x, F, n, root, device="cpu"):
    """The same collective through the port's collectives (one round
    program), over the "thread" axis of an F x n mesh."""
    mesh = make_mesh((F, n), ("proc", "thread"), device=device)
    axes = ("proc", "thread")

    def fn(v):
        if schedule == "barrier":
            return coll.barrier(v, "thread")
        if schedule == "reduce":
            return coll.reduce(v, "thread", root=root)
        if schedule == "bcast":
            return coll.bcast(v, "thread", root=root)
        return coll.allreduce(v, "thread", schedule=schedule)

    glob = x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))
    out = shard_map(fn, mesh=mesh, in_specs=P(axes),
                    out_specs=P(axes))(glob.to(device))
    return out.reshape(x.shape)


def _program_cases():
    cases = []
    for schedule in ("barrier", "reduce", "bcast", "recursive_doubling",
                     "ring", "reduce_bcast"):
        for n in (2, 3, 5, 8):
            if schedule == "recursive_doubling" and n & (n - 1):
                continue
            for dtype in (["float32"] if schedule == "barrier"
                          else list(DTYPES)):
                cases.append((schedule, n, dtype))
    return cases


@pytest.mark.parametrize("F", [1, 2])
@pytest.mark.parametrize("schedule,n,dtype", _program_cases())
def test_program_ref_matches_rounds(schedule, n, dtype, F):
    """Every folded collective equals its rounds one by one, bit for
    bit, and runs as ONE plain-version call on the CPU."""
    shape = (F * n, 1) if schedule == "barrier" else (F * n, 37)
    x = _special(dtype, shape, seed=n * 100 + F)
    root = n - 1
    ops.reset_counters()
    got = _folded(schedule, x, F, n, root)
    assert ops.counters() == {"eager_launches": 0, "one_copy_launches": 0,
                              "ref_calls": 1}
    want = _by_rounds(schedule, x, F, n, root)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_program_rounds_of_every_combine():
    """One program of every combine, rounds reading what the last one
    wrote, against the same rounds by hand."""
    x = _special("float32", (5, 12), seed=9)
    ring = [(i, (i + 1) % 5) for i in range(5)]
    part = [(0, 3), (4, 1)]
    # every rank sends chunk (r mod 3) of 4 elements and adds what it
    # receives into its chunk (r + 1) mod 3 ... (then overwrites it)
    chunked = [((s % 3) * 4, ((d + 1) % 3) * 4, 4) for s, d in ring]
    prog = Program([Round(ring, "copy"), Round(part, "add"),
                    Round(ring, "max"), Round(part, "replace"),
                    Round([(1, 1), (3, 3)], "mask"),
                    Round(ring, "add", chunked),
                    Round(ring, "replace", chunked)])
    v = msgq_round_ref(x, ring)
    v = v + msgq_round_ref(v, part)
    v = torch.maximum(v, msgq_round_ref(v, ring))
    is_dst = torch.tensor([False, True, False, True, False])
    v = torch.where(_view(is_dst, v), msgq_round_ref(v, part), v)
    v = torch.where(_view(is_dst, v), v, torch.zeros_like(v))
    for combine in ("add", "replace"):
        w = v.clone()
        for (s, d), (so, do, n) in zip(ring, chunked):
            w[d, do:do + n] = (v[d, do:do + n] + v[s, so:so + n]
                               if combine == "add" else v[s, so:so + n])
        v = w
    got = msgq_program_ref(x, prog)
    np.testing.assert_array_equal(_bits(got), _bits(w))
    ops.reset_counters()
    got = ops.msgq_program(x, prog, proto="eager")
    np.testing.assert_array_equal(_bits(got), _bits(w))
    assert ops.counters()["ref_calls"] == 1


def test_program_device_plan():
    """The kernels' layout: full-slab rounds alternate between the
    output and the scratch and end in the output; a leading segment round
    gets a copy of the input first and updates in place."""
    ring = [(i, (i + 1) % 4) for i in range(4)]
    plan = Program([Round(ring, "add")] * 3).device_plan(4, 8, 4)
    heads = [plan.words[8 * r: 8 * r + 8] for r in range(plan.rounds)]
    assert [(h[4], h[5]) for h in heads] == [(0, 1), (1, 2), (2, 1)]
    assert plan.scratch and plan.shapes == [4, 32] * 3 and plan.align == 16
    segs = [(2 * s, 2 * s, 2) for s, _ in ring]
    plan = Program([Round(ring, "replace", segs)]).device_plan(4, 8, 4)
    heads = [plan.words[8 * r: 8 * r + 8] for r in range(plan.rounds)]
    assert plan.rounds == 2 and not plan.scratch and plan.align == 8
    assert [(h[0], h[4], h[5]) for h in heads] == [(0, 0, 1), (3, 1, 1)]
    entries = plan.words[heads[1][2]: heads[1][2] + 4 * 4]
    assert entries[:4] == [0, 1, 0, 0] and entries[4:8] == [1, 2, 8, 8]
    # a segment add is atomic adds in place; in a 2-byte dtype whose
    # chunks do not fill whole 4-byte words, the messages are staged in
    # the scratch buffer first
    adds = Program([Round(ring, "add", segs)])
    plan = adds.device_plan(4, 8, 4)
    assert plan.rounds == 2 and plan.words[8] == 4 and not plan.scratch
    plan = adds.device_plan(4, 8, 2)
    assert plan.rounds == 2 and plan.words[8] == 4 and not plan.scratch
    odd = [(3 * s, 3 * s, 3) for s, _ in ring]
    plan = Program([Round(ring, "add", odd)]).device_plan(4, 12, 2)
    heads = [plan.words[8 * r: 8 * r + 8] for r in range(plan.rounds)]
    assert plan.scratch and [(h[0], h[4], h[5]) for h in heads] == [
        (0, 0, 1), (0, 1, 2), (4, 2, 1)]


def test_program_validates():
    with pytest.raises(ValueError, match="unknown combine"):
        Round([(0, 1)], "sum")
    with pytest.raises(ValueError, match="receives twice"):
        Round([(0, 1), (2, 1)], "add")
    with pytest.raises(ValueError, match="self pairs"):
        Round([(0, 1)], "mask")
    with pytest.raises(ValueError, match="add or replace"):
        Round([(0, 1)], "max", [(0, 0, 2)])
    with pytest.raises(ValueError, match="differ in length"):
        Round([(0, 1), (1, 0)], "add", [(0, 0, 2), (2, 2, 3)])
    with pytest.raises(ValueError, match="whole chunks"):
        Round([(0, 1), (1, 0)], "add", [(0, 2, 2), (3, 0, 2)])
    x = torch.zeros(4, 8)
    ring = [(i, (i + 1) % 4) for i in range(4)]
    with pytest.raises(ValueError, match="outside 0..3"):
        ops.msgq_program(x, Program([Round([(0, 4)])]), proto="eager")
    with pytest.raises(ValueError, match="every rank once"):
        ops.msgq_program(x, Program([Round([(0, 1)], "add", [(2, 2, 2)])]),
                         proto="eager")
    with pytest.raises(ValueError, match="do not tile"):
        ops.msgq_program(x, Program([Round(ring, "add", [(0, 3, 3)] * 4)]),
                         proto="eager")
    with pytest.raises(ValueError, match="outside a slab"):
        ops.msgq_program(x, Program([Round(ring, "add", [(0, 8, 2)] * 4)]),
                         proto="eager")
    # each rank would send the chunk it receives
    with pytest.raises(ValueError, match="sends the chunk"):
        ops.msgq_program(x, Program([Round(ring, "add", [(2, 2, 2)] * 4)]),
                         proto="eager")
    with pytest.raises(ValueError, match="per-rank slabs"):
        ops.msgq_program(torch.zeros(()), Program([]), proto="eager")
    with pytest.raises(ValueError, match="unknown protocol"):
        ops.msgq_program(x, Program([]), proto="bogus")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.msgq_program(torch.zeros(4, 8, device="meta"),
                         Program([Round(ring)]), proto="eager")


@pytest.mark.cuda
@pytest.mark.parametrize("schedule,n,dtype", [
    c for c in _program_cases() if c[1] in (3, 8)])
@pytest.mark.parametrize("elems", [37, 1024, 65536])
def test_cuda_programs_match_rounds(cuda_device, schedule, n, dtype, elems):
    """Each folded collective in ONE launch of its protocol's kernel on
    the card, bit for bit equal to its rounds one by one there."""
    F = 2
    shape = (F * n, 1) if schedule == "barrier" else (F * n, elems)
    x = _special(dtype, shape, seed=elems + n).to(cuda_device)
    ops.reset_counters()
    got = _folded(schedule, x, F, n, n - 1, device=cuda_device)
    torch.cuda.synchronize()
    c = ops.counters()
    assert c["eager_launches"] + c["one_copy_launches"] == 1
    assert c["ref_calls"] == 0
    want = _by_rounds(schedule, x, F, n, n - 1)
    np.testing.assert_array_equal(_bits(got.cpu()), _bits(want.cpu()))
