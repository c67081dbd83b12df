"""Port threadcomm layer vs the JAX reference.

The port (``repro_torch.core``) runs every rank of a mesh on one device
as one rank-stacked program (``core/compat.py``); the reference runs one
shard per device under ``shard_map``. Three kinds of check:

* lifecycle rules of the Comm API, as ``tests/test_comm_api.py`` states
  them for the reference;
* host-side rank arithmetic — families, split/dup, ``_axis_aligned``,
  translate — against the reference's own ``ThreadComm`` built over a
  stand-in mesh (it reads only the axis names and the device grid's
  shape), in process;
* the multi-rank cases of ``tests/mp_cases.py`` (``collectives_flat``,
  ``threadcomm_unified``, ``p2p_protocols``, ``comm_subcomm_collectives``,
  ``comm_requests``) on the same inputs, made by numpy from a seed: the
  reference computes its outputs once, in ONE subprocess with 8 fake
  host devices (this file run as ``python -m tests.test_torch_comm
  OUT.npz``), and every port output is held against its twin. Message
  rounds move the same bytes in the same order, so sums agree to f32
  rounding: rtol 1e-5 (the reference's own tolerance); copies and
  integer outputs exactly.
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8


def _inputs():
    rng = np.random.default_rng(0)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"x": f32(N), "big": f32(N, 24), "odd": f32(N, 13),
            "vec": f32(N * 4), "mat": f32(N, N), "col": f32(N, 2),
            "e64": f32(N, 64), "e1024": f32(N, 1024), "e65536": f32(N, 1 << 16),
            "halo": f32(N, 4), "payload": f32(N, 8)}


RING = [(i, (i + 1) % N) for i in range(N)]
SHIFT2 = [(i, (i + 2) % N) for i in range(N)]
TRING = [(i, (i + 1) % 4) for i in range(4)]
SCHEDULES = ("psum", "recursive_doubling", "ring", "reduce_bcast")


# ---------------------------------------------------------------------------
# the reference side: runs with 8 fake host devices, in a subprocess
# ---------------------------------------------------------------------------

def reference_outputs(inp):
    """Every op of one input and mesh runs in ONE jitted shard_map (one
    compile; an eager shard_map compiles each primitive), returning a
    tuple."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.core import collectives as coll
    from repro.core import p2p, protocol
    from repro.core.comm import threadcomm_init, waitall
    from repro.core.compat import make_mesh, shard_map

    out = {}
    flat = make_mesh((N,), ("ranks",))
    a = {k: jnp.asarray(v) for k, v in inp.items()}

    def run(fns, x, ins=P("ranks"), outs=P("ranks"), **kw):
        names = list(fns)
        res = jax.jit(shard_map(lambda v: tuple(fns[n](v) for n in names),
                                mesh=flat, in_specs=ins,
                                out_specs=tuple(outs for _ in names),
                                **kw))(x)
        out.update({n: np.asarray(r) for n, r in zip(names, res)})

    # -- collectives_flat / p2p_protocols --------------------------------
    run({"cf_barrier_msg": lambda v: coll.barrier(v[0], "ranks")[None],
         "cf_barrier_atomic": lambda v: coll.barrier(
             v[0], "ranks", mode="atomic")[None],
         "cf_reduce_root0": lambda v: coll.reduce(v, "ranks", root=0),
         "cf_reduce_root3": lambda v: coll.reduce(v, "ranks", root=3),
         "cf_reduce_psum": lambda v: coll.reduce(v, "ranks",
                                                 schedule="psum"),
         "cf_bcast_root5": lambda v: coll.bcast(v, "ranks", root=5),
         "cf_sendrecv_shift2": lambda v: coll.sendrecv(v, "ranks", SHIFT2),
         "p2p_shift3": lambda v: p2p.shift(v, "ranks", N, 3)}, a["x"])
    for key in ("big", "odd"):
        fns = {f"cf_allreduce_{s}_{key}": (
            lambda v, s=s: coll.allreduce(v, "ranks", schedule=s))
            for s in SCHEDULES}
        if key == "big":
            fns["cf_allreduce_wire_bf16"] = lambda v: coll.allreduce(
                v, "ranks", wire_dtype=jnp.bfloat16)
        run(fns, a[key])
    run({"cf_rs_ag": lambda v: coll.allgather(
        coll.reduce_scatter(v, "ranks"), "ranks")}, a["vec"], ins=P(None),
        outs=P(None), check_vma=False)
    run({"cf_allgather_stacked": lambda v: coll.allgather(v, "ranks",
                                                          tiled=False)},
        a["col"])
    run({"cf_alltoall": lambda v: coll.alltoall(
        v.reshape(N, 1), "ranks").reshape(1, N)}, a["mat"])
    for key in ("e64", "e1024", "e65536"):
        run({f"p2p_send_recv_{key}": lambda v: p2p.send_recv(
            v, "ranks", RING)[0]}, a[key])
        out[f"p2p_proto_{key}"] = np.array(protocol.select_protocol(
            inp[key][0].nbytes))
    run({"p2p_halo": lambda v: jnp.concatenate(
        p2p.halo_exchange_1d(v, "ranks", N), 0)}, a["halo"])

    # -- threadcomm_unified / comm_subcomm_collectives / comm_requests --
    mesh = make_mesh((2, 4), ("proc", "thread"))
    tc = threadcomm_init(mesh, process_axes=("proc",),
                         thread_axes=("thread",), num_threads=4)
    out["tu_host"] = np.array([
        tc.size, tc.num_processes, tc.threads_per_process,
        tc.rank_of({"proc": 1, "thread": 2}), tc.process_of(5),
        tc.thread_of(5), tc.coords_of(6)["proc"], tc.coords_of(6)["thread"]])

    def r(fns, x):
        names = list(fns)
        res = jax.jit(lambda y: tc.run(
            lambda v: tuple(fns[n](v) for n in names), y,
            out_specs=tuple(P(tc.unified_axes) for _ in names)))(x)
        out.update({n: np.asarray(q) for n, q in zip(names, res)})

    overheads = []

    def isend(comm, pairs):
        def f(v):
            req = comm.isend(v, pairs)
            overheads.append(req.model_overhead_s)
            return req.wait()
        return f

    with tc.start():
        sub = tc.split([q // 4 for q in range(N)])
        g = tc.split([q % 2 for q in range(N)])
        tcm, pcm = tc.thread_comm(), tc.process_comm()

        def pipeline(v):
            flat_v = v.reshape(-1)
            with tc.stream("grad"):
                r1 = tcm.ireduce_scatter(flat_v)
                r2 = pcm.iallreduce(r1.wait())
                full = tcm.iallgather(r2.wait()).wait()
            return full.reshape(v.shape)

        def many(v):
            q1, q2 = waitall([tc.iallreduce(v), tc.iallreduce(2 * v)])
            return q1 + q2

        r({"tu_device_rank": lambda v: v + tc.device_rank().astype(
            jnp.float32),
           "tu_allreduce_rd": lambda v: tc.allreduce(
               v, schedule="recursive_doubling"),
           "tu_root_bcast2": lambda v: tc.bcast(v, root=2),
           "tu_root_barrier": lambda v: tc.barrier(v[0])[None],
           "sc_split_allreduce": lambda v: sub.allreduce(v),
           "sc_group_allreduce": lambda v: g.allreduce(v),
           "sc_group_bcast": lambda v: g.bcast(v, root=1),
           "sc_group_barrier": lambda v: g.barrier(v[0])[None],
           "sc_group_send_recv": lambda v: g.send_recv(v, [(0, 2)]),
           "sc_thread_send_recv": lambda v: tcm.send_recv(v, TRING),
           "sc_process_bcast": lambda v: pcm.bcast(v, root=1),
           "rq_iallreduce": lambda v: tc.iallreduce(v).wait(),
           "rq_waitall": many,
           "rq_isend_thread": isend(tcm, TRING),
           "rq_isend_root": isend(tc, RING)}, a["x"])
        fns = {f"tu_allreduce_{s}": (lambda v, s=s: tc.allreduce(
            v, schedule=s)) for s in ("psum", "hierarchical",
                                      "hierarchical_tree", "ring")}
        fns.update({
            "tu_hier_native": lambda v: coll.hierarchical_allreduce(
                v, process_axes=("proc",), thread_axes=("thread",)),
            "sc_group_wire_bf16": lambda v: g.allreduce(
                v, wire_dtype=jnp.bfloat16),
            "sc_process_ring": lambda v: pcm.allreduce(v, schedule="ring")})
        r(fns, a["odd"])
        r({"sc_group_allgather_stacked": lambda v: g.allgather(
            v, tiled=False)[None],
           "sc_group_allgather_tiled": lambda v: g.allgather(v)}, a["col"])
        r({"sc_group_reduce_scatter": lambda v: g.reduce_scatter(v),
           "sc_thread_reduce_scatter": lambda v: tcm.reduce_scatter(
               v.reshape(-1)),
           "sc_thread_alltoall": lambda v: tcm.alltoall(
               v.reshape(4, 2)).reshape(1, 8),
           "rq_pipeline": pipeline}, a["payload"])
        r({"rq_isend_big": isend(tcm, TRING)}, a["e1024"])
        out["rq_overheads"] = np.array(overheads)
    tc.free()
    return out


# ---------------------------------------------------------------------------
# the port side: every rank on the CPU, one rank-stacked program
# ---------------------------------------------------------------------------

def port_outputs(inp):
    from repro_torch.core import collectives as coll
    from repro_torch.core import p2p, protocol
    from repro_torch.core.comm import threadcomm_init, waitall
    from repro_torch.core.compat import P, make_mesh, rank_view, shard_map

    out = {}
    flat = make_mesh((N,), ("ranks",), device="cpu")
    a = {k: torch.from_numpy(v) for k, v in inp.items()}

    def run(fn, x, ins=P("ranks"), outs=P("ranks")):
        return shard_map(fn, mesh=flat, in_specs=ins, out_specs=outs)(x)

    for mode in ("msg", "atomic"):
        out[f"cf_barrier_{mode}"] = run(
            lambda v: coll.barrier(v[:, 0], "ranks", mode=mode)[:, None],
            a["x"])
    for root in (0, 3):
        out[f"cf_reduce_root{root}"] = run(
            lambda v: coll.reduce(v, "ranks", root=root), a["x"])
    out["cf_reduce_psum"] = run(
        lambda v: coll.reduce(v, "ranks", schedule="psum"), a["x"])
    out["cf_bcast_root5"] = run(lambda v: coll.bcast(v, "ranks", root=5),
                                a["x"])
    for s in SCHEDULES:
        for key in ("big", "odd"):
            out[f"cf_allreduce_{s}_{key}"] = run(
                lambda v: coll.allreduce(v, "ranks", schedule=s), a[key])
    out["cf_allreduce_wire_bf16"] = run(
        lambda v: coll.allreduce(v, "ranks", wire_dtype=torch.bfloat16),
        a["big"])
    out["cf_rs_ag"] = run(
        lambda v: coll.allgather(coll.reduce_scatter(v, "ranks"), "ranks"),
        a["vec"], ins=P(None), outs=P(None))
    out["cf_allgather_stacked"] = run(
        lambda v: coll.allgather(v, "ranks", tiled=False), a["col"])
    out["cf_alltoall"] = run(
        lambda v: coll.alltoall(v.reshape(N, N, 1), "ranks").reshape(N, 1, N),
        a["mat"])
    out["cf_sendrecv_shift2"] = run(lambda v: coll.sendrecv(v, "ranks",
                                                            SHIFT2), a["x"])

    for key in ("e64", "e1024", "e65536"):
        protos = []

        def sr(v):
            recv, proto = p2p.send_recv(v, "ranks", RING)
            protos.append(proto)
            return recv
        out[f"p2p_send_recv_{key}"] = run(sr, a[key])
        out[f"p2p_proto_{key}"] = np.array(protos[0])
        assert protos[0] == protocol.select_protocol(inp[key][0].nbytes)
    out["p2p_halo"] = run(
        lambda v: torch.cat(p2p.halo_exchange_1d(v, "ranks", N), 1),
        a["halo"])
    out["p2p_shift3"] = run(lambda v: p2p.shift(v, "ranks", N, 3), a["x"])

    mesh = make_mesh((2, 4), ("proc", "thread"), device="cpu")
    tc = threadcomm_init(mesh, process_axes=("proc",),
                         thread_axes=("thread",), num_threads=4)
    out["tu_host"] = np.array([
        tc.size, tc.num_processes, tc.threads_per_process,
        tc.rank_of({"proc": 1, "thread": 2}), tc.process_of(5),
        tc.thread_of(5), tc.coords_of(6)["proc"], tc.coords_of(6)["thread"]])
    with tc.start():
        x, odd = a["x"], a["odd"]
        r = tc.run
        out["tu_device_rank"] = r(
            lambda v: v + rank_view(tc.device_rank(), v), x)
        out["tu_allreduce_rd"] = r(
            lambda v: tc.allreduce(v, schedule="recursive_doubling"), x)
        for s in ("psum", "hierarchical", "hierarchical_tree", "ring"):
            out[f"tu_allreduce_{s}"] = r(
                lambda v: tc.allreduce(v, schedule=s), odd)
        out["tu_hier_native"] = r(lambda v: coll.hierarchical_allreduce(
            v, process_axes=("proc",), thread_axes=("thread",)), odd)
        out["tu_root_bcast2"] = r(lambda v: tc.bcast(v, root=2), x)
        out["tu_root_barrier"] = r(lambda v: tc.barrier(v[:, 0])[:, None], x)

        sub = tc.split([q // 4 for q in range(N)])
        out["sc_split_allreduce"] = r(lambda v: sub.allreduce(v), x)
        g = tc.split([q % 2 for q in range(N)])
        out["sc_group_allreduce"] = r(lambda v: g.allreduce(v), x)
        out["sc_group_bcast"] = r(lambda v: g.bcast(v, root=1), x)
        out["sc_group_barrier"] = r(lambda v: g.barrier(v[:, 0])[:, None], x)
        out["sc_group_allgather_stacked"] = r(
            lambda v: g.allgather(v, tiled=False)[:, None], a["col"])
        out["sc_group_allgather_tiled"] = r(lambda v: g.allgather(v),
                                            a["col"])
        out["sc_group_reduce_scatter"] = r(lambda v: g.reduce_scatter(v),
                                           a["payload"])
        out["sc_group_wire_bf16"] = r(
            lambda v: g.allreduce(v, wire_dtype=torch.bfloat16), odd)
        out["sc_group_send_recv"] = r(lambda v: g.send_recv(v, [(0, 2)]), x)
        tcm, pcm = tc.thread_comm(), tc.process_comm()
        out["sc_thread_send_recv"] = r(lambda v: tcm.send_recv(v, TRING), x)
        out["sc_thread_reduce_scatter"] = r(
            lambda v: tcm.reduce_scatter(v.reshape(N, -1)), a["payload"])
        out["sc_thread_alltoall"] = r(
            lambda v: tcm.alltoall(v.reshape(N, 4, 2)).reshape(N, 1, 8),
            a["payload"])
        out["sc_process_ring"] = r(
            lambda v: pcm.allreduce(v, schedule="ring"), odd)
        out["sc_process_bcast"] = r(lambda v: pcm.bcast(v, root=1), x)

        out["rq_iallreduce"] = r(lambda v: tc.iallreduce(v).wait(), x)

        def pipeline(v):
            flat_v = v.reshape(v.shape[0], -1)
            with tc.stream("grad") as s:
                r1 = tcm.ireduce_scatter(flat_v)
                r2 = pcm.iallreduce(r1.wait())
                full = tcm.iallgather(r2.wait()).wait()
                assert len(s._requests) == 3
            return full.reshape(v.shape)
        out["rq_pipeline"] = r(pipeline, a["payload"])

        def many(v):
            q1, q2 = waitall([tc.iallreduce(v), tc.iallreduce(2 * v)])
            return q1 + q2
        out["rq_waitall"] = r(many, x)
        overheads = []

        def isend(comm, pairs):
            def f(v):
                req = comm.isend(v, pairs)
                overheads.append(req.model_overhead_s)
                assert req.test() == (True, req._value)
                return req.wait()
            return f
        out["rq_isend_thread"] = r(isend(tcm, TRING), x)
        out["rq_isend_root"] = r(isend(tc, RING), x)
        out["rq_isend_big"] = r(isend(tcm, TRING), a["e1024"])
        out["rq_overheads"] = np.array(overheads)
    tc.free()
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("comm") / "reference.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={N}",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src"), ROOT,
                    os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-m", "tests.test_torch_comm",
                           str(path)], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(path) as z:
        return dict(z)


@pytest.fixture(scope="module")
def port():
    return port_outputs(_inputs())


KEYS = (["cf_barrier_msg", "cf_barrier_atomic", "cf_reduce_root0",
         "cf_reduce_root3", "cf_reduce_psum", "cf_bcast_root5"]
        + [f"cf_allreduce_{s}_{k}" for s in SCHEDULES for k in ("big", "odd")]
        + ["cf_allreduce_wire_bf16", "cf_rs_ag", "cf_allgather_stacked",
           "cf_alltoall", "cf_sendrecv_shift2"]
        + [f"p2p_{w}_{k}" for k in ("e64", "e1024", "e65536")
           for w in ("send_recv", "proto")]
        + ["p2p_halo", "p2p_shift3", "tu_host", "tu_device_rank",
           "tu_allreduce_rd"]
        + [f"tu_allreduce_{s}" for s in ("psum", "hierarchical",
                                          "hierarchical_tree", "ring")]
        + ["tu_hier_native", "tu_root_bcast2", "tu_root_barrier",
           "sc_split_allreduce", "sc_group_allreduce", "sc_group_bcast",
           "sc_group_barrier", "sc_group_allgather_stacked",
           "sc_group_allgather_tiled", "sc_group_reduce_scatter",
           "sc_group_wire_bf16", "sc_group_send_recv",
           "sc_thread_send_recv", "sc_thread_reduce_scatter",
           "sc_thread_alltoall", "sc_process_ring", "sc_process_bcast",
           "rq_iallreduce", "rq_pipeline", "rq_waitall", "rq_isend_thread",
           "rq_isend_root", "rq_isend_big", "rq_overheads"])


def test_keys_cover_both_sides(reference, port):
    assert sorted(KEYS) == sorted(reference) == sorted(port)


@pytest.mark.parametrize("key", KEYS)
def test_port_matches_reference(reference, port, key):
    want, got = reference[key], port[key]
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype.kind in "fc":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# rank-dim bookkeeping: every op on per-rank values of rank 0, 1 and 2
# ---------------------------------------------------------------------------

def _class_of(groups, r):
    return next(g for g in groups if r in g)


ROUND_OPS = {
    **{f"allreduce_{s}": (lambda tc, v, s=s: tc.allreduce(v, schedule=s),
                          lambda x, r: x.sum(0))
       for s in SCHEDULES + ("hierarchical", "hierarchical_tree")},
    "allreduce_wire_f32": (lambda tc, v: tc.allreduce(v, wire_dtype="float32"),
                           lambda x, r: x.sum(0)),
    "reduce_root3": (lambda tc, v: tc.reduce(v, root=3),
                     lambda x, r: x.sum(0) if r == 3 else None),
    "bcast_root5": (lambda tc, v: tc.bcast(v, root=5), lambda x, r: x[5]),
    "send_recv_ring": (lambda tc, v: tc.send_recv(v, RING),
                       lambda x, r: x[(r - 1) % N]),
    "send_recv_eager": (lambda tc, v: tc.send_recv(
        v, RING, force_protocol="eager"), lambda x, r: x[(r - 1) % N]),
    "thread_allreduce": (lambda tc, v: tc.thread_comm().allreduce(v),
                         lambda x, r: x[r // 4 * 4:r // 4 * 4 + 4].sum(0)),
    "process_bcast": (lambda tc, v: tc.process_comm().bcast(v, root=1),
                      lambda x, r: x[4 + r % 4]),
    "parity_allreduce": (
        lambda tc, v: tc.split([q % 2 for q in range(N)]).allreduce(v),
        lambda x, r: x[r % 2::2].sum(0)),
    "parity_bcast": (
        lambda tc, v: tc.split([q % 2 for q in range(N)]).bcast(v, root=1),
        lambda x, r: x[2 + r % 2]),
    "parity_allgather": (
        lambda tc, v: tc.split([q % 2 for q in range(N)]).allgather(
            v, tiled=False), lambda x, r: x[r % 2::2]),
    "thread_allgather": (
        lambda tc, v: tc.thread_comm().allgather(v, tiled=False),
        lambda x, r: x[r // 4 * 4:r // 4 * 4 + 4]),
}


@pytest.mark.parametrize("local", [(), (5,), (3, 4)],
                         ids=["rank0", "rank1", "rank2"])
@pytest.mark.parametrize("op", list(ROUND_OPS))
def test_per_rank_values_of_rank_0_1_2(op, local):
    """Per-rank values of local shape ``local`` stay (R, *local): a
    per-rank scalar never broadcasts into (R, R, ...). Held against
    numpy, rank by rank."""
    from repro_torch.core.comm import threadcomm_init
    from repro_torch.core.compat import make_mesh
    fn, want = ROUND_OPS[op]
    x = np.random.default_rng(len(local)).standard_normal(
        (N,) + local).astype(np.float32)
    tc = threadcomm_init(make_mesh((2, 4), ("proc", "thread"), device="cpu"),
                         process_axes=("proc",), thread_axes=("thread",))
    with tc.start():
        # each rank's shard of x is (1, *local): v[:, 0] is (R, *local)
        got = tc.run(lambda v: fn(tc, v[:, 0])[:, None],
                     torch.from_numpy(x)).numpy()
    tc.free()
    for r in range(N):
        expect = want(x, r)
        if expect is not None:
            assert got[r].shape == np.shape(expect), (r, got[r].shape)
            np.testing.assert_allclose(got[r], expect, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# host-side rank arithmetic against the reference, in process
# ---------------------------------------------------------------------------

def _pair(shape, names, process_axes, thread_axes):
    """The reference's ThreadComm over a stand-in mesh (no devices) and
    the port's over a CPU mesh."""
    from repro.core.comm import threadcomm_init as jinit
    from repro_torch.core.comm import threadcomm_init as tinit
    from repro_torch.core.compat import make_mesh

    stand_in = types.SimpleNamespace(axis_names=tuple(names),
                                     devices=np.empty(shape))
    return (jinit(stand_in, process_axes, thread_axes),
            tinit(make_mesh(shape, names, device="cpu"), process_axes,
                  thread_axes))


def _describe(comm):
    out = {"type": type(comm).__name__, "families": comm.families()}
    if hasattr(comm, "axes"):
        out["axes"] = comm.axes
    if hasattr(comm, "groups"):
        out["groups"] = comm.groups
    return out


MESHES = [((2, 4), ("proc", "thread"), ("proc",), ("thread",)),
          ((4, 2), ("proc", "thread"), ("proc",), ("thread",)),
          ((8,), ("ranks",), (), ("ranks",)),
          ((2, 2, 2), ("pod", "data", "model"), ("pod",), ("data", "model"))]
SPLITS = {
    "by_process": lambda r, tc: tc.process_of(r),
    "by_thread": lambda r, tc: tc.thread_of(r),
    "constant": lambda r, tc: 0,
    "parity": lambda r, tc: r % 2,
    "halves": lambda r, tc: r * 2 // tc.size,
    "undefined_half": lambda r, tc: 0 if r < tc.size // 2 else -1,
}


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(
    map(str, m[0])) if isinstance(m, tuple) else None)
@pytest.mark.parametrize("split", list(SPLITS))
def test_split_dup_families_translate_match_reference(mesh, split):
    jtc, ttc = _pair(*mesh)
    with jtc.start(), ttc.start():
        for name in ("thread_comm", "process_comm", "dup"):
            j, t = getattr(jtc, name)(), getattr(ttc, name)()
            assert _describe(t) == _describe(j), name
            for fam in range(len(j.families())):
                for lr in range(j.size):
                    assert t.translate(lr, fam) == j.translate(lr, fam)
        color = [SPLITS[split](r, jtc) for r in range(jtc.size)]
        j, t = jtc.split(color), ttc.split(color)
        assert _describe(t) == _describe(j)
        key = list(range(jtc.size))[::-1]
        assert (_describe(ttc.split(color, key))
                == _describe(jtc.split(color, key)))
        assert _describe(t.dup()) == _describe(j.dup())
        assert t._is_interthread() == j._is_interthread()
        for fam in range(len(j.families())):
            for lr in range(len(j.families()[fam])):
                assert t.translate(lr, fam) == j.translate(lr, fam)


def test_parity_split_is_a_group_comm():
    _, tc = _pair(*MESHES[0])
    with tc.start():
        g = tc.split([r % 2 for r in range(tc.size)])
        assert type(g).__name__ == "GroupComm"
        assert g.groups == ((0, 2, 4, 6), (1, 3, 5, 7))
        assert g.translate(1, family=1) == 3


# ---------------------------------------------------------------------------
# lifecycle rules (tests/test_comm_api.py, for the port)
# ---------------------------------------------------------------------------

def _single_rank_comm():
    from repro_torch.core.comm import threadcomm_init
    from repro_torch.core.compat import make_mesh
    return threadcomm_init(make_mesh((1,), ("ranks",), device="cpu"),
                           process_axes=(), thread_axes=("ranks",))


def test_inactive_comm_refuses_everything():
    from repro_torch.core.comm import ThreadCommError
    tc = _single_rank_comm()
    for call in (lambda: tc.thread_comm(), lambda: tc.dup(),
                 lambda: tc.split([0]), lambda: tc.stream("s"),
                 lambda: tc.group([0]), lambda: tc.run(lambda v: v,
                                                       torch.ones(1))):
        with pytest.raises(ThreadCommError):
            call()


def test_service_mode_start_finish_free():
    from repro_torch.core.comm import ThreadCommError
    tc = _single_rank_comm()
    tc.start()                      # bare start: long-lived activation
    sub = tc.thread_comm()
    assert sub.size == 1
    with pytest.raises(ThreadCommError):
        tc.start()                  # nested start forbidden
    with pytest.raises(ThreadCommError):
        tc.free()                   # free-while-active forbidden
    tc.finish()
    with pytest.raises(ThreadCommError):
        sub.dup()                   # derived object died at finish
    with pytest.raises(ThreadCommError):
        tc.finish()                 # unmatched finish
    tc.free()
    with pytest.raises(ThreadCommError):
        tc.start()                  # freed comm is gone


def test_split_validation():
    from repro_torch.core.comm import ThreadCommError
    tc = _single_rank_comm()
    with tc.start():
        with pytest.raises(ThreadCommError):
            tc.split([0, 1])        # wrong color length
        with pytest.raises(ThreadCommError):
            tc.split([0], key=[0, 1])   # wrong key length
        assert tc.split([-1]).families() == []


def test_epoch_invalidation_across_finish():
    """Derived comms, groups, attributes and requests die at finish."""
    from repro_torch.core.comm import ThreadCommError, threadcomm_init
    from repro_torch.core.compat import make_mesh
    tc = threadcomm_init(make_mesh((2, 4), ("proc", "thread"), device="cpu"),
                         process_axes=("proc",), thread_axes=("thread",))
    x = torch.arange(8.0)
    captured = {}
    with tc.start():
        captured["sub"] = tc.thread_comm()
        captured["split"] = tc.split([r % 2 for r in range(8)])
        captured["group"] = tc.group([0, 1])
        tc.set_attr("petsc", 42)

        def issue(v):
            captured["req"] = tc.iallreduce(v)
            return captured["req"].wait()
        assert torch.allclose(tc.run(issue, x), x.sum().expand(8))
        assert captured["req"].test()[0]
    with tc.start():
        assert tc.get_attr("petsc") is None
        for name in ("sub", "split"):
            with pytest.raises(ThreadCommError):
                captured[name].dup()
        with pytest.raises(ThreadCommError):
            captured["group"].size
        with pytest.raises(ThreadCommError):
            captured["req"].wait()
        with pytest.raises(ThreadCommError):
            captured["req"].test()
        fresh = tc.thread_comm()
        out = tc.run(lambda v: fresh.allreduce(v), x)
        assert torch.equal(out, torch.cat([x[:4].sum().expand(4),
                                           x[4:].sum().expand(4)]))
    tc.free()


def test_make_mesh_defaults_to_the_card():
    """The entry point runs on the card unless the caller asks for the
    CPU, and raises when there is no card."""
    from repro_torch.core.compat import make_mesh
    if torch.cuda.is_available():
        assert make_mesh((2, 4), ("proc", "thread")).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh((2, 4), ("proc", "thread"))
    mesh = make_mesh((2, 4), ("proc", "thread"), device="cpu")
    assert mesh.device.type == "cpu" and mesh.devices.shape == (2, 4)


def test_num_threads_and_axes_are_checked():
    from repro_torch.core.comm import ThreadCommError, threadcomm_init
    from repro_torch.core.compat import make_mesh
    mesh = make_mesh((2, 4), ("proc", "thread"), device="cpu")
    with pytest.raises(ThreadCommError):
        threadcomm_init(mesh, ("proc",), ("thread",), num_threads=3)
    with pytest.raises(ThreadCommError):
        threadcomm_init(mesh, ("proc",), ("bogus",))
    with pytest.raises(ThreadCommError):
        threadcomm_init(mesh, ("proc",), ("proc",))


if __name__ == "__main__":
    np.savez(sys.argv[1], **reference_outputs(_inputs()))
