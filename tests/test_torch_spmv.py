"""Port PETSc case study (``repro_torch.apps.spmv``) vs the JAX reference.

The single-rank stencil and ``cg_solve_ref`` are held against the
reference's (``repro.apps.spmv``) in process; the distributed MatMult
(slab-decomposed along z, halos through threadcomm p2p) runs over 8
unified ranks, flat and as 2 processes x 4 threads, on the CPU, and is
held against the reference's single-rank oracle — which the reference's
own distributed case equals (``tests/mp_cases.py::case_spmv_distributed``)
— at n = 8, 16, 24; the distributed CG of ``examples/spmv_petsc.py``
against the reference's ``cg_solve_ref``. Inputs come from numpy with a
seed. Tolerances: the reference's own (stencil atol 1e-4; CG 1e-3, as the
example requires, with the dots summed per rank and then across ranks).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import spmv as jspmv
from repro_torch.apps import spmv
from repro_torch.core import threadcomm_init
from repro_torch.core.compat import P, make_mesh, shard_map
from repro_torch.kernels.msgq import ops


def _cube(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, n, n)).astype(
        np.float32)


@pytest.mark.parametrize("n", [4, 8, 12])
def test_stencil_matches_reference(n):
    x = _cube(n, seed=n)
    got = spmv.stencil_matmult_ref(torch.from_numpy(x)).numpy()
    want = np.asarray(jspmv.stencil_matmult_ref(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("iters", [1, 5, 15])
def test_cg_solve_ref_matches_reference(iters):
    b = _cube(12, seed=1)
    got = spmv.cg_solve_ref(torch.from_numpy(b), iters=iters).numpy()
    want = np.asarray(jspmv.cg_solve_ref(jnp.asarray(b), iters=iters))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _threadcomm(layout):
    if layout == "flat":
        mesh = make_mesh((8,), ("ranks",), device="cpu")
        return threadcomm_init(mesh, process_axes=(), thread_axes=("ranks",))
    mesh = make_mesh((2, 4), ("proc", "thread"), device="cpu")
    return threadcomm_init(mesh, process_axes=("proc",),
                           thread_axes=("thread",))


@pytest.mark.parametrize("layout", ["flat", "2x4"])
@pytest.mark.parametrize("n", [8, 16, 24])
def test_distributed_matmult_matches_reference(layout, n):
    x = _cube(n, seed=n)
    tc = _threadcomm(layout)
    with tc.start():
        mm = spmv.make_distributed_matmult(tc.unified_axes, tc.size)
        ops.reset_counters()
        y = tc.run(mm, torch.from_numpy(x)).numpy()
        assert ops.counters()["ref_calls"] == 2      # two halo rounds
    tc.free()
    want = np.asarray(jspmv.stencil_matmult_ref(jnp.asarray(x)))
    np.testing.assert_allclose(y, want, atol=1e-4)


def test_distributed_matmult_through_shard_map():
    """The reference's own spelling: shard_map over a named axis."""
    x = _cube(16, seed=3)
    mesh = make_mesh((8,), ("ranks",), device="cpu")
    mm = spmv.make_distributed_matmult("ranks", 8)
    y = shard_map(mm, mesh=mesh, in_specs=P("ranks"),
                  out_specs=P("ranks"))(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        y, np.asarray(jspmv.stencil_matmult_ref(jnp.asarray(x))), atol=1e-4)


@pytest.mark.parametrize("layout", ["flat", "2x4"])
@pytest.mark.parametrize("n,iters", [(8, 10), (16, 10), (16, 3)])
def test_distributed_cg_matches_reference(layout, n, iters):
    b = _cube(n, seed=n + iters)
    tc = _threadcomm(layout)
    with tc.start():
        cg = spmv.make_distributed_cg(tc.unified_axes, tc.size, iters)
        ops.reset_counters()
        x, hist = tc.run(cg, torch.from_numpy(b),
                         out_specs=(P(tc.unified_axes), P()))
        assert ops.counters()["ref_calls"] == 2 * (iters + 1)
    tc.free()
    x_ref = np.asarray(jspmv.cg_solve_ref(jnp.asarray(b), iters=iters))
    assert np.abs(x.numpy() - x_ref).max() < 1e-3
    # the history is the squared residual norm after each iteration
    r = torch.from_numpy(b) - spmv.stencil_matmult_ref(x)
    assert hist.shape == (iters,)
    np.testing.assert_allclose(float(hist[-1]), float((r * r).sum()),
                               rtol=1e-3)
    assert float(hist[-1]) < float((torch.from_numpy(b) ** 2).sum())
