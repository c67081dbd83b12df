"""PETSc case study (paper §4.3): distributed MatMult + CG inside a
threadcomm "parallel region" — the port of ``examples/spmv_petsc.py``.

Mirrors the paper's Listing 5: init the threadcomm outside the region,
create the distributed operator inside it, run parallel MatMult + a few
CG iterations (dot products = threadcomm allreduces, halo exchange =
p2p, two ``msgq`` message rounds a MatMult on the card), verify against
the single-rank oracle, and tear down in order (objects die before
finish — the threadcomm lifetime rule).

Run:  PYTHONPATH=src python -m repro_torch.examples.spmv_petsc
          [--n 64] [--iters 10] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.apps.spmv import (cg_solve_ref, make_distributed_cg,
                                   make_distributed_matmult,
                                   stencil_matmult_ref)
from repro_torch.core import threadcomm_init
from repro_torch.core.compat import P, make_mesh
from repro_torch.examples import report, reset_counts


def main(argv=None):
    ap = argparse.ArgumentParser(description="PETSc MatMult + CG")
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n = args.n
    reset_counts()

    mesh = make_mesh((2, 4), ("proc", "thread"), device=args.device)
    tc = threadcomm_init(mesh, process_axes=("proc",),
                         thread_axes=("thread",))
    axes = tc.unified_axes
    ranks = tc.size
    assert n % ranks == 0

    b = torch.randn((n, n, n), generator=torch.Generator().manual_seed(0))
    b = b.to(mesh.device)
    checks = {}

    with tc.start():                          # the "parallel region"
        cg = make_distributed_cg(axes, ranks, args.iters)
        t0 = time.perf_counter()
        x, hist = tc.run(cg, b, out_specs=(P(axes), P()))
        if x.device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"CG({args.iters}) over {ranks} unified ranks on "
              f"{n}^3 cube: {dt * 1e3:.1f} ms")
        print("residual history:",
              [f"{float(v):.3e}" for v in hist.cpu()[:5]], "...")

        x_ref = cg_solve_ref(b, iters=args.iters)
        err = float((x - x_ref).abs().max())
        print(f"max |x - x_ref| = {err:.3e}",
              "(OK)" if err < 1e-3 else "(MISMATCH)")
        checks["cg"] = err < 1e-3

        y = tc.run(make_distributed_matmult(axes, ranks), b)
        err_mm = float((y - stencil_matmult_ref(b)).abs().max())
        print(f"MatMult max err vs oracle = {err_mm:.3e}",
              "(OK)" if err_mm < 1e-3 else "(MISMATCH)")
        checks["matmult"] = err_mm < 1e-3
    tc.free()
    return report("spmv_petsc", checks)


if __name__ == "__main__":
    main()
