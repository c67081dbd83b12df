"""PETSc case study (paper §4.3): 27-point stencil SpMV (MatMult) and CG
over a threadcomm — the port of ``src/repro/apps/spmv.py``.

The paper drives PETSc's MatMult from an OpenMP parallel region through a
threadcomm (Fig. 6; 27-point stencil on a 128³ cube). Here the
matrix-free stencil operator is decomposed in slabs along z over the
unified threadcomm ranks of one card; the halo exchange is the
rank-addressed p2p of ``repro_torch.core.p2p``: two message rounds per
MatMult, each one launch of a ``kernels/msgq`` copy (a 128² f32 plane is
64 KiB: the 1-copy protocol). The distributed CG of
``examples/spmv_petsc.py`` lives here too, so every caller shares one
copy of the path.

Inside a region values are rank-stacked (``core/compat.py``): a slab is
``(R, nz_local, ny, nx)`` and a per-rank dot product ``(R,)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import collectives as coll
from repro_torch.core import p2p
from repro_torch.core.compat import axis_index, rank_view

# 27-point stencil weights: center 26, all 26 neighbours -1 (a standard
# 3D Laplacian-like operator; SPD up to boundary effects).
_CENTER = 26.0
_NEIGHBOR = -1.0


def _apply_stencil(xp: torch.Tensor) -> torch.Tensor:
    """xp: (..., nz+2, ny, nx) with z-halos attached; zero-padded in y/x.
    Returns (..., nz, ny, nx)."""
    nz, ny, nx = xp.shape[-3] - 2, xp.shape[-2], xp.shape[-1]
    xp = F.pad(xp, (1, 1, 1, 1))
    out = None
    for dz in (0, 1, 2):
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                w = _CENTER if (dz, dy, dx) == (1, 1, 1) else _NEIGHBOR
                blk = xp[..., dz:dz + nz, dy:dy + ny, dx:dx + nx] * w
                out = blk if out is None else out + blk
    return out


def stencil_matmult_ref(x: torch.Tensor) -> torch.Tensor:
    """Single-rank oracle. x: (n, n, n)."""
    return _apply_stencil(F.pad(x, (0, 0, 0, 0, 1, 1)))


def make_distributed_matmult(axes, n_ranks: int):
    """MatMult over slab-decomposed x: per-rank (nz_local, ny, nx),
    stacked. Call inside shard_map / ThreadComm.run; halos via threadcomm
    p2p."""

    def matmult(x_local):
        rank = axis_index(axes)
        from_left, from_right = p2p.halo_exchange_1d(x_local, axes, n_ranks)
        # non-periodic boundary: first/last slab see zero halos
        zero = torch.zeros_like(from_left)
        left = torch.where(rank_view(rank == 0, zero), zero, from_left)
        right = torch.where(rank_view(rank == n_ranks - 1, zero), zero,
                            from_right)
        return _apply_stencil(torch.cat([left, x_local, right], dim=1))

    return matmult


def _vdot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (u * v).reshape(u.shape[0], -1).sum(1)


def make_distributed_cg(axes, n_ranks: int, iters: int = 10):
    """Distributed CG (``examples/spmv_petsc.py``): MatMult with halo p2p,
    dot products as threadcomm allreduces (``schedule="psum"``). Call
    inside shard_map / ThreadComm.run on b's slabs; returns (x, hist) with
    hist (R, iters) each rank's residual history (the reference's
    ``lax.scan`` is a Python loop)."""
    matmult = make_distributed_matmult(axes, n_ranks)

    def dot(u, v):
        return coll.allreduce(_vdot(u, v), axes, schedule="psum")

    def cg(b_local):
        x = torch.zeros_like(b_local)
        r = b_local - matmult(x)
        p = r
        rs = dot(r, r)
        hist = []
        for _ in range(iters):
            ap = matmult(p)
            alpha = rank_view(rs / dot(p, ap), p)
            x = x + alpha * p
            r = r - alpha * ap
            rs_new = dot(r, r)
            p = r + rank_view(rs_new / rs, p) * p
            rs = rs_new
            hist.append(rs_new)
        return x, torch.stack(hist, dim=1)

    return cg


def cg_solve_ref(b: torch.Tensor, iters: int = 20) -> torch.Tensor:
    """Few CG iterations against the stencil operator (oracle for the
    solver-style usage in the PETSc study)."""
    x = torch.zeros_like(b)
    r = b - stencil_matmult_ref(x)
    p = r
    rs = torch.vdot(r.reshape(-1), r.reshape(-1))
    for _ in range(iters):
        ap = stencil_matmult_ref(p)
        alpha = rs / torch.vdot(p.reshape(-1), ap.reshape(-1))
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.vdot(r.reshape(-1), r.reshape(-1))
        p = r + (rs_new / rs) * p
        rs = rs_new
    return x
