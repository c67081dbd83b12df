"""Plain PyTorch version of the top-k expert kernels (``csrc/moe.cu``).

The same dispatch tables and the same arithmetic as the card's launches:
the assignments ``a = t * K + k`` listed expert by expert in (token,
slot) order (:func:`dispatch_ref`), each expert's products over only
the token rows that picked it with float32 accumulation, ``h =
silu(g) * u`` computed in float32 and stored in the activations' dtype,
``y`` float32 rows scaled by their float32 gates, and each token's K
rows summed in slot order and cast once (:func:`moe_experts_ref`). The
CPU path of the models and the card's yardstick.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def tile_rows_bound(n: int, num_experts: int, bm: int) -> int:
    """Rows of the tile table: an upper bound of the row tiles of ``bm``
    rows that ``n`` assignments over ``num_experts`` experts need."""
    return -(-n // bm) + num_experts


def dispatch_ref(idx: torch.Tensor, num_experts: int, bm: int):
    """Tables of ``idx`` (T, K) expert ids, each int32: ``offsets`` (E +
    1), the exclusive prefix sum of the per-expert counts; ``perm`` (T *
    K), sorted position -> assignment ``t * K + k``, expert by expert and
    in (token, slot) order within one; ``tiles`` (R, 2), each row tile's
    expert and first sorted row, ``(-1, 0)`` past the last tile, with R
    from :func:`tile_rows_bound`."""
    flat = idx.reshape(-1).long()
    n, E = flat.numel(), num_experts
    perm = torch.sort(flat, stable=True).indices
    counts = torch.zeros(E, dtype=torch.long, device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    zero = counts.new_zeros(1)
    offsets = torch.cat([zero, counts.cumsum(0)])
    tstart = torch.cat([zero, ((counts + bm - 1) // bm).cumsum(0)])
    r = torch.arange(tile_rows_bound(n, E, bm), device=flat.device)
    e = (torch.searchsorted(tstart[:E].contiguous(), r, right=True)
         - 1).clamp(min=0)
    live = r < tstart[E]
    row0 = offsets[e] + (r - tstart[e]) * bm
    tiles = torch.stack([torch.where(live, e, -1),
                         torch.where(live, row0, 0)], dim=1)
    return offsets.int(), perm.int(), tiles.int()


def moe_experts_ref(x, idx, gates, w_gate, w_up, w_down):
    """x (T, d), idx (T, K) expert ids, gates (T, K) float32, w_gate /
    w_up (E, d, f), w_down (E, f, d) -> (T, d) in x's dtype: the top-k
    experts of each token, one expert at a time over its sorted rows."""
    T, K = idx.shape
    E, f = w_gate.shape[0], w_gate.shape[2]
    offsets, perm, _ = dispatch_ref(idx, E, 1)
    perm = perm.long()
    xs = x[perm // K]                                            # (T*K, d)
    g_flat = gates.reshape(-1).float()
    y = torch.empty((T * K, x.shape[1]), dtype=torch.float32,
                    device=x.device)
    bounds = offsets.tolist()
    for e in range(E):
        lo, hi = bounds[e], bounds[e + 1]
        if lo == hi:
            continue
        xe = xs[lo:hi].float()
        h = (F.silu(xe @ w_gate[e].float()) * (xe @ w_up[e].float())).to(
            x.dtype)
        rows = perm[lo:hi]
        y[rows] = (h.float() @ w_down[e].float()) * g_flat[rows, None]
    y = y.view(T, K, x.shape[1])
    out = y[:, 0]
    for k in range(1, K):
        out = out + y[:, k]
    return out.to(x.dtype)
