"""Plain PyTorch versions of the SSD scan.

* :func:`ssd_scan_ref` — the sequential recurrence, the twin of the
  reference oracle ``src/repro/kernels/ssd_scan/ref.py``: exact SSM
  semantics, one step per position.
* :func:`ssd_chunked_scan` — the chunked SSD algorithm of the model
  path (``repro_torch.models.mamba.ssd_chunked``, which owns the one
  copy) behind the kernel's signature (``ops.ssd_scan``): what the
  wrapper runs for a tensor on the CPU, the plain path a comparison on
  the card hands the model, and the scan of training (differentiable).
"""

from __future__ import annotations

import torch


def ssd_scan_ref(x, dt, A, Bm, Cm, initial_state=None, *,
                 return_state: bool = False):
    """Sequential scan: ``state_t = state_{t-1} * exp(dt_t A) + dt_t x_t
    B_t``, ``y_t = state_t C_t``. x (B,H,S,p); dt (B,H,S) (post-softplus);
    A (H,); Bm, Cm (B,S,n). ``initial_state`` (B,H,p,n) seeds the
    recurrence (zeros when None); ``return_state`` also returns the final
    state (float32). y is in x's dtype."""
    B, H, S, p = x.shape
    n = Bm.shape[-1]
    xf, dtf = x.float(), dt.float()
    Bf, Cf, Af = Bm.float(), Cm.float(), A.float()
    state = (torch.zeros((B, H, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    ys = []
    for t in range(S):
        dtt = dtf[:, :, t]                                     # (B, H)
        decay = torch.exp(dtt * Af[None, :])
        upd = (dtt[..., None] * xf[:, :, t])[..., None] \
            * Bf[:, None, t, None, :]                          # (B,H,p,n)
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cf[:, t]))
    y = (torch.stack(ys, dim=2) if ys
         else xf.new_zeros((B, H, 0, p))).to(x.dtype)
    return (y, state) if return_state else y


def ssd_chunked_scan(x, dt, A, Bm, Cm, initial_state=None, *,
                     chunk: int = 128, return_state: bool = False):
    """``mamba.ssd_chunked`` with the kernel's signature: x (B,H,S,p), dt
    (B,H,S), A (H,), Bm/Cm (B,S,n), initial_state (B,H,p,n) -> y
    (B,H,S,p) in x's dtype (and the final state, float32). Computes in
    float32, on the chunk grid ``chunk`` anchored at position 0."""
    # imported here: models/mamba.py imports this package's ops, which
    # import this module
    from repro_torch.models.mamba import ssd_chunked
    s0 = None if initial_state is None else initial_state.float()
    y, final = ssd_chunked(x.float().transpose(1, 2),
                               dt.float().transpose(1, 2), A.float(),
                               Bm.float(), Cm.float(), chunk, s0)
    y = y.transpose(1, 2).to(x.dtype)
    return (y, final.float()) if return_state else y
