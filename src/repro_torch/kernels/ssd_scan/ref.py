"""Plain PyTorch versions of the SSD scan.

* :func:`ssd_scan_ref` — the sequential recurrence, the twin of the
  reference oracle ``src/repro/kernels/ssd_scan/ref.py``: exact SSM
  semantics, one step per position.
* :func:`ssd_chunked_ref` — the chunked SSD algorithm of the reference's
  model path (``src/repro/models/mamba.py:ssd_chunked``), in the model's
  ``(b, s, h, p)`` layout: intra-chunk quadratic term, chunk-local
  states, the inter-chunk recurrence and the state-to-output term, with a
  ragged tail identity-padded by ``dt = 0``.
* :func:`ssd_chunked_scan` — :func:`ssd_chunked_ref` behind the kernel's
  signature (``ops.ssd_scan``): what the wrapper runs for a tensor on the
  CPU, and the plain path a comparison on the card hands the model.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


def _segsum(x):
    """x (..., L) -> (..., L, L): S[i,j] = sum_{k=j+1..i} x[k], -inf above
    the diagonal."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, float("-inf"))


def ssd_chunked_ref(xh, dt, A, Bm, Cm, chunk: int, initial_state=None):
    """Chunked SSD scan in the model's layout. xh (b,s,h,p); dt (b,s,h)
    positive rates; A (h,) negative decay; Bm, Cm (b,s,n) shared across
    heads (ngroups = 1). Returns (y (b,s,h,p), final_state (b,h,p,n)), in
    xh's dtype, as the reference computes them."""
    b, s, h, p = xh.shape
    n = Bm.shape[-1]
    s_out = s
    pad = (-s) % chunk
    if pad:
        # identity-pad ragged sequences: dt = 0 makes the padded steps
        # exact no-ops on the state (decay exp(0) = 1, contribution 0)
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        s = s + pad
    c = s // chunk

    xd = (xh * dt[..., None]).reshape(b, c, chunk, h, p)
    dA = (dt * A).reshape(b, c, chunk, h).permute(0, 3, 1, 2)   # (b,h,c,l)
    Bc = Bm.reshape(b, c, chunk, n)
    Cc = Cm.reshape(b, c, chunk, n)

    dA_cum = torch.cumsum(dA, dim=-1)                           # (b,h,c,l)
    # 1) intra-chunk (quadratic within the chunk)
    Lm = torch.exp(_segsum(dA))                                 # (b,h,c,l,l)
    y_diag = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp", Cc, Bc, Lm, xd)
    # 2) chunk-local states (each chunk's contribution to the state)
    decay_states = torch.exp(dA_cum[..., -1:] - dA_cum)         # (b,h,c,l)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, decay_states, xd)
    # 3) inter-chunk recurrence; keep the state entering each chunk
    chunk_decay = torch.exp(dA_cum[..., -1])                    # (b,h,c)
    st = (torch.zeros((b, h, p, n), dtype=xh.dtype, device=xh.device)
          if initial_state is None else initial_state.to(xh.dtype))
    prev = []
    for ci in range(c):
        prev.append(st)
        st = st * chunk_decay[:, :, ci, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)                      # (b,c,h,p,n)
    # 4) state -> output within the chunk
    state_decay = torch.exp(dA_cum)                             # (b,h,c,l)
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, prev_states,
                         state_decay)
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y[:, :s_out], st


def ssd_chunked_scan(x, dt, A, Bm, Cm, initial_state=None, *,
                     chunk: int = 128, return_state: bool = False):
    """:func:`ssd_chunked_ref` with the kernel's signature: x (B,H,S,p),
    dt (B,H,S), A (H,), Bm/Cm (B,S,n), initial_state (B,H,p,n) -> y
    (B,H,S,p) in x's dtype (and the final state, float32). Computes in
    float32, on the chunk grid ``chunk`` anchored at position 0."""
    s0 = None if initial_state is None else initial_state.float()
    y, final = ssd_chunked_ref(x.float().transpose(1, 2),
                               dt.float().transpose(1, 2), A.float(),
                               Bm.float(), Cm.float(), chunk, s0)
    y = y.transpose(1, 2).to(x.dtype)
    return (y, final.float()) if return_state else y
