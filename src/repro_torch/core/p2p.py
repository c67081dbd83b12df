"""Point-to-point messaging over threadcomm ranks — the port of
``src/repro/core/p2p.py``.

Ranks share one address space on one card, so a message between ranks is
a copy, and a round of messages is one launch of a ``kernels/msgq`` copy
(``collectives.ppermute``): the paper's interthread case (§3.2). The
protocol follows the paper's thresholds: the eager path pads a message
into whole shared-memory cells and stages it through them (2 copies);
the 1-copy path copies straight from the sender's buffer. As in the
reference, p2p is rank-addressed under a static SPMD schedule: no tag
matching and no unexpected-message queue.

Values are rank-stacked (``core/compat.py``): ``x`` is ``(R, *local)``.
User code addresses messages through ``Comm.send_recv`` / ``Comm.isend``
(:mod:`repro_torch.core.comm`), which translate comm-local ranks and
attach the request and stream semantics.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch.nn.functional as F

from repro_torch.core import protocol
from repro_torch.core.collectives import Axes, ppermute, rank_nbytes


def send_recv(x, axes: Axes, pairs: Sequence[Tuple[int, int]], *,
              force_protocol: Optional[str] = None):
    """One message round over local ranks. Returns (received, proto).

    Small payloads (<= cell) are padded to whole cells — the eager
    protocol's fixed-cell enqueue — and run the eager kernel; large ones
    go unpadded through the 1-copy kernel. An unknown ``force_protocol``
    raises :class:`ValueError`.
    """
    proto = (protocol.validate_protocol(force_protocol) if force_protocol
             else protocol.select_protocol(rank_nbytes(x)))
    if proto in ("eager_fast", "eager"):
        cell_elems = max(1, protocol.DEFAULT_CELL_SIZE // x.element_size())
        flat = x.reshape(x.shape[0], -1)
        n = flat.shape[1]
        pad = (-n) % cell_elems if n else cell_elems
        padded = F.pad(flat, (0, pad)) if pad else flat
        recv = ppermute(padded, axes, list(pairs), proto=proto)
        recv = recv[:, :n].reshape(x.shape)
    else:
        recv = ppermute(x, axes, list(pairs), proto=proto)
    return recv, proto


def shift(x, axes: Axes, n: int, offset: int = 1):
    """Ring shift by ``offset`` over n ranks (halo-exchange helper)."""
    return ppermute(x, axes, [(i, (i + offset) % n) for i in range(n)])


def halo_exchange_1d(x, axes: Axes, n: int):
    """Exchange boundary slabs with both ring neighbours (the SpMV /
    stencil pattern of the PETSc case study §4.3). x: (R, local_n, ...);
    returns (from_left, from_right), each (R, 1, ...). The boundary rows
    are strided views of x: the copy reads them in place."""
    from_left = ppermute(x[:, -1:], axes,
                         [(i, (i + 1) % n) for i in range(n)])
    from_right = ppermute(x[:, :1], axes,
                          [(i, (i - 1) % n) for i in range(n)])
    return from_left, from_right
