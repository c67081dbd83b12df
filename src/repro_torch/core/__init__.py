"""The paper's primary contribution, MPIX Threadcomm, on one card — the
port of ``src/repro/core/``.

- comm.py:        the unified ``Comm`` API — root ThreadComm, split/dup
                  sub-communicators, Request-based nonblocking ops, and
                  stream-bound contexts (CUDA streams on the card)
- threadcomm.py:  back-compat facade over comm.py
- schedules.py:   dissemination/binomial/ring/recursive-doubling schedules
- collectives.py: rank-stacked collectives (message rounds + native + 2-level)
- p2p.py:         rank-addressed messaging w/ eager|1-copy protocol selection
- protocol.py:    the Fig.3 protocol model, host and device halves
- compat.py:      the rank-stacked SPMD region (shard_map, make_mesh, P)
"""

from repro_torch.core.comm import (AxisComm, Comm, CommError, CommStream,  # noqa: F401
                                   Group, GroupComm, Request, ThreadComm,
                                   ThreadCommError, threadcomm_init, testall,
                                   waitall)
from repro_torch.core import collectives, p2p, protocol, schedules  # noqa: F401
