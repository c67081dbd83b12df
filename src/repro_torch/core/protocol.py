"""Message-protocol model: eager / 1-copy (paper §3.2, Fig. 3) — the
port's copy of the host-side part of ``src/repro/core/protocol.py``.

The paper's interthread messaging picks a protocol by message size:
eager (<= 4 KiB) copies into a bounded shared cell and out again (2
copies), with a fast path that skips the request object for single-cell
messages; 1-copy (> 4 KiB) has the receiver copy straight from the
sender's buffer. This alpha-beta model prices the serving scheduler's
admissions. Its constants are the paper's host numbers; a device model
for the card comes with the msgq kernel's slice of the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

# thresholds from the paper's evaluation (§4.1)
EAGER_THRESHOLD_INTERTHREAD = 4096      # bytes
EAGER_THRESHOLD_INTERPROCESS = 16384    # bytes
DEFAULT_CELL_SIZE = 4096                # shared-memory cell payload

# every protocol name the model knows; anything else is a caller bug
PROTOCOLS = ("eager_fast", "eager", "one_copy", "rndv")


def validate_protocol(name: str) -> str:
    if name not in PROTOCOLS:
        raise ValueError(
            f"unknown protocol {name!r}; known protocols: {PROTOCOLS}")
    return name


@dataclass(frozen=True)
class HostModel:
    """Per-message overheads (seconds) + copy bandwidth (bytes/sec), an
    alpha-beta fit in the spirit of the Xeon 5317 numbers in Fig. 3."""
    t_envelope: float = 8e-8      # assemble envelope + enqueue + match
    t_request: float = 6e-8       # request-object alloc/dealloc (skippable)
    t_handshake: float = 25e-8    # rndv/1-copy header + ack round trip
    t_map: float = 0.0            # address mapping (0 between threads)
    bw_copy: float = 12e9         # single-core memcpy bandwidth
    cell: int = DEFAULT_CELL_SIZE


def select_protocol(nbytes: int, interthread: bool = True,
                    cell: int = DEFAULT_CELL_SIZE) -> str:
    if interthread:
        if nbytes <= min(cell, EAGER_THRESHOLD_INTERTHREAD):
            return "eager_fast"   # single cell: request object skipped
        if nbytes <= EAGER_THRESHOLD_INTERTHREAD:
            return "eager"        # multi-cell eager (cell < threshold configs)
        return "one_copy"
    return "eager" if nbytes <= EAGER_THRESHOLD_INTERPROCESS else "rndv"


def interthread_latency(nbytes: int, m: HostModel = HostModel(),
                        proto: Optional[str] = None) -> float:
    """Latency of one interthread message under the paper's protocol.
    The branch follows ``nbytes`` against the model's own cell size;
    ``proto`` prices a forced protocol instead."""
    if proto is None:
        proto = select_protocol(nbytes, interthread=True, cell=m.cell)
    else:
        validate_protocol(proto)
    if proto == "eager_fast":
        return m.t_envelope + 2 * nbytes / m.bw_copy
    if proto == "eager":
        return m.t_envelope + m.t_request + 2 * nbytes / m.bw_copy
    # 1-copy / rndv: handshake + a single copy, no address-mapping cost
    return (m.t_envelope + m.t_request + m.t_handshake + m.t_map
            + nbytes / m.bw_copy)


def chunked_handoff_latency(nbytes: int, chunk_bytes: int,
                            m: HostModel = HostModel()) -> float:
    """Rendezvous payload handed over in ``chunk_bytes`` pieces: one
    handshake, an envelope per chunk, the payload crossing once — the
    admission price of a chunked prefill."""
    if chunk_bytes < 1:
        raise ValueError("chunk_bytes must be >= 1")
    nchunks = max(1, -(-nbytes // chunk_bytes))
    return (m.t_envelope + m.t_request + m.t_handshake + m.t_map
            + nchunks * m.t_envelope + nbytes / m.bw_copy)


def paged_admission_latency(nbytes: int, chunk_bytes: int, block_bytes: int,
                            m: HostModel = HostModel()) -> float:
    """Admission price of a paged chunked deposit: the chunked handoff
    plus a quarter-envelope per KV block the payload will occupy (the
    block-table entry writes)."""
    if block_bytes < 1:
        raise ValueError("block_bytes must be >= 1")
    nblocks = max(1, -(-nbytes // block_bytes))
    return (chunked_handoff_latency(nbytes, chunk_bytes, m)
            + nblocks * m.t_envelope * 0.25)
