"""Message-protocol model: eager / 1-copy (paper §3.2, Fig. 3) — the
port's copy of ``src/repro/core/protocol.py``.

The paper's interthread messaging picks a protocol by message size:
eager (<= 4 KiB) copies into a bounded shared cell and out again (2
copies), with a fast path that skips the request object for single-cell
messages; 1-copy (> 4 KiB) has the receiver copy straight from the
sender's buffer. The host half (``HostModel``) is an alpha-beta model
with the paper's host numbers; it prices the serving scheduler's
admissions and the comm layer's requests. The device half
(``DeviceModel``) prices the two message copies of
``kernels/msgq`` on the card: a shared-memory cell per CTA (eager) or a
direct global-to-global copy (1-copy), with the card's constants.
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


@dataclass(frozen=True)
class DeviceModel:
    """The msgq copies on one card (the counterpart of the reference's
    TPU model). Both copies read each byte from device memory once and
    write it once; the eager copy also passes it through a shared-memory
    cell and back, on chip. One launch moves a whole round, every cell or
    block in parallel, so the issue time is paid once per message round,
    not once per cell (and once per folded collective, whose rounds share
    one launch)."""
    #: host-inclusive time of one 64-byte message on the eager protocol
    #: (call + synchronize, median of 200), as ``chip_smoke.py`` phase 7a
    #: prints it on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit:
    #: the median of three runs that read 44.50, 51.50 and 67.77 us. The
    #: host's load moves it between runs; Python and the launch make
    #: nearly all of it.
    t_issue: float = 51.50e-6
    #: device-memory bandwidth, H100 SXM data sheet
    bw_hbm: float = 3.35e12
    #: shared-memory bandwidth of the whole card: 132 SMs x 128 bytes a
    #: clock x 1.98 GHz boost (data sheet figures, not measured)
    bw_smem: float = 132 * 128 * 1.98e9
    #: the eager protocol's shared-memory cell (one per CTA)
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


def prefix_hit_latency(nbytes: int, block_bytes: int,
                       m: HostModel = HostModel(),
                       cow_blocks: int = 0) -> float:
    """Admission price of the cache-hit part of a prompt (prefix
    caching): a lease handoff, not a recompute. One handshake claims the
    cached path, each hit block pays the quarter-envelope table-entry
    surcharge of :func:`paged_admission_latency`, and each copy-on-write
    clone adds one block-sized interthread copy, the only payload that
    moves on the hit path."""
    if block_bytes < 1:
        raise ValueError("block_bytes must be >= 1")
    nblocks = max(0, -(-max(0, nbytes) // block_bytes))
    cost = m.t_handshake + nblocks * m.t_envelope * 0.25
    if cow_blocks > 0:
        cost += cow_blocks * interthread_latency(block_bytes, m)
    return cost


def kv_migration_latency(nbytes: int, block_bytes: int,
                         m: HostModel = HostModel()) -> float:
    """Price of migrating a finished prefill's KV to another rank block
    by block (the disaggregated serving fabric's handoff): one
    rendezvous handshake (the decode rank has already leased the
    destination blocks, the posted receive), then every block its own
    message, priced under the protocol the block's payload selects; a
    partial tail block is priced at its own size."""
    if block_bytes < 1:
        raise ValueError("block_bytes must be >= 1")
    full, tail = divmod(max(0, nbytes), block_bytes)
    cost = m.t_handshake + full * interthread_latency(block_bytes, m)
    if tail:
        cost += interthread_latency(tail, m)
    return cost


def speculative_verify_latency(k: int, token_bytes: int = 4,
                               m: HostModel = HostModel()) -> float:
    """Price of one draft-verify round of speculative decoding, three
    interthread legs: the drafter hands its k token ids to the verify
    stream; the target's one (k+1)-query dispatch pays a handshake plus
    an envelope and a payload copy per teacher-forced token; up to k+1
    accepted ids travel back to the drafter."""
    if k < 1:
        raise ValueError("speculative_verify_latency: k must be >= 1")
    draft_handoff = interthread_latency(k * token_bytes, m)
    verify = (m.t_handshake + (k + 1) * m.t_envelope
              + (k + 1) * token_bytes / m.bw_copy)
    accept_return = interthread_latency((k + 1) * token_bytes, m)
    return draft_handoff + verify + accept_return


def interprocess_latency(nbytes: int, m: HostModel = HostModel()) -> float:
    """MPI-everywhere shared-memory messaging (eager / rndv, always 2-copy)."""
    if nbytes <= EAGER_THRESHOLD_INTERPROCESS:
        ncells = -(-nbytes // m.cell)
        return (m.t_envelope + m.t_request + 2 * nbytes / m.bw_copy
                + (ncells - 1) * m.t_envelope * 0.25)
    return (m.t_envelope + m.t_request + m.t_handshake
            + 2 * nbytes / m.bw_copy)


def request_overhead(nbytes: int, proto: Optional[str] = None,
                     m: HostModel = HostModel()) -> float:
    """Request-object cost (seconds) of a nonblocking op: the eager fast
    path for single-cell messages skips request allocation (§3.2)."""
    proto = validate_protocol(proto) if proto else select_protocol(nbytes)
    return 0.0 if proto == "eager_fast" else m.t_request


def bandwidth(nbytes: int, latency_s: float) -> float:
    return nbytes / latency_s


def staged_copy_time(nbytes: int, m: DeviceModel = DeviceModel()) -> float:
    """Eager copy on the card: device memory -> shared-memory cell ->
    device memory, one launch for the whole message."""
    return m.t_issue + 2 * nbytes / m.bw_hbm + 2 * nbytes / m.bw_smem


def direct_copy_time(nbytes: int, m: DeviceModel = DeviceModel()) -> float:
    """1-copy on the card: a direct global-to-global copy."""
    return m.t_issue + 2 * nbytes / m.bw_hbm
