"""Collective-communication schedules as pure rank arithmetic.

Each schedule returns a list of *rounds*; a round is a list of (src, dst)
pairs executed concurrently. These are the classic algorithms the paper's
MPICH implementation uses (dissemination barrier [Hensgen88], binomial
reduce/bcast, ring and recursive-doubling allreduce) plus the two-level
hierarchical composition that realizes the paper's "threadcomm-aware"
collectives (exploit the fast local domain first).

Pure python → property-testable (hypothesis) and directly consumable by
the message rounds of :mod:`repro_torch.core.collectives`.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

Round = List[Tuple[int, int]]


def _ceil_log2(n: int) -> int:
    return max(1, math.ceil(math.log2(n))) if n > 1 else 0


# ---------------------------------------------------------------------------
# Barrier: dissemination (lg N rounds, every rank sends every round)
# ---------------------------------------------------------------------------

def dissemination_rounds(n: int) -> List[Round]:
    """Round k: rank i signals rank (i + 2^k) mod n. After ceil(lg n) rounds
    every rank has transitively heard from every other rank."""
    rounds = []
    k = 1
    while k < n:
        rounds.append([(i, (i + k) % n) for i in range(n)])
        k *= 2
    return rounds


# ---------------------------------------------------------------------------
# Binomial tree (reduce toward root / bcast away from root)
# ---------------------------------------------------------------------------

def binomial_reduce_rounds(n: int, root: int = 0) -> List[Round]:
    """Classic binomial-tree reduce. Works for any n; ranks are rotated so
    ``root`` is tree-rank 0. Round k (k=0..): tree-ranks with bit k set send
    to (rank - 2^k) and retire."""
    rounds = []
    k = 1
    while k < n:
        rnd = []
        for r in range(n):
            if (r % (2 * k)) == k:         # sender at this round
                src = (r + root) % n
                dst = ((r - k) + root) % n
                rnd.append((src, dst))
        rounds.append(rnd)
        k *= 2
    return rounds


def binomial_bcast_rounds(n: int, root: int = 0) -> List[Round]:
    """Reverse of the reduce tree: root fans out in lg n rounds."""
    return [[(d, s) for (s, d) in rnd]
            for rnd in reversed(binomial_reduce_rounds(n, root))]


# ---------------------------------------------------------------------------
# Allreduce schedules
# ---------------------------------------------------------------------------

def ring_rounds(n: int) -> List[Round]:
    """One ring step: i -> i+1. Ring allreduce = 2(n-1) such steps
    (reduce-scatter then allgather), bandwidth-optimal: 2(n-1)/n · bytes."""
    return [[(i, (i + 1) % n) for i in range(n)]]


def recursive_doubling_rounds(n: int) -> List[Round]:
    """Round k: exchange with partner (rank XOR 2^k). lg n rounds, full
    vector each round — latency-optimal for small messages. Requires n
    power of two."""
    assert n & (n - 1) == 0, f"recursive doubling needs power-of-two n, got {n}"
    rounds = []
    k = 1
    while k < n:
        rounds.append([(i, i ^ k) for i in range(n)])
        k *= 2
    return rounds


# ---------------------------------------------------------------------------
# Two-level hierarchical composition (the paper's threadcomm-aware pattern)
# ---------------------------------------------------------------------------

def two_level_allreduce_plan(n_proc: int, m_thread: int) -> dict:
    """Describe the hierarchical allreduce over N processes × M threads:
    1. intra-process reduce-scatter over the M 'threads' (fast domain),
    2. inter-process allreduce on the 1/M shard (slow domain),
    3. intra-process allgather.
    Inter-process bytes drop by M× vs a flat allreduce — the quantitative
    content of the paper's 'use shared memory for the local part' insight."""
    return {
        "phases": [
            ("reduce_scatter", "thread", m_thread),
            ("allreduce", "process", n_proc),
            ("allgather", "thread", m_thread),
        ],
        "slow_domain_fraction": 1.0 / m_thread,
    }


# ---------------------------------------------------------------------------
# Simulation (oracle for property tests)
# ---------------------------------------------------------------------------

def simulate_knowledge(n: int, rounds: Sequence[Round]) -> List[set]:
    """Dataflow simulation: each rank starts knowing {itself}; a (src, dst)
    message transfers src's current knowledge set. Returns final knowledge."""
    know = [{i} for i in range(n)]
    for rnd in rounds:
        incoming = [set() for _ in range(n)]
        for src, dst in rnd:
            incoming[dst] |= know[src]
        for i in range(n):
            know[i] |= incoming[i]
    return know


def simulate_reduce(n: int, rounds: Sequence[Round], values=None):
    """Simulate a sum-reduce over the given rounds (sender's accumulator is
    added into the receiver's). Returns final accumulators."""
    acc = list(values) if values is not None else [float(i) for i in range(n)]
    for rnd in rounds:
        inc = [0.0] * n
        for src, dst in rnd:
            inc[dst] += acc[src]
        for i in range(n):
            acc[i] += inc[i]
    return acc


# ---------------------------------------------------------------------------
# Cost model (alpha-beta) — used by benchmarks & protocol selection
# ---------------------------------------------------------------------------

def allreduce_cost(n: int, nbytes: int, *, alpha: float, beta: float,
                   schedule: str) -> float:
    """Classic alpha (per-message latency) + beta (sec/byte) cost model."""
    lg = _ceil_log2(n)
    if schedule == "ring":
        steps = 2 * (n - 1)
        return steps * alpha + 2 * (n - 1) / n * nbytes * beta
    if schedule == "recursive_doubling":
        return lg * alpha + lg * nbytes * beta
    if schedule == "reduce_bcast":  # binomial reduce + binomial bcast
        return 2 * lg * alpha + 2 * lg * nbytes * beta
    raise ValueError(schedule)


def hierarchical_allreduce_cost(n_proc: int, m_thread: int, nbytes: int, *,
                                alpha_fast: float, beta_fast: float,
                                alpha_slow: float, beta_slow: float) -> float:
    """reduce-scatter(fast) + allreduce(slow on 1/M bytes) + allgather(fast)."""
    rs = (m_thread - 1) * alpha_fast + (m_thread - 1) / m_thread * nbytes * beta_fast
    ar = allreduce_cost(n_proc, nbytes // m_thread, alpha=alpha_slow,
                        beta=beta_slow, schedule="ring")
    ag = (m_thread - 1) * alpha_fast + (m_thread - 1) / m_thread * nbytes * beta_fast
    return rs + ar + ag


def flat_allreduce_cost(n_total: int, nbytes: int, *, alpha_slow: float,
                        beta_slow: float) -> float:
    """Rank-unaware flat ring over the slow domain (MPI-everywhere analogue:
    every hop may cross the slow links)."""
    return allreduce_cost(n_total, nbytes, alpha=alpha_slow, beta=beta_slow,
                          schedule="ring")
