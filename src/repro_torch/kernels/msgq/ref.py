"""Plain PyTorch message copies: the twin of the reference oracle
``src/repro/kernels/msgq/ref.py`` (a message copy is a copy), of a whole
message round, and of a round program (``program.py``) run round by
round.

The CPU tests and the comm layer on the CPU run them through ``ops``;
``chip_smoke.py`` holds the CUDA kernels against them on the card.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.kernels.msgq.program import Program, Round


def msgq_copy_ref(msg: torch.Tensor) -> torch.Tensor:
    return msg.clone()


def msgq_round_ref(x: torch.Tensor,
                   pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """x: (R, ...) per-rank slabs. A fresh tensor holding x[s] at d for
    every (s, d) pair and zeros at every rank named as no dst."""
    out = torch.zeros_like(x, memory_format=torch.contiguous_format)
    if pairs:
        src = torch.tensor([s for s, _ in pairs], device=x.device)
        dst = torch.tensor([d for _, d in pairs], device=x.device)
        out[dst] = x[src]
    return out


def _rank_view(mask, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(mask, device=like.device).reshape(
        (like.shape[0],) + (1,) * (like.dim() - 1))


def _segment_round(x: torch.Tensor, rnd: Round) -> torch.Tensor:
    """The ring's step over the (R, chunks, length) view: each rank
    gathers the chunk it sends, the round delivers it, and each rank adds
    it into (``scatter_add``) or writes it over (``scatter``) its chunk
    of the segment's index; every other element stays."""
    R, n = x.shape[0], rnd.length
    chunks = x.reshape(R, -1, n)
    send, recv_at = [0] * R, [0] * R
    for (s, d), (so, do, _) in zip(rnd.pairs, rnd.segments):
        send[s], recv_at[d] = so // n, do // n

    def at(idx):                                   # (R,) -> (R, 1, n)
        return torch.tensor(idx, device=x.device).view(R, 1, 1).expand(
            R, 1, n)

    blk = chunks.gather(1, at(send))[:, 0]
    recv = msgq_round_ref(blk, rnd.pairs)
    if rnd.combine == "add":
        chunks = chunks.scatter_add(1, at(recv_at), recv[:, None])
    else:
        chunks = chunks.scatter(1, at(recv_at), recv[:, None])
    return chunks.reshape(x.shape)


def msgq_program_ref(x: torch.Tensor, program: Program) -> torch.Tensor:
    """Run ``program`` on x (R, ...) one round at a time: each round's
    message exchange is :func:`msgq_round_ref`, its combine the torch op
    the collective used round by round (``x + r``, ``torch.maximum``,
    ``torch.where``, ``scatter_add`` / ``scatter``). Returns a fresh
    contiguous tensor."""
    out = x.clone(memory_format=torch.contiguous_format)
    for rnd in program.rounds:
        if rnd.segments is not None:
            out = _segment_round(out, rnd)
            continue
        recv = msgq_round_ref(out, rnd.pairs)
        if rnd.combine == "copy":
            out = recv
        elif rnd.combine == "add":
            out = out + recv
        elif rnd.combine == "max":
            out = torch.maximum(out, recv)
        else:
            dst = {d for _, d in rnd.pairs}
            is_dst = _rank_view([r in dst for r in range(x.shape[0])], out)
            out = (torch.where(is_dst, recv, out) if rnd.combine == "replace"
                   else torch.where(is_dst, out, torch.zeros_like(out)))
    return out
