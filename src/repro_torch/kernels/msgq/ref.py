"""Plain PyTorch message copies: the twin of the reference oracle
``src/repro/kernels/msgq/ref.py`` (a message copy is a copy), and of a
whole message round.

The CPU tests and the comm layer on the CPU run them through ``ops``;
``chip_smoke.py`` holds the CUDA kernels against them on the card.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


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
