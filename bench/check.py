"""The comparison that decides ``correct``: the served tokens against the
plain reference.

Once the window has closed, a sample of the requests the engine
finished, drawn from the seed with the longest of them in it, is run
through the family's plain float32 reference (``bench/reference/``):
each prompt with its served tokens, in one forward pass. Greedy
decoding serves the token with the largest logit, so the reference's
logit of each served token may lie below the reference's best only by
what rounding in the served precision moves. A cell compares the widest
such gap over every served token of the sample (``logit_gap``), or
their mean (``mean_logit_gap``) where the widest does not tell the
served precision from the control's: its ``check`` names the numbers
and their limits.

The control puts the reference in the program's place at fp8
(``precision="fp8"``): at the same positions of the same sequences, the
token the fp8 reference ranks first, read by the float32 reference.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

#: one sampled request: its prompt (P,) and its served tokens (G,)
Sample = Tuple[np.ndarray, np.ndarray]
#: the numbers a cell's ``check`` may hold to a limit (see ``readings``)
NUMBERS = ("logit_gap", "mean_logit_gap")


def pick(finished: Sequence[Sample], seed: int, n: int) -> List[Sample]:
    """``n`` finished requests: the longest (prompt and output), and the
    rest drawn from the seed."""
    if not finished:
        return []
    order = sorted(range(len(finished)),
                   key=lambda i: -(len(finished[i][0]) + len(finished[i][1])))
    rest = order[1:]
    rng = np.random.default_rng([int(seed) % 2 ** 63, 4])
    drawn = rng.permutation(len(rest))[:max(0, n - 1)]
    return [finished[order[0]]] + [finished[rest[i]] for i in sorted(drawn)]


def _sequence(sample: Sample, device):
    prompt, served = sample
    tok = np.concatenate([prompt, served[:-1]]).astype(np.int64)
    return torch.as_tensor(tok, device=device), len(prompt) - 1


@torch.no_grad()
def gaps(ref, params, c: dict, samples: Sequence[Sample], device, *,
         control: bool = False) -> torch.Tensor:
    """Per served position of ``samples``: the reference's best logit less
    its logit of the served token (``control``: of the token the fp8
    reference ranks first there)."""
    _strict_f32()
    out = []
    for sample in samples:
        tok, first = _sequence(sample, device)
        z = ref.logits(params, c, tok, first)
        if control:
            pick = ref.logits(params, c, tok, first,
                              precision="fp8").argmax(-1)
        else:
            pick = torch.as_tensor(sample[1].astype(np.int64), device=device)
        out.append(z.max(-1).values - z.gather(1, pick[:, None])[:, 0])
    return torch.cat(out) if out else torch.zeros(0)


def readings(g: torch.Tensor) -> dict:
    """The numbers a cell may compare, from the per-token gaps: the widest
    (``logit_gap``) and their mean over every served token
    (``mean_logit_gap``); None for an empty sample. Beside them, for the
    look at how the gaps spread: their 99th percentile (``p99_gap``) and
    the share of tokens that are not the reference's first choice
    (``off_top``)."""
    n = int(g.numel())
    g = g.double().cpu()
    return {"logit_gap": float(g.max()) if n else None,
            "mean_logit_gap": float(g.mean()) if n else None,
            "p99_gap": float(g.quantile(0.99)) if n else None,
            "off_top": float((g > 0).double().mean()) if n else None,
            "tokens": n}


def judge(read: dict, limits: dict):
    """``(correct, checks)``: each number the cell's ``check`` gives a
    limit for, beside that limit; correct when there is one at least,
    the sample was not empty, and none is over its limit."""
    checks = {k: {"value": read[k], "limit": limits[k]} for k in NUMBERS
              if limits.get(k) is not None}
    ok = bool(checks) and read["tokens"] > 0 and all(
        v["value"] <= v["limit"] for v in checks.values())
    return ok, checks


def _strict_f32() -> None:
    """float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
