"""The benchmark's own count of the work a step needed, from the sizes in
a configuration file and what the requests served in the step.

A step is recorded from the requests it advanced: each prompt chunk as
``(prompt_len, pos0, n)`` (``n`` valid tokens at positions ``pos0 ..
pos0 + n - 1``; the chunk that ends the prompt needs its last token's
logits), each decode token by its attention length (output token ``i``
of a prompt of ``P`` tokens reads ``P + i`` keys). Nothing here reads
the program's counters or traces its operations.

Model FLOPs count what the model needs, not what an implementation
runs: the top-k experts a token picks (not every expert), the causal
triangle of attention, the LM head only where a logit is sampled, and
the SSM's recurrence (``5 h p n`` a token: decay, input and read-out of
the state). 1 multiply-add = 2 FLOPs.

A kernel's bound counts, per call, each input byte read once and each
output byte written once, and the operations its inputs need; rows a
call carries for nothing (parked decode rows, the padding of a chunk)
need nothing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

#: bytes of the served dtype (bf16 weights, activations and KV)
ACT_BYTES = 2
#: bytes of the SSM scan's operands (the model runs the scan in float32)
SCAN_BYTES = 4


@dataclass
class Step:
    """One engine step as the benchmark saw it."""
    t0: float
    t1: float
    chunks: List[Tuple[int, int, int]] = field(default_factory=list)
    decode: List[int] = field(default_factory=list)
    #: tokens that became visible: first tokens of finished prompts and
    #: decode tokens
    generated: int = 0
    in_slice: bool = False

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    @property
    def tokens(self) -> int:
        """Prompt tokens prefilled and tokens generated in the step."""
        return sum(n for _, _, n in self.chunks) + self.generated


def _is_moe(c: dict) -> bool:
    return c["block"] == "moe"


def _is_ssm(c: dict) -> bool:
    return c["block"] == "ssm"


def token_layer_flops(c: dict) -> float:
    """FLOPs one token needs in one layer, attention scores left out."""
    d = c["d_model"]
    f = 0.0
    if c.get("num_heads", 0):
        h, hkv, hd = c["num_heads"], c["num_kv_heads"], c["head_dim"]
        f += 2 * d * h * hd + 2 * 2 * d * hkv * hd + 2 * h * hd * d
    if _is_moe(c):
        gates = 2 if c.get("mlp_act", "swiglu") in ("swiglu", "geglu") else 1
        f += 2 * d * c["num_experts"]                       # router
        f += c["top_k"] * 2 * (gates + 1) * d * c["d_ff"]   # picked experts
    if _is_ssm(c):
        di, n = c["ssm_d_inner"], c["ssm_state"]
        h = di // c["ssm_head_dim"]
        f += 2 * d * (2 * di + 2 * n + h)                   # in_proj
        f += 2 * c["ssm_conv"] * (di + 2 * n)               # depthwise conv
        f += 5 * h * c["ssm_head_dim"] * n                  # recurrence
        f += 2 * di * d                                     # out_proj
    return f


def _attn_keys(c: dict) -> int:
    """FLOPs a (query, key) pair needs in one layer: q.k and p.v."""
    if not c.get("num_heads", 0):
        return 0
    return 4 * c["num_heads"] * c["head_dim"]


def chunk_pairs(pos0: int, n: int) -> int:
    """Causal (query, key) pairs of ``n`` queries at ``pos0 ..``."""
    return n * pos0 + n * (n + 1) // 2


def lm_head_flops(c: dict) -> float:
    return 2.0 * c["d_model"] * c["vocab_size"]


def model_flops(c: dict, step: Step) -> float:
    """FLOPs the model needs for the work of ``step``."""
    L = c["num_layers"]
    per_tok = token_layer_flops(c) * L
    pair = _attn_keys(c) * L
    f = 0.0
    for p, pos0, n in step.chunks:
        f += per_tok * n + pair * chunk_pairs(pos0, n)
        if pos0 + n == p:
            f += lm_head_flops(c)
    for ctx in step.decode:
        f += per_tok + pair * ctx + lm_head_flops(c)
    return f


def paged_decode_cost(c: dict, step: Step) -> Tuple[float, float]:
    """(FLOPs, bytes) the step's decode-attention calls need, every layer:
    each live row reads its ``ctx`` keys and values once."""
    L, h, hkv, hd = (c["num_layers"], c["num_heads"], c["num_kv_heads"],
                     c["head_dim"])
    flops = byt = 0.0
    for ctx in step.decode:
        flops += _attn_keys(c) * ctx
        byt += 2 * ctx * hkv * hd * ACT_BYTES      # K and V pages
        byt += 2 * h * hd * ACT_BYTES              # q in, out
        byt += 4 * (-(-ctx // c.get("kv_block", 16))) + 4   # table, length
    return flops * L, byt * L


def paged_mq_cost(c: dict, step: Step) -> Tuple[float, float]:
    """(FLOPs, bytes) the step's prompt-chunk attention calls need, every
    layer: the chunk's valid queries over the prompt so far."""
    L, h, hkv, hd = (c["num_layers"], c["num_heads"], c["num_kv_heads"],
                     c["head_dim"])
    flops = byt = 0.0
    for _, pos0, n in step.chunks:
        keys = pos0 + n
        flops += _attn_keys(c) * chunk_pairs(pos0, n)
        byt += 2 * keys * hkv * hd * ACT_BYTES
        byt += 2 * n * h * hd * ACT_BYTES
        byt += 4 * (-(-keys // c.get("kv_block", 16))) + 4
    return flops * L, byt * L


def ssd_scan_cost(c: dict, step: Step) -> Tuple[float, float]:
    """(FLOPs, bytes) the step's chunk scans need, every layer: per valid
    token x, dt, B, C in and y out; per chunk row the state in and out;
    the recurrence's ``5 h p n`` FLOPs a token."""
    L, n_state, p = c["num_layers"], c["ssm_state"], c["ssm_head_dim"]
    h = c["ssm_d_inner"] // p
    flops = byt = 0.0
    for _, _, n in step.chunks:
        flops += 5 * h * p * n_state * n
        byt += SCAN_BYTES * n * (2 * h * p + h + 2 * n_state)
        byt += SCAN_BYTES * 2 * h * p * n_state
    return flops * L, byt * L
