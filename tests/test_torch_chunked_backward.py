"""The backward of the port's ``chunked_attention``
(``repro_torch.models.layers``): each kv block runs under non-reentrant
``torch.utils.checkpoint``, as the reference wraps its kv block in
``jax.checkpoint``, so the backward recomputes a block's (cq, ck) tiles
instead of saving them for every block pair.

* Gradients: dq, dk, dv against ``jax.vjp`` of the reference's
  ``repro.models.layers.chunked_attention`` on the same inputs and
  cotangent, made by numpy from a seed, in float32 at 1e-5.
* Memory: the peak of live bytes (``roofline.analysis.LiveBytes``) of a
  forward and backward on ``meta`` tensors at B=1, H=8, S=4096, hd=256,
  cq=512, ck=2048 against the carries plus one block pair's tiles worked
  out by hand.
* Outputs: under ``no_grad`` and with grad on, bitwise equal to each
  other and to the loop that saved every tile (kept below as it was).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import layers as JL
from repro_torch.models import layers as TL
from repro_torch.roofline.analysis import LiveBytes

TOL = 1e-5


def _saving_every_tile(q, k, v, *, q_pos, k_pos, causal=True, window=None,
                       softcap=0.0, chunk_q=512, chunk_k=512):
    """``chunked_attention`` as it was before its kv blocks were
    checkpointed: plain loops, so autograd saves every block pair's
    tiles."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    cq, ck = min(chunk_q, S), min(chunk_k, T)
    nq, nk = -(-S // cq), -(-T // ck)
    pad_q, pad_k = nq * cq - S, nk * ck - T
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
        q_pos = F.pad(q_pos, (0, pad_q), value=-1)
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
        k_pos = F.pad(k_pos, (0, pad_k), value=TL.PAD_POS)
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for iq in range(nq):
        qc = q[:, iq * cq:(iq + 1) * cq]
        qp = q_pos[iq * cq:(iq + 1) * cq]
        m = torch.full((B, H, cq), TL.NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, cq, hd), dtype=torch.float32,
                          device=q.device)
        for ik in range(nk):
            kc = k[:, ik * ck:(ik + 1) * ck]
            vc = v[:, ik * ck:(ik + 1) * ck]
            kp = k_pos[ik * ck:(ik + 1) * ck]
            s = torch.einsum("bshk,bthk->bhst", qc, kc).float() * scale
            if softcap > 0:
                s = softcap * torch.tanh(s / softcap)
            s = s + TL._mask_bias(qp, kp, causal=causal, window=window)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhst,bthk->bhsk", p.to(qc.dtype), vc).float()
            m = m_new
        out = acc / l.clamp(min=1e-30)[..., None]
        outs.append(out.transpose(1, 2).to(qc.dtype))
    return torch.cat(outs, dim=1)[:, :S]


#: (S, T, causal, window, softcap, cq, ck): causal and not, a window, a
#: softcap, ragged S and T that pad, cq != ck both ways
CASES = {
    "causal": (64, 64, True, None, 0.0, 32, 16),
    "window": (64, 64, True, 20, 0.0, 16, 32),
    "softcap_ragged": (45, 45, True, None, 30.0, 16, 32),
    "non_causal_ragged": (37, 53, False, None, 0.0, 32, 16),
}


def _inputs(S, T, seed, B=2, H=3, hd=16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, n, H, hd)).astype(np.float32)
               for n in (S, T, T))
    g = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    return q, k, v, g


@pytest.mark.parametrize("case", sorted(CASES))
def test_grads_match_the_reference(case):
    S, T, causal, window, softcap, cq, ck = CASES[case]
    q, k, v, g = _inputs(S, T, seed=len(case))
    q_pos = np.arange(T - S, T)      # queries are the last S positions
    k_pos = np.arange(T)
    kw = dict(causal=causal, window=window, softcap=softcap, chunk_q=cq,
              chunk_k=ck)

    def jfn(q_, k_, v_):
        return JL.chunked_attention(q_, k_, v_, q_pos=jnp.asarray(q_pos),
                                    k_pos=jnp.asarray(k_pos), **kw)

    jout, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (q, k, v)))
    jgrads = vjp(jnp.asarray(g))

    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = TL.chunked_attention(tq, tk, tv, q_pos=torch.as_tensor(q_pos),
                               k_pos=torch.as_tensor(k_pos), **kw)
    out.backward(torch.as_tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=TOL, rtol=TOL)
    for name, mine, ref in zip("qkv", (tq.grad, tk.grad, tv.grad),
                               jgrads):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=TOL,
                                   rtol=TOL, err_msg=f"d{name}")


#: the memory case: one sequence of gemma-2b's train_4k attention shape
#: (8 heads of 256), the dry run's train chunks (512 queries x 2048 keys)
B, H, S, HD, CQ, CK = 1, 8, 4096, 256, 512, 2048
#: the peak before the kv blocks were checkpointed (every tile held),
#: measured by the same LiveBytes trace with ``_saving_every_tile``
PEAK_SAVING_EVERY_TILE = {torch.float32: 1_322_516_480,
                          torch.bfloat16: 1_532_231_680}


def _traced_peak(fn, dtype):
    meta = torch.device("meta")
    q, k, v = (torch.empty((B, S, H, HD), dtype=dtype, device=meta,
                           requires_grad=True) for _ in range(3))
    pos = torch.arange(S, device=meta)
    with LiveBytes() as lb:
        out = fn(q, k, v, q_pos=pos, k_pos=pos, causal=True, chunk_q=CQ,
                 chunk_k=CK)
        out.backward(torch.empty_like(out))
    return lb.peak


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_backward_holds_one_block_pair_of_tiles(dtype):
    """Forward plus backward on ``meta``: the peak lies within 2x of what
    the checkpoint leaves live, by hand. Every (q block, kv block) step
    saves its carries (m, l of (B,H,cq), acc of (B,H,cq,hd), float32) and
    the last acc stays for the division: nq x (nk + 1) sets. One block
    pair's tiles are its float32 scores and probabilities and the
    probabilities cast to the activation dtype, (B,H,cq,ck) each. The
    output and the gradients of q, k and v are (B,S,H,hd) in the
    activation dtype. Before the checkpoint the peak held every pair's
    tiles: 1,322,516,480 B in float32 and 1,532,231,680 B in bfloat16,
    5x-6x this bound; it must now fall 3x below those."""
    item = torch.empty((), dtype=dtype).element_size()
    nq, nk = S // CQ, S // CK
    carries = nq * (nk + 1) * (2 * B * H * CQ + B * H * CQ * HD) * 4
    tile = B * H * CQ * CK
    tiles = tile * (4 + 4 + (item if item != 4 else 0))
    io = 4 * B * S * H * HD * item          # out, dq, dk, dv
    bound = carries + tiles + io
    peak = _traced_peak(TL.chunked_attention, dtype)
    assert bound / 2 <= peak <= 2 * bound, (peak, bound)
    assert _traced_peak(_saving_every_tile, dtype) == \
        PEAK_SAVING_EVERY_TILE[dtype]
    assert peak * 3 <= PEAK_SAVING_EVERY_TILE[dtype], peak


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_outputs_bitwise_unchanged(case, dtype):
    """The forward under ``no_grad``, with grad on (checkpointed blocks),
    and the loop that saved every tile: one set of bits. The gradients of
    the checkpointed and the saving loop agree bitwise too: the backward
    recomputes the same tiles."""
    S, T, causal, window, softcap, cq, ck = CASES[case]
    q, k, v, g = _inputs(S, T, seed=7)
    kw = dict(q_pos=torch.arange(T - S, T), k_pos=torch.arange(T),
              causal=causal, window=window, softcap=softcap, chunk_q=cq,
              chunk_k=ck)
    with torch.no_grad():
        plain = TL.chunked_attention(
            *(torch.tensor(a, dtype=dtype) for a in (q, k, v)), **kw)
    grads = []
    outs = []
    for fn in (TL.chunked_attention, _saving_every_tile):
        ts = [torch.tensor(a, dtype=dtype, requires_grad=True)
              for a in (q, k, v)]
        out = fn(*ts, **kw)
        out.backward(torch.tensor(g, dtype=dtype))
        outs.append(out.detach())
        grads.append([t.grad for t in ts])
    assert torch.equal(plain, outs[0])
    assert torch.equal(outs[0], outs[1])
    for mine, saved in zip(*grads):
        assert torch.equal(mine, saved)
