"""The attention kernels at the shapes the model families give them: head
dim 128 with the kv groups of qwen3 / qwen2.5 (40/8), yi (32/4), olmoe
(16/16), dbrx (48/8) and internvl2 (64/8), and flash attention without
the causal mask (whisper's encoder and cross-attention, key counts that
are no multiple of the kernel's 32-key stage).

On the CPU: the port's plain versions and its step-by-step emulations
of the CUDA kernels (``flash_attention_tiled_ref``, with the flash
kernel's key split when its work items cannot fill the card; the paged
split and combine ``paged_attention_split_ref`` under the launch plan)
against the reference's oracles and its Pallas kernels in interpret
mode, float32, at 2e-5 (the reference's own kernel tolerance: the same
sums in other orders). On the card (``cuda``: skips without one): each
CUDA kernel at those shapes against its plain version (and the flash
key split against its emulation), twice bit for bit. The JAX side
is imported inside the tests that use it, so the ``cuda`` tests also run
where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_ref,
    flash_attention_tiled_ref,
)
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref,
    paged_attention_split_ref,
)

TOL = 2e-5
#: (H, Hkv) of the families at head dim 128
HEADS_128 = [(40, 8), (32, 4), (16, 16), (48, 8), (64, 8)]


def _qkv(B, H, Hkv, Sq, Sk, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, hd), dtype=np.float32),
            rng.standard_normal((B, Hkv, Sk, hd), dtype=np.float32),
            rng.standard_normal((B, Hkv, Sk, hd), dtype=np.float32))


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,hd,bq,bk", [
    (2, 6, 6, 32, 96, 64, 32, 32),      # whisper's heads, cross-shaped
    (1, 6, 6, 1, 75, 64, 1, 75),        # one decode query, a 75-key tail
    (2, 4, 2, 24, 24, 128, 24, 24),     # GQA at hd 128, encoder-shaped
])
def test_noncausal_plain_and_emulation_match_oracle_and_pallas(
        B, H, Hkv, Sq, Sk, hd, bq, bk):
    """Non-causal: the plain version and the kernel's emulation (rows of
    one kv group, 32-key stages, the tail past Sk masked, p rounded)
    against the reference's oracle and interpret-mode Pallas kernel."""
    import jax.numpy as jnp
    from repro.kernels.flash_attention.ops import flash_attention as jflash
    from repro.kernels.flash_attention.ref import (
        flash_attention_ref as jref,
    )
    q, k, v = _qkv(B, H, Hkv, Sq, Sk, hd, seed=Sq + Sk)
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    plain = flash_attention_ref(tq, tk, tv, causal=False).numpy()
    emu = flash_attention_tiled_ref(tq, tk, tv, causal=False).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    oracle = np.asarray(jref(jq, jk, jv, causal=False))
    pallas = np.asarray(jflash(jq.transpose(0, 2, 1, 3),
                               jk.transpose(0, 2, 1, 3),
                               jv.transpose(0, 2, 1, 3), causal=False,
                               block_q=bq, block_k=bk, interpret=True)
                        ).transpose(0, 2, 1, 3)
    for got in (plain, emu):
        np.testing.assert_allclose(got, oracle, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got, pallas, atol=TOL, rtol=TOL)
    # the wrapper's CPU branch, in the models' layout
    out = flash_ops.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                                    tv.transpose(1, 2), causal=False)
    np.testing.assert_allclose(out.transpose(1, 2).numpy(), oracle,
                               atol=TOL, rtol=TOL)


def test_splits_for_fills_the_card_only_when_the_items_do_not():
    """One CTA an item when the (row tile, kv group, batch row) items fill
    the SMs (gemma's and whisper's encoder batches); a cross-attention of
    a few queries against 1500 keys splits its 47 stages; a short causal
    prompt (one stage) never splits."""
    kw = dict(sms=132, q_offset=0)
    assert flash_ops.splits_for(8, 8, 1, 256, 256, causal=True, **kw) == 1
    assert flash_ops.splits_for(2, 6, 6, 1500, 1500, causal=False, **kw) == 1
    assert flash_ops.splits_for(8, 6, 6, 1, 1500, causal=False, **kw) == 11
    assert flash_ops.splits_for(2, 6, 6, 64, 1500, causal=False, **kw) == 23
    assert flash_ops.splits_for(1, 8, 1, 16, 16, causal=True, **kw) == 1
    assert flash_ops.splits_for(1, 8, 1, 256, 256, causal=True, **kw) == 4


@pytest.mark.parametrize("causal,Sq,Sk,q_offset", [
    (False, 1, 75, 0), (False, 5, 130, 0), (True, 40, 100, 60),
    (True, 70, 70, 0)])
@pytest.mark.parametrize("splits", [2, 3, 7])
def test_split_emulation_matches_oracle(causal, Sq, Sk, q_offset, splits):
    """The kernel's key split (each CTA a run of stages, partials merged
    in split order, splits that see no key adding nothing) against the
    reference's oracle, causal and not, with more splits than some rows'
    stages."""
    import jax.numpy as jnp
    from repro.kernels.flash_attention.ref import (
        flash_attention_ref as jref,
    )
    q, k, v = _qkv(2, 4, 2, Sq, Sk, 64, seed=Sq * Sk + splits)
    emu = flash_attention_tiled_ref(
        *(torch.as_tensor(a) for a in (q, k, v)), causal=causal,
        q_offset=q_offset, splits=splits).numpy()
    oracle = np.asarray(jref(*(jnp.asarray(a) for a in (q, k, v)),
                             causal=causal, q_offset=q_offset))
    np.testing.assert_allclose(emu, oracle, atol=TOL, rtol=TOL)


def _paged(B, H, Hkv, K, seed, bs=16, NB=6):
    """Pool, tables and lengths from numpy at hd 128; row 0 parked (an all
    -1 table)."""
    rng = np.random.default_rng(seed)
    P = B * NB + 2
    kp = rng.standard_normal((P, bs, Hkv, 128), dtype=np.float32)
    vp = rng.standard_normal((P, bs, Hkv, 128), dtype=np.float32)
    q = rng.standard_normal((B, H, 128) if K == 0 else (B, K, H, 128),
                            dtype=np.float32)
    lengths = rng.integers(max(1, K), NB * bs + 1, size=B).astype(np.int32)
    perm = rng.permutation(P)
    tables = np.full((B, NB), -1, np.int32)
    for b in range(1, B):
        nb = -(-int(lengths[b]) // bs)
        tables[b, :nb] = perm[b * NB:b * NB + nb]
    return q, kp, vp, tables, lengths


@pytest.mark.parametrize("H,Hkv", HEADS_128)
@pytest.mark.parametrize("K", [0, 5])
def test_paged_hd128_plain_and_split_match_oracle_and_pallas(H, Hkv, K):
    """Both paged kernels' shapes at hd 128 and each family's kv group:
    the plain version and the split + combine emulation under the launch
    plan (at group 1, olmoe's, a decode row tile is 1 of a warp's 16
    rows) against the reference's oracle and Pallas kernel; the parked
    row is left out (its garbage differs by contract)."""
    import jax.numpy as jnp
    from repro.kernels.paged_attention.ops import paged_attention as jpaged
    from repro.kernels.paged_attention.ref import (
        paged_attention_ref as jref,
    )
    args = _paged(3, H, Hkv, K, seed=H + K)
    targs = [torch.as_tensor(a) for a in args]
    B, NB = args[3].shape
    pl = ops.plan(B, max(K, 1), H, Hkv, 16, NB)
    plain = paged_attention_ref(*targs).numpy()
    split = paged_attention_split_ref(*targs, plan=pl,
                                      tile_tokens=ops.TILE_TOKENS).numpy()
    jargs = [jnp.asarray(a) for a in args]
    oracle = np.asarray(jref(*jargs))
    pallas = np.asarray(jpaged(*jargs, interpret=True))
    for got in (plain, split):
        np.testing.assert_allclose(got[1:], oracle[1:], atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got[1:], pallas[1:], atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("H,Hkv", HEADS_128)
@pytest.mark.parametrize("K", [0, 64])
def test_cuda_paged_hd128(cuda_device, dtype, tol, H, Hkv, K):
    """Both paged kernels at hd 128 and each family's kv group against the
    plain version, two launches bit for bit (the parked row left out)."""
    args = _paged(6, H, Hkv, K, seed=H + K, NB=24)
    q, kp, vp, tables, lengths = [torch.as_tensor(a).to(cuda_device)
                                  for a in args]
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    out = ops.launch(q, kp, vp, tables, lengths)
    again = ops.launch(q, kp, vp, tables, lengths)
    ref = paged_attention_ref(q, kp, vp, tables, lengths)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    torch.testing.assert_close(out[1:].float(), ref[1:].float(), atol=tol,
                               rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,hd,causal", [
    (8, 40, 8, 256, 256, 128, True),     # qwen3, a static batch
    (2, 64, 8, 384, 384, 128, True),     # internvl2, 256 patch + 128 text
    (2, 6, 6, 1500, 1500, 64, False),    # whisper's encoder
    (8, 6, 6, 1, 1500, 64, False),       # cross-attention, a decode step
    (2, 6, 6, 64, 1500, 64, False),      # cross-attention, a chunk
    (2, 16, 4, 100, 333, 128, False),    # non-causal GQA at hd 128
])
def test_cuda_flash_family_shapes(cuda_device, dtype, tol, B, H, Hkv, Sq,
                                  Sk, hd, causal):
    """The flash kernel at the families' shapes against the plain version
    and its emulation, two launches bit for bit."""
    q, k, v = [torch.as_tensor(a).to(cuda_device, dtype).transpose(1, 2)
               for a in _qkv(B, H, Hkv, Sq, Sk, hd, seed=Sq + Sk)]
    flash_ops.reset_counters()
    out = flash_ops.flash_attention(q, k, v, causal=causal)
    again = flash_ops.flash_attention(q, k, v, causal=causal)
    ref = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2),
                              causal=causal).transpose(1, 2)
    torch.cuda.synchronize()
    assert flash_ops.counters()["flash_launches"] == 2
    assert torch.equal(out, again)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [1, 3, 11])
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,causal,q_offset", [
    (8, 6, 6, 1, 1500, False, 0),        # whisper cross, a decode step
    (2, 6, 6, 64, 1500, False, 0),       # whisper cross, a chunk
    (1, 8, 2, 40, 300, True, 200),       # causal with an offset
])
def test_cuda_flash_key_split(cuda_device, dtype, splits, B, H, Hkv, Sq, Sk,
                              causal, q_offset):
    """The kernel with its key stages split across CTAs (forced split
    counts) against its emulation with the same splits and the plain
    version, two launches bit for bit."""
    q, k, v = [torch.as_tensor(a).to(cuda_device, dtype)
               for a in _qkv(B, H, Hkv, Sq, Sk, 64, seed=Sq + splits)]
    kw = dict(causal=causal, q_offset=q_offset)
    out = flash_ops.launch(q, k, v, splits=splits, **kw)
    again = flash_ops.launch(q, k, v, splits=splits, **kw)
    emu = flash_attention_tiled_ref(q, k, v, splits=splits, **kw)
    ref = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), emu.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
