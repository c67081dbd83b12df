"""Port flash attention vs the JAX reference.

On the CPU the port's wrapper (``repro_torch.kernels.flash_attention.ops.
flash_attention``) takes its plain version, ``ref.py``; it is held against
the reference's oracle (``flash_attention_ref``), against the reference's
Pallas kernel run in interpret mode, and against the model's
``chunked_attention`` (the reference's and the port's), on the same inputs
made by numpy from a seed. The cases mirror the reference's own kernel
tests: causal, GQA, MQA, a non-power-of-two length, a sliding window and
a ``q_offset`` continuation, at its tolerances (2e-5 in float32, 2e-2 in
bfloat16: the implementations sum in different orders, and bfloat16
rounds p before the p.v product in the kernel and after normalising in
the oracle). Ragged lengths, which the Pallas kernel refuses, are held
against ``chunked_attention``, which pads.

The CUDA kernel's design is held on the CPU through its step-by-step
emulation (``ref.flash_attention_tiled_ref``): CTAs of 64 (query, head)
rows of one kv group, ``rr = (j - j0) * R + h_local``, each walking the
32-key stages its rows can see, at R = 1, 5 and 8, against the plain
version, the reference's oracle and its Pallas kernel in interpret mode.

The CUDA kernel runs only on the card: the ``cuda`` tests hold it to the
plain version and to its emulation, and two launches to each other bit
for bit; they skip without one.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_ref,
    flash_attention_tiled_ref,
    visible_keys,
)
from repro_torch.models import layers as TL


def _qkv(B, H, Hkv, Sq, Sk, hd, seed=0):
    """q (B,Sq,H,hd), k/v (B,Sk,Hkv,hd) float32, the models' layout."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd), dtype=np.float32),
            rng.standard_normal((B, Sk, Hkv, hd), dtype=np.float32),
            rng.standard_normal((B, Sk, Hkv, hd), dtype=np.float32))


def _port(q, k, v, dtype=torch.float32, **kw):
    t = [torch.as_tensor(a).to(dtype) for a in (q, k, v)]
    return ops.flash_attention(*t, **kw).float().numpy()


def _reference(q, k, v, dtype, block, **kw):
    """The reference's oracle and its interpret-mode Pallas kernel."""
    import jax.numpy as jnp
    from repro.kernels.flash_attention.ops import flash_attention as jflash
    from repro.kernels.flash_attention.ref import (
        flash_attention_ref as jref,
    )
    jq, jk, jv = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
    oracle = jref(jq.transpose(0, 2, 1, 3), jk.transpose(0, 2, 1, 3),
                  jv.transpose(0, 2, 1, 3), **kw).transpose(0, 2, 1, 3)
    pallas = jflash(jq, jk, jv, block_q=block[0], block_k=block[1],
                    interpret=True, **kw)
    return (np.asarray(oracle.astype(jnp.float32)),
            np.asarray(pallas.astype(jnp.float32)))


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,hd,bq,bk", [
    (1, 2, 2, 64, 64, 16, 16, 16),
    (2, 4, 2, 128, 128, 32, 64, 32),     # GQA
    (1, 8, 1, 64, 64, 64, 32, 32),       # MQA
    (2, 2, 2, 96, 96, 16, 32, 32),       # non-power-of-two seq
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_oracle_and_pallas_causal(B, H, Hkv, Sq, Sk, hd, bq,
                                                bk, dtype):
    import jax.numpy as jnp
    q, k, v = _qkv(B, H, Hkv, Sq, Sk, hd)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    port = _port(q, k, v, tdt, causal=True)
    oracle, pallas = _reference(q, k, v, getattr(jnp, dtype), (bq, bk),
                                causal=True)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(port, oracle, atol=tol, rtol=tol)
    np.testing.assert_allclose(port, pallas, atol=tol, rtol=tol)


@pytest.mark.parametrize("window", [8, 32])
def test_sliding_window(window):
    import jax.numpy as jnp
    q, k, v = _qkv(1, 2, 2, 64, 64, 16, seed=1)
    port = _port(q, k, v, window=window)
    oracle, pallas = _reference(q, k, v, jnp.float32, (16, 16),
                                causal=True, window=window)
    np.testing.assert_allclose(port, oracle, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(port, pallas, atol=2e-5, rtol=2e-5)


def test_q_offset_continuation():
    """q_offset places queries mid-sequence (prefill continuation)."""
    import jax.numpy as jnp
    q, k, v = _qkv(1, 2, 2, 32, 128, 16, seed=2)
    port = _port(q, k, v, q_offset=96)
    oracle, pallas = _reference(q, k, v, jnp.float32, (16, 32),
                                causal=True, q_offset=96)
    np.testing.assert_allclose(port, oracle, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(port, pallas, atol=2e-5, rtol=2e-5)


def test_matches_model_chunked_attention():
    """The plain version against both packages' model-path chunked
    attention (the reference's and the port's)."""
    import jax.numpy as jnp
    from repro.models.layers import chunked_attention as jchunked
    q, k, v = _qkv(2, 4, 4, 128, 128, 32, seed=3)
    pos = np.arange(128)
    port = _port(q, k, v)
    ref = np.asarray(jchunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              q_pos=jnp.asarray(pos), k_pos=jnp.asarray(pos),
                              causal=True, chunk_q=32, chunk_k=32))
    mine = TL.chunked_attention(
        *[torch.as_tensor(a) for a in (q, k, v)], q_pos=torch.as_tensor(pos),
        k_pos=torch.as_tensor(pos), causal=True, chunk_q=32,
        chunk_k=32).numpy()
    np.testing.assert_allclose(port, ref, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(mine, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("S,H,Hkv,window", [(45, 4, 1, 0), (77, 4, 2, 0),
                                            (200, 2, 2, 0), (93, 4, 1, 20)])
def test_ragged_lengths_match_chunked_attention(S, H, Hkv, window):
    """Lengths that divide no block: the plain version against the
    reference's padded chunked attention (kv repeated for it)."""
    import jax.numpy as jnp
    from repro.models.layers import chunked_attention as jchunked
    q, k, v = _qkv(2, H, Hkv, S, S, 16, seed=S)
    port = _port(q, k, v, window=window)
    kf, vf = (np.repeat(a, H // Hkv, axis=2) for a in (k, v))
    pos = jnp.arange(S)
    ref = np.asarray(jchunked(jnp.asarray(q), jnp.asarray(kf),
                              jnp.asarray(vf), q_pos=pos, k_pos=pos,
                              causal=True, window=window or None,
                              chunk_q=32, chunk_k=16))
    np.testing.assert_allclose(port, ref, atol=2e-5, rtol=2e-5)


#: (B, H, Hkv, Sq, Sk, hd, window, q_offset, Pallas blocks or None):
#: R = H / Hkv of 1, 5 and 8; ragged lengths (no Pallas: it asserts that
#: the blocks divide), a window edge and a q_offset continuation
TILED_CASES = [
    (2, 4, 4, 64, 64, 16, 0, 0, (16, 16)),        # R = 1
    (1, 10, 2, 64, 64, 16, 0, 0, (32, 16)),       # R = 5
    (2, 8, 1, 64, 64, 16, 0, 0, (32, 32)),        # R = 8 (gemma's MQA)
    (1, 10, 2, 77, 77, 16, 0, 0, None),           # R = 5, ragged tile
    (2, 8, 1, 45, 45, 16, 0, 0, None),            # R = 8, ragged
    (1, 10, 2, 96, 96, 16, 33, 0, (32, 32)),      # R = 5, window edge
    (1, 8, 1, 96, 96, 16, 32, 0, (32, 32)),       # R = 8, window = stage
    (1, 5, 1, 32, 128, 16, 0, 96, (16, 32)),      # R = 5, q_offset
    (1, 4, 4, 40, 100, 16, 0, 60, None),          # R = 1, ragged Sk > Sq
]


@pytest.mark.parametrize("case", TILED_CASES,
                         ids=[f"R{c[1] // c[2]}-S{c[3]}-w{c[6]}-o{c[7]}"
                              for c in TILED_CASES])
def test_tiled_emulation_matches_oracle_and_pallas(case):
    """The kernel's arithmetic (row tiles of (query, head) pairs of one kv
    group, causal and window stage skipping, ragged tails, p rounded
    before p.v) against the plain version, the reference's oracle and,
    where its blocks divide the lengths, its Pallas kernel."""
    import jax.numpy as jnp
    B, H, Hkv, Sq, Sk, hd, window, q_offset, block = case
    q, k, v = _qkv(B, H, Hkv, Sq, Sk, hd, seed=Sq + H)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    t = [torch.as_tensor(a).transpose(1, 2) for a in (q, k, v)]
    emu = flash_attention_tiled_ref(
        *t, rows_per_cta=ops.ROWS_PER_CTA, tile_keys=ops.TILE_KEYS,
        **kw).transpose(1, 2).numpy()
    np.testing.assert_allclose(emu, _port(q, k, v, **kw), atol=2e-5,
                               rtol=2e-5)
    if block:
        oracle, pallas = _reference(q, k, v, jnp.float32, block, **kw)
        np.testing.assert_allclose(emu, oracle, atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(emu, pallas, atol=2e-5, rtol=2e-5)


def test_tiled_emulation_rounds_p_like_the_pallas_kernel():
    """In bfloat16 the emulation rounds p before p.v, as the Pallas kernel
    does, and agrees with the reference's interpret-mode kernel within
    the bf16 tolerance, not bit for bit with its own float32 run."""
    import jax.numpy as jnp
    q, k, v = _qkv(1, 10, 2, 64, 64, 16, seed=8)
    t16 = [torch.as_tensor(a).to(torch.bfloat16).transpose(1, 2)
           for a in (q, k, v)]
    lo = flash_attention_tiled_ref(*t16).float()
    hi = flash_attention_tiled_ref(*[x.float() for x in t16])
    err = float((lo - hi).abs().max())
    assert lo.dtype == torch.float32 and 0 < err < 3e-2
    _, pallas = _reference(q, k, v, jnp.bfloat16, (32, 16))
    np.testing.assert_allclose(lo.transpose(1, 2).numpy(), pallas,
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("Sq,Sk,R,window,q_offset", [
    (64, 64, 8, 0, 0), (77, 77, 5, 0, 0), (200, 200, 5, 2048, 0),
    (96, 96, 5, 33, 0), (32, 128, 8, 0, 96), (40, 100, 1, 7, 60),
    (2304, 2304, 5, 2048, 0)])
def test_visible_keys_are_exactly_the_rows_union(Sq, Sk, R, window,
                                                 q_offset):
    """A CTA's key range is the union of what its rows see: each row's
    keys lie in it, and its first and last keys are seen by some row, so
    stages wholly above the diagonal or outside the window are skipped
    and no stage a row needs is."""
    M = ops.ROWS_PER_CTA
    for f0 in range(0, Sq * R, M):
        f1 = min(f0 + M, Sq * R)
        k_begin, k_end = visible_keys(Sq, Sk, R, f0, f1, window=window,
                                      q_offset=q_offset)
        seen = set()
        for f in range(f0, f1):
            qpos = q_offset + f // R
            lo = max(0, qpos - window + 1) if window > 0 else 0
            seen.update(range(lo, min(qpos + 1, Sk)))
        if seen:
            assert (k_begin, k_end) == (min(seen), max(seen) + 1)
        else:
            assert k_end <= k_begin


def test_tiled_emulation_gives_zeros_where_no_key_is_seen():
    """Queries before position 0 or whose window holds no key get zeros,
    the kernel's contract; the others match the plain version."""
    q, k, v = _qkv(1, 4, 2, 10, 30, 16, seed=6)
    t = [torch.as_tensor(a).transpose(1, 2) for a in (q, k, v)]
    kw = dict(window=8, q_offset=-5)
    emu = flash_attention_tiled_ref(*t, **kw)
    ref = flash_attention_ref(*t, **kw)
    assert not emu[:, :, :5].any()
    torch.testing.assert_close(emu[:, :, 5:], ref[:, :, 5:], atol=2e-5,
                               rtol=2e-5)


def test_build_key_covers_shared_headers(tmp_path, monkeypatch):
    """A library's cache key hashes its source, every header under the
    kernels package and the flags: a changed header rebuilds."""
    src = tmp_path / "k" / "csrc" / "k.cu"
    src.parent.mkdir(parents=True)
    src.write_text('#include "../../common.cuh"\n')
    hdr = tmp_path / "common.cuh"
    hdr.write_text("// v1\n")
    monkeypatch.setattr(_build, "_PKG", tmp_path)
    assert _build.headers() == [hdr]
    first = _build._target(src)
    assert _build._target(src) == first
    hdr.write_text("// v2\n")
    assert _build._target(src) != first
    real = Path(ops.__file__).parents[1] / "hopper.cuh"
    monkeypatch.undo()
    assert real in _build.headers()


def test_layout_adapter_and_counters():
    """The wrapper takes the models' (B, S, H, hd) layout, returns it, and
    counts one plain-version call on the CPU."""
    q, k, v = _qkv(2, 4, 2, 24, 24, 16, seed=4)
    ops.reset_counters()
    t = [torch.as_tensor(a) for a in (q, k, v)]
    out = ops.flash_attention(*t)
    assert out.shape == (2, 24, 4, 16)
    ref = flash_attention_ref(*[a.transpose(1, 2) for a in t])
    assert torch.equal(out, ref.transpose(1, 2))
    assert ops.counters() == {"flash_launches": 0, "ref_calls": 1}


def test_unsupported_device_raises():
    q = torch.zeros(1, 2, 1, 64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.flash_attention(q, q, q)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,hd,window,q_offset", [
    (8, 8, 1, 256, 256, 256, 0, 0),      # gemma-2b, a static batch
    (1, 8, 1, 16, 16, 256, 0, 0),        # a short monolithic admission
    (2, 8, 1, 200, 200, 256, 0, 0),      # ragged
    (1, 8, 1, 32, 128, 256, 0, 96),      # q_offset continuation
    (2, 8, 2, 192, 192, 256, 50, 0),     # GQA, window
    (2, 8, 8, 130, 130, 128, 0, 0),      # H = Hkv
    (8, 25, 5, 256, 256, 64, 2048, 0),   # hymba-1.5b, a static batch
    (2, 25, 5, 200, 200, 64, 2048, 0),   # R = 5, rows not a tile multiple
    (1, 25, 5, 2304, 2304, 64, 2048, 0),  # R = 5, past the window
    (2, 10, 2, 96, 96, 64, 33, 0),       # R = 5, window edge
])
def test_cuda_kernel_matches_ref(cuda_device, dtype, tol, B, H, Hkv, Sq, Sk,
                                 hd, window, q_offset):
    """The kernel against the plain version on the card."""
    q, k, v = [torch.as_tensor(a).to(cuda_device, dtype)
               for a in _qkv(B, H, Hkv, Sq, Sk, hd, seed=5)]
    ops.reset_counters()
    out = ops.flash_attention(q, k, v, window=window, q_offset=q_offset)
    ref = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), window=window,
                              q_offset=q_offset).transpose(1, 2)
    torch.cuda.synchronize()
    assert ops.counters()["flash_launches"] == 1
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,hd,window,q_offset", [
    (2, 8, 1, 77, 77, 256, 0, 0),        # R = 8, ragged
    (2, 10, 2, 77, 77, 64, 20, 0),       # R = 5, ragged, window
    (1, 4, 4, 40, 100, 128, 0, 60),      # R = 1, q_offset
])
def test_cuda_kernel_matches_tiled_emulation_and_repeats(
        cuda_device, dtype, B, H, Hkv, Sq, Sk, hd, window, q_offset):
    """The kernel against its step-by-step emulation (the same rows,
    stages and rounding; float32 within reassociation), and two launches
    bit for bit."""
    q, k, v = [torch.as_tensor(a).to(cuda_device, dtype)
               for a in _qkv(B, H, Hkv, Sq, Sk, hd, seed=7)]
    kw = dict(window=window, q_offset=q_offset)
    out = ops.flash_attention(q, k, v, **kw)
    again = ops.flash_attention(q, k, v, **kw)
    emu = flash_attention_tiled_ref(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), **kw).transpose(1, 2)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), emu.float(), atol=tol, rtol=tol)
