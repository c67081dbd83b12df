"""Port SSD chunk scan vs the JAX reference.

On the CPU the port's wrapper (``repro_torch.kernels.ssd_scan.ops.
ssd_scan``) takes its plain version (the model path's chunked algorithm,
``ref.ssd_chunked_scan``); it is held against the reference's Pallas
``ssd_scan`` run in interpret mode (as the reference's own tests run it),
against its sequential oracle ``ssd_scan_ref`` and against the model's
``mamba.ssd_chunked``, on the same inputs made by numpy from a seed. The
shape grid is the reference's (``tests/test_kernels.py``) plus ragged
lengths, which the Pallas kernel refuses and ``ssd_chunked`` pads.
Tolerances are the reference's: 1e-4 in float32 (the algorithms sum in
different orders), 5e-2 with bfloat16 x (x is rounded once, the scan
runs in float32).

Resuming across two calls is held to 1e-5 on the CPU: the plain
version's einsums may block their sums differently at different lengths,
so bit-exactness is not its contract. The kernel's is: the ``cuda``
tests hold the CUDA kernel to the plain version and check that a split
scan resumes bit for bit on the card, and that the kernel's split of
each (b, h) over CTAs by columns of p changes no bit; they skip without
one. On the CPU the column split is held through the plain version: each
slice of p's columns, scanned from its own slice of the state, gives the
unsplit call's columns.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_scan_ref
from repro.models.mamba import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_scan, ssd_scan_ref
from repro_torch.models.mamba import ssd_chunked as ssd_chunked_ref

GRID = [(1, 2, 64, 16, 8, 16), (2, 4, 128, 32, 16, 32), (1, 1, 96, 8, 4, 8),
        (2, 2, 64, 16, 8, 64)]
RAGGED = [(2, 3, 50, 16, 8, 16), (1, 2, 7, 8, 4, 16), (2, 2, 200, 16, 8, 64)]
TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


def _inputs(B, H, S, p, n, seed=0, state=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, S, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, H, S)))).astype(
        np.float32) * 0.1
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bm = rng.standard_normal((B, S, n), dtype=np.float32) * 0.5
    Cm = rng.standard_normal((B, S, n), dtype=np.float32) * 0.5
    out = [x, dt, A, Bm, Cm]
    if state:
        out.append(rng.standard_normal((B, H, p, n), dtype=np.float32) * 0.2)
    return out


def _t(arrays, dtype=torch.float32):
    """Torch tensors; x (the first) in ``dtype``, the rest float32."""
    return [torch.as_tensor(arrays[0]).to(dtype)] + [
        torch.as_tensor(a) for a in arrays[1:]]


def _j(arrays, dtype=jnp.float32):
    return [jnp.asarray(arrays[0]).astype(dtype)] + [
        jnp.asarray(a) for a in arrays[1:]]


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor)
                      else t.astype(jnp.float32))


@pytest.mark.parametrize("B,H,S,p,n,chunk", GRID)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_matches_pallas_and_oracle(B, H, S, p, n, chunk, dtype):
    arrays = _inputs(B, H, S, p, n, seed=S + p)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ops.reset_counters()
    out = ops.ssd_scan(*_t(arrays, dtype), chunk=chunk)
    assert ops.counters() == {"ssd_launches": 0, "ref_calls": 1}
    assert out.dtype == dtype and out.shape == (B, H, S, p)
    pallas = jax_ssd_scan(*_j(arrays, jdt), chunk=chunk)
    oracle = jax_ssd_scan_ref(*_j(arrays, jdt))
    tol = TOL[dtype]
    for ref in (pallas, oracle):
        np.testing.assert_allclose(_np(out), _np(ref), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,H,S,p,n,chunk", GRID + RAGGED)
def test_ssd_scan_ref_matches_reference_oracle(B, H, S, p, n, chunk):
    """The port's sequential oracle, with a seeded initial state and its
    final state, against the reference's (1e-5: the same recurrence)."""
    arrays = _inputs(B, H, S, p, n, seed=3 * S, state=True)
    y, f = ssd_scan_ref(*_t(arrays), return_state=True)
    jy, jf = jax_ssd_scan_ref(*_j(arrays), return_state=True)
    np.testing.assert_allclose(_np(y), _np(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(f), _np(jf), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,H,S,p,n,chunk", GRID + RAGGED)
def test_ssd_chunked_ref_matches_model_chunked(B, H, S, p, n, chunk):
    """The plain chunked version in the model's layout against the
    reference model's ``ssd_chunked`` (ragged tails identity-padded on
    both sides), with and without an initial state; and the kernel
    signature's wrapper against the sequential oracle."""
    x, dt, A, Bm, Cm, s0 = _inputs(B, H, S, p, n, seed=S + n, state=True)
    xm, dtm = x.transpose(0, 2, 1, 3), dt.transpose(0, 2, 1)
    for init in (None, s0):
        y, f = ssd_chunked_ref(*_t([xm, dtm, A, Bm, Cm]), chunk,
                               None if init is None else torch.as_tensor(init))
        jy, jf = jax_ssd_chunked(*_j([xm, dtm, A, Bm, Cm]), chunk,
                                 None if init is None else jnp.asarray(init))
        np.testing.assert_allclose(_np(y), _np(jy), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(_np(f), _np(jf), atol=1e-4, rtol=1e-4)
    y, f = ops.ssd_scan(*_t([x, dt, A, Bm, Cm]), torch.as_tensor(s0),
                        chunk=chunk, return_state=True)
    jy, jf = jax_ssd_scan_ref(*_j([x, dt, A, Bm, Cm, s0]), return_state=True)
    assert f.dtype == torch.float32 and f.shape == (B, H, p, n)
    np.testing.assert_allclose(_np(y), _np(jy), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(f), _np(jf), atol=1e-4, rtol=1e-4)


def test_initial_and_return_state_match_pallas():
    """The carried-state contract against the reference's Pallas kernel
    (seeded initial state, final state returned)."""
    arrays = _inputs(1, 2, 32, 8, 4, seed=11, state=True)
    y, f = ops.ssd_scan(*_t(arrays[:5]), torch.as_tensor(arrays[5]),
                        chunk=8, return_state=True)
    jy, jf = jax_ssd_scan(*_j(arrays), chunk=8, return_state=True)
    np.testing.assert_allclose(_np(y), _np(jy), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(f), _np(jf), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("split", [16, 32, 48])
def test_resume_across_two_calls(split):
    """A scan split at a chunk boundary and resumed from the returned
    state matches the one-call scan (1e-5 on the CPU, see the module
    docstring), and the reference's own split scan."""
    x, dt, A, Bm, Cm = _inputs(2, 3, 64, 16, 8, seed=7)
    full_y, full_f = ops.ssd_scan(*_t([x, dt, A, Bm, Cm]), chunk=16,
                                  return_state=True)
    first = [x[:, :, :split], dt[:, :, :split], A, Bm[:, :split],
             Cm[:, :split]]
    rest = [x[:, :, split:], dt[:, :, split:], A, Bm[:, split:],
            Cm[:, split:]]
    y1, f1 = ops.ssd_scan(*_t(first), chunk=16, return_state=True)
    y2, f2 = ops.ssd_scan(*_t(rest), f1, chunk=16, return_state=True)
    np.testing.assert_allclose(torch.cat([y1, y2], 2).numpy(),
                               full_y.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(f2.numpy(), full_f.numpy(), atol=1e-5,
                               rtol=1e-5)
    jy1, jf1 = jax_ssd_scan(*_j(first), chunk=16, return_state=True)
    jy2, jf2 = jax_ssd_scan(*_j(rest), jf1, chunk=16, return_state=True)
    np.testing.assert_allclose(y2.numpy(), _np(jy2), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(f2.numpy(), _np(jf2), atol=1e-4, rtol=1e-4)


def test_strided_views_and_chunk_grid():
    """The model hands transposed views; the result equals the contiguous
    call. The chunk grid is never shrunk to S: a scan shorter than one
    chunk equals the padded one-chunk scan, and ``dt = 0`` steps are exact
    no-ops on the state."""
    x, dt, A, Bm, Cm = _inputs(2, 3, 20, 8, 4, seed=5)
    xm = torch.as_tensor(np.ascontiguousarray(x.transpose(0, 2, 1, 3)))
    dtm = torch.as_tensor(np.ascontiguousarray(dt.transpose(0, 2, 1)))
    a = ops.ssd_scan(xm.transpose(1, 2), dtm.transpose(1, 2),
                     *_t([A, Bm, Cm]), chunk=32)
    b = ops.ssd_scan(*_t([x, dt, A, Bm, Cm]), chunk=32)
    assert torch.equal(a, b)
    pad = [np.concatenate([x, np.zeros_like(x)], 2),
           np.concatenate([dt, np.zeros_like(dt)], 2), A,
           np.concatenate([Bm, Bm], 1), np.concatenate([Cm, Cm], 1)]
    _, f = ops.ssd_scan(*_t([x, dt, A, Bm, Cm]), chunk=32, return_state=True)
    _, fp = ops.ssd_scan(*_t(pad), chunk=32, return_state=True)
    np.testing.assert_allclose(f.numpy(), fp.numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("B,H,S,p,n,chunk,cols", [
    (2, 3, 100, 64, 16, 32, 16), (1, 2, 64, 16, 8, 16, 4),
    (2, 4, 128, 32, 16, 32, 8), (1, 2, 70, 24, 8, 16, 16)])
def test_column_slices_match_the_unsplit_scan(B, H, S, p, n, chunk, cols):
    """The kernel splits each (b, h) over CTAs by columns of p: y[..., j]
    and state row j depend only on x[..., j], state row j and the shared
    dt, B and C. Each slice, scanned from its own state slice, gives the
    unsplit call's final state bit for bit and its y within 1e-6 (the
    plain version's einsums block their sums by width), the last slice
    ragged where cols does not divide p."""
    x, dt, A, Bm, Cm, s0 = _t(_inputs(B, H, S, p, n, seed=p + n,
                                      state=True))
    y, f = ops.ssd_scan(x, dt, A, Bm, Cm, s0, chunk=chunk,
                        return_state=True)
    parts = [ops.ssd_scan(x[..., j:j + cols], dt, A, Bm, Cm,
                          s0[:, :, j:j + cols], chunk=chunk,
                          return_state=True) for j in range(0, p, cols)]
    ys = torch.cat([py for py, _ in parts], -1)
    fs = torch.cat([pf for _, pf in parts], 2)
    assert torch.equal(fs, f)
    np.testing.assert_allclose(ys.numpy(), y.numpy(), atol=1e-6, rtol=1e-6)


def test_wrapper_rejects_other_devices_and_sizes_smem():
    x, dt, A, Bm, Cm = _t(_inputs(1, 1, 8, 4, 4))
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.ssd_scan(x.to("meta"), dt.to("meta"), A.to("meta"),
                     Bm.to("meta"), Cm.to("meta"), chunk=8)


# ---------------------------------------------------------------------------
# the CUDA kernel (on the card only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the SSD scan kernel runs only on the "
                    "card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,p,n,chunk", GRID + RAGGED + [
    (2, 32, 128, 64, 128, 128), (2, 50, 256, 64, 16, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(cuda_device, B, H, S, p, n, chunk, dtype):
    arrays = _inputs(B, H, S, p, n, seed=S, state=True)
    t = [a.to(cuda_device) for a in _t(arrays, dtype)]
    before = ops.ssd_launches
    y, f = ops.ssd_scan(*t, chunk=chunk, return_state=True)
    assert ops.ssd_launches == before + 1
    ry, rf = ssd_chunked_scan(*t, chunk=chunk, return_state=True)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               ry.float().cpu().numpy(), atol=tol, rtol=tol)
    np.testing.assert_allclose(f.cpu().numpy(), rf.cpu().numpy(), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("p,n,H", [(16, 8, 3), (64, 128, 4), (64, 16, 5),
                                   (64, 128, 32), (64, 16, 50)])
def test_cuda_resume_is_bitwise(cuda_device, p, n, H):
    """One call over 256 tokens against two calls over 128 + 128 threaded
    through the returned state: y and the final state bit for bit."""
    x, dt, A, Bm, Cm = [a.to(cuda_device) for a in
                        _t(_inputs(2, H, 256, p, n, seed=p))]
    y, f = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=128, return_state=True)
    y1, f1 = ops.ssd_scan(x[:, :, :128], dt[:, :, :128], A, Bm[:, :128],
                          Cm[:, :128], chunk=128, return_state=True)
    y2, f2 = ops.ssd_scan(x[:, :, 128:], dt[:, :, 128:], A, Bm[:, 128:],
                          Cm[:, 128:], f1, chunk=128, return_state=True)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([y1, y2], 2), y)
    assert torch.equal(f2, f)


#: the most dynamic shared memory a Hopper CTA may take (bytes)
HOPPER_SMEM = 232448


@pytest.mark.cuda
def test_cuda_shared_memory_fits_and_oversize_raises(cuda_device):
    """mamba2's widths (l = 128, p = 64, n = 128) fit a Hopper CTA only
    because the score matrix is tiled by row blocks; a width past the
    limit is refused at launch with the library's error."""
    assert ops.smem_bytes(64, 128, 128) <= HOPPER_SMEM
    assert 4 * (2 * 128 * 128 + 128 * 64 + 64 * 128 + 128 * 128) \
        > HOPPER_SMEM
    assert ops.smem_bytes(64, 16, 128) <= HOPPER_SMEM        # hymba
    assert ops.smem_bytes(64, 256, 128) > HOPPER_SMEM
    t = [a.to(cuda_device) for a in _t(_inputs(1, 1, 128, 64, 256))]
    with pytest.raises(RuntimeError, match="CUDA error"):
        ops.ssd_scan(*t, chunk=128)


@pytest.mark.cuda
@pytest.mark.parametrize("H,n", [(32, 128), (50, 16)])
def test_cuda_column_split_changes_no_bit(cuda_device, H, n):
    """At mamba2's heads a 2-row call fills the card with CTAs of a
    narrow column slice, an 8-row call takes wider slices; the 2 rows
    inside the 8 give the same y and final state bit for bit."""
    x, dt, A, Bm, Cm, s0 = [a.to(cuda_device) for a in
                            _t(_inputs(8, H, 256, 64, n, seed=H,
                                       state=True))]
    small, big = ops.plan(2, H, 64, n, 128), ops.plan(8, H, 64, n, 128)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert small.ctas >= sms and small.cols < big.cols
    y8, f8 = ops.ssd_scan(x, dt, A, Bm, Cm, s0, chunk=128,
                          return_state=True)
    y2, f2 = ops.ssd_scan(x[:2], dt[:2], A, Bm[:2], Cm[:2], s0[:2],
                          chunk=128, return_state=True)
    torch.cuda.synchronize()
    assert torch.equal(y2, y8[:2]) and torch.equal(f2, f8[:2])
