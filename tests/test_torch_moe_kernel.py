"""The top-k expert kernels of the dropless MoE layer (``kernels/moe``).

On the CPU: the wrapper takes the plain version and counts it; the
plain dispatch's tables keep their invariants on random ids (each
expert's assignments contiguous, in (token, slot) order, the row tiles
covering exactly its rows); the plain layer equals the dense sum in
which the unpicked experts carry a zero gate; the wrapper refuses what
the kernels do not take.

On the card (``cuda``: skips without one; no JAX import, so these run
where JAX is not installed): the kernels against the plain version at
olmoe-1b-7b's chunk shape (T = 4096, K = 8 of 64, d 2048, f 1024), its
decode shape (T = 64), dbrx-132b's full width (16 experts, K = 4, d
6144, f 10752) and the smoke widths (ragged tiles), in bfloat16 and
float32, twice bit for bit; the dispatch kernel's tables equal the plain
ones exactly; a token's output bit for bit whatever its neighbours in
the batch; one layer call with no host sync; the launch counter moving
once a call.
"""

import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels.moe import ops
from repro_torch.kernels.moe.ref import dispatch_ref, moe_experts_ref

#: kernel vs plain version. bfloat16: both compute g, u and the down
#: product in float32 and round h (and the output) to bfloat16 once, from
#: sums taken in other orders, so an element of h can land one bf16 ulp
#: apart and the output a few ulps: 1.6e-2 of the output's largest
#: magnitude. float32: the same sums in other orders only.
TOL = {torch.bfloat16: 1.6e-2, torch.float32: 2e-5}

#: (label, T, K, E, d, f)
SHAPES = [("olmoe_chunk", 4096, 8, 64, 2048, 1024),
          ("olmoe_decode", 64, 8, 64, 2048, 1024),
          ("dbrx_full_width", 256, 4, 16, 6144, 10752),
          ("smoke_olmoe", 40, 2, 8, 64, 32),
          ("smoke_dbrx", 40, 2, 4, 64, 96)]


def _inputs(T, K, E, d, f, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((T, d), generator=g).to(dtype)
    logits = torch.randn((T, E), generator=g)
    gates, idx = torch.sort(torch.softmax(logits, -1), dim=-1,
                            descending=True, stable=True)
    gates, idx = gates[:, :K], idx[:, :K]
    gates = gates / gates.sum(-1, keepdim=True)
    w = [(torch.randn(shape, generator=g) * shape[1] ** -0.5).to(dtype)
         for shape in ((E, d, f), (E, d, f), (E, f, d))]
    return [t.to(device) for t in (x, idx, gates, *w)]


def _dense(x, idx, gates, w_gate, w_up, w_down):
    """The reference's form: every expert on every token, zero gates for
    the unpicked, float32."""
    E = w_gate.shape[0]
    weights = torch.zeros((x.shape[0], E)).scatter_(1, idx, gates)
    xe = x.float().unsqueeze(0).expand(E, -1, -1)
    out_e = torch.bmm(F.silu(torch.bmm(xe, w_gate.float()))
                      * torch.bmm(xe, w_up.float()), w_down.float())
    return torch.einsum("te,etd->td", weights, out_e)


# ---------------------------------------------------------------------------
# the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,K,E", [(1, 2, 8), (37, 2, 4), (200, 8, 64),
                                   (64, 4, 16)])
@pytest.mark.parametrize("bm", [1, 64, 128])
def test_dispatch_tables_keep_their_invariants(T, K, E, bm):
    idx = torch.stack([torch.randperm(E, generator=torch.Generator()
                                      .manual_seed(t))[:K]
                       for t in range(T)])
    offsets, perm, tiles = dispatch_ref(idx, E, bm)
    flat = idx.reshape(-1)
    counts = torch.bincount(flat, minlength=E)
    assert offsets.tolist() == [0] + counts.cumsum(0).tolist()
    assert sorted(perm.tolist()) == list(range(T * K))
    for e in range(E):
        rows = perm[offsets[e]:offsets[e + 1]].tolist()
        assert rows == sorted(rows) and all(flat[a] == e for a in rows)
    live = tiles[tiles[:, 0] >= 0]
    assert len(tiles) == -(-T * K // bm) + E
    assert (tiles[len(live):] == torch.tensor([-1, 0])).all()
    for e in range(E):
        starts = live[live[:, 0] == e, 1].tolist()
        want = list(range(int(offsets[e]), int(offsets[e + 1]), bm))
        assert starts == want


@pytest.mark.parametrize("label,T,K,E,d,f", SHAPES[3:])
def test_plain_layer_equals_the_zero_gated_dense_sum(label, T, K, E, d, f):
    args = _inputs(T, K, E, d, f, torch.float32, "cpu", seed=T)
    before = ops.ref_calls
    out = ops.moe_experts(*args)
    assert ops.ref_calls == before + 1
    torch.testing.assert_close(out, _dense(*args), atol=1e-5, rtol=1e-5)


def test_wrapper_refuses_what_the_kernels_do_not_take():
    x, idx, gates, wg, wu, wd = _inputs(4, 2, 4, 64, 32, torch.float32,
                                        "cpu")
    with pytest.raises(TypeError):
        ops.moe_experts(x.half(), idx, gates, wg, wu, wd)
    with pytest.raises(ValueError):
        ops.moe_experts(x, idx, gates, wg, wu, wd[:, :16])
    with pytest.raises(ValueError):
        ops.moe_experts(x[:, :32], idx, gates, wg, wu, wd)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.dispatch(idx.to("meta"), 4, 64)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp(min=1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("label,T,K,E,d,f", SHAPES)
def test_cuda_kernel_matches_plain(cuda_device, label, T, K, E, d, f, dtype):
    if dtype == torch.float32 and label == "dbrx_full_width":
        T = 32                  # the float32 products run on CUDA cores
    args = _inputs(T, K, E, d, f, dtype, cuda_device, seed=T + d)
    before = ops.moe_launches
    out = ops.moe_experts(*args)
    again = ops.moe_experts(*args)
    assert ops.moe_launches == before + 2
    ref = moe_experts_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, again), label
    assert torch.isfinite(out.float()).all()
    assert _rel(out, ref) <= TOL[dtype], (label, _rel(out, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("T,K,E,bm", [(4096, 8, 64, 128), (64, 8, 64, 128),
                                      (256, 4, 16, 64), (1, 2, 8, 128)])
def test_cuda_dispatch_tables_equal_the_plain_ones(cuda_device, T, K, E, bm):
    # expert E - 1 unpicked, expert 0 crowded
    idx = torch.randint(0, E - 1, (T, K),
                        generator=torch.Generator().manual_seed(T))
    idx[: T // 2, 0] = 0
    ours = ops.dispatch(idx.to(cuda_device), E, bm)
    plain = dispatch_ref(idx, E, bm)
    torch.cuda.synchronize()
    for a, b in zip(ours, plain):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_token_output_ignores_its_neighbours(cuda_device, dtype):
    """Rows 0..99 of a 4096-token call, alone, and among other
    neighbours: the same bits."""
    T, K, E, d, f = 4096, 8, 64, 2048, 1024
    x, idx, gates, *w = _inputs(T, K, E, d, f, dtype, cuda_device)
    whole = ops.moe_experts(x, idx, gates, *w)
    alone = ops.moe_experts(x[:100], idx[:100], gates[:100], *w)
    mixed = torch.cat([x[:100], x.flip(0)[:900]])
    mixed_idx = torch.cat([idx[:100], idx.flip(0)[:900]])
    mixed_gates = torch.cat([gates[:100], gates.flip(0)[:900]])
    among = ops.moe_experts(mixed, mixed_idx, mixed_gates, *w)
    torch.cuda.synchronize()
    assert torch.equal(whole[:100], alone)
    assert torch.equal(whole[:100], among[:100])


@pytest.mark.cuda
def test_cuda_layer_makes_no_host_sync(cuda_device):
    """moe_apply_dropless (router and experts) at olmoe's widths under
    torch's sync debug mode set to raise; one launch a call."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config("olmoe-1b-7b")
    p = moe.init_moe(cfg, torch.Generator(cuda_device).manual_seed(0),
                     cuda_device, torch.bfloat16)
    x = torch.randn((2, 32, cfg.d_model), device=cuda_device,
                    dtype=torch.bfloat16)
    moe.moe_apply_dropless(p, x, cfg)                   # builds, warms up
    torch.cuda.synchronize()
    before = ops.moe_launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = moe.moe_apply_dropless(p, x, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert ops.moe_launches == before + 1
    assert out.shape == x.shape and torch.isfinite(out.float()).all()
