"""Port Mamba2 block (``repro_torch.models.mamba``) vs the JAX reference's
``repro.models.mamba``, for the mamba2 and hymba smoke configs.

The reference's ``init_ssm`` draws the parameters; they move to the port
as numpy arrays (``A_log``, ``D``, ``dt_bias`` stay float32). Inputs and
carried states are made by numpy from a seed. Float32 on the CPU, where
the port's scan is its plain chunked version: outputs and states are held
to 1e-5 (the two sides sum in different orders; the conv window holds
rows of the ``in_proj`` product, which the two frameworks also sum in
different orders). Within the port, a window that only copies rows is
held exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import mamba as jm
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.ssd_scan import ops
from repro_torch.models import mamba as tm

ARCHS = ["mamba2-370m", "hymba-1.5b"]
TOL = 1e-5


@pytest.fixture(scope="module", params=ARCHS)
def block(request):
    jcfg = jax_smoke_config(request.param)
    cfg = get_smoke_config(request.param)
    jp = jm.init_ssm(jcfg, jax.random.PRNGKey(3), jnp.float32)
    tp = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in jp.items()}
    return jcfg, cfg, jp, tp


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model), dtype=np.float32)


def _state(cfg, B, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_state
    return {"conv": rng.standard_normal((B, cfg.ssm_conv - 1, conv_dim),
                                        dtype=np.float32) * scale,
            "ssm": rng.standard_normal((B, cfg.ssm_heads, cfg.ssm_head_dim,
                                        cfg.ssm_state),
                                       dtype=np.float32) * scale}


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


def test_init_ssm_scheme_matches_reference(block):
    """Same leaves, shapes and dtypes; the deterministic leaves equal; the
    dt bias maps into the reference's [1e-3, 1e-1] rate range."""
    jcfg, cfg, jp, _ = block
    gen = torch.Generator().manual_seed(0)
    p = tm.init_ssm(cfg, gen, "cpu", torch.bfloat16)
    assert set(p) == set(jp)
    for k, v in jp.items():
        assert tuple(p[k].shape) == tuple(v.shape), k
    for k in ("A_log", "D", "dt_bias"):
        assert p[k].dtype == torch.float32
    assert p["in_proj"].dtype == torch.bfloat16
    _close(p["A_log"], jp["A_log"], 0)
    _close(p["D"], jp["D"], 0)
    rate = torch.nn.functional.softplus(p["dt_bias"])
    assert bool(((rate >= 1e-3 - 1e-7) & (rate <= 1e-1 + 1e-7)).all())


def test_causal_conv_matches_reference(block):
    jcfg, cfg, jp, tp = block
    conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_state
    xs = np.random.default_rng(1).standard_normal((2, 11, conv_dim),
                                                  dtype=np.float32)
    out = tm._causal_conv(torch.as_tensor(xs), tp["conv_w"], tp["conv_b"])
    ref = jm._causal_conv(jnp.asarray(xs), jp["conv_w"], jp["conv_b"])
    _close(out, ref)


@pytest.mark.parametrize("S", [1, 3, 13, 16, 21])
def test_ssm_apply_and_state_match_reference(block, S):
    """Monolithic block: output and returned state (ragged S, and S
    shorter than the conv window), from zeros and from a seeded initial
    scan state. The plain scan runs once per call."""
    jcfg, cfg, jp, tp = block
    x = _x(cfg, 2, S, seed=S)
    s0 = _state(cfg, 2, seed=S + 1)["ssm"]
    outs = []
    for init in (None, s0):
        ops.reset_counters()
        out, st = tm.ssm_apply(tp, torch.as_tensor(x), cfg,
                               None if init is None else torch.as_tensor(init),
                               return_state=True)
        assert ops.counters()["ref_calls"] == 1
        ref, jst = jm.ssm_apply(jp, jnp.asarray(x), jcfg,
                                None if init is None else jnp.asarray(init),
                                return_state=True)
        _close(out, ref)
        _close(st["conv"], jst["conv"])
        _close(st["ssm"], jst["ssm"])
        outs.append(out)
    assert torch.equal(tm.ssm_apply(tp, torch.as_tensor(x), cfg), outs[0])


def test_ssm_apply_chunk_matches_reference(block):
    """One engine chunk from a carried state: full rows, a partial row
    (padding rows), an ``n_valid == 0`` row (its state and window stay),
    and the new conv window ending at the last valid row."""
    jcfg, cfg, jp, tp = block
    C = 2 * cfg.ssm_chunk
    x = _x(cfg, 4, C, seed=5)
    st = _state(cfg, 4, seed=6)
    n_valid = np.array([C, 5, 0, 1], np.int32)
    out, new = tm.ssm_apply_chunk(
        tp, torch.as_tensor(x), cfg,
        {k: torch.as_tensor(v) for k, v in st.items()},
        torch.as_tensor(n_valid))
    ref, jnew = jm.ssm_apply_chunk(
        jp, jnp.asarray(x), jcfg, {k: jnp.asarray(v) for k, v in st.items()},
        jnp.asarray(n_valid))
    for b, nv in enumerate(n_valid):
        _close(out[b, :nv], ref[b, :nv])
    _close(new["conv"], jnew["conv"])
    _close(new["ssm"], jnew["ssm"])
    # the all-padding row keeps its carried state and window exactly
    assert np.array_equal(new["conv"][2].numpy(), st["conv"][2])
    _close(new["ssm"][2], st["ssm"][2], 0)


def test_ssm_apply_chunk_from_zeros_equals_monolithic(block):
    """A first chunk (zero state) on the fixed chunk grid computes what the
    monolithic block computes over the same rows (1e-5; the plain scan)."""
    jcfg, cfg, jp, tp = block
    x = _x(cfg, 1, 3 * cfg.ssm_chunk, seed=9)
    zero = {k: torch.zeros(v.shape) for k, v in _state(cfg, 1, 0).items()}
    a, st_a = tm.ssm_apply_chunk(tp, torch.as_tensor(x), cfg, zero,
                                 torch.tensor([x.shape[1]]))
    b, st_b = tm.ssm_apply(tp, torch.as_tensor(x), cfg, return_state=True)
    _close(a, b)
    assert torch.equal(st_a["conv"], st_b["conv"])
    _close(st_a["ssm"], st_b["ssm"])


def test_ssm_decode_step_matches_reference(block):
    jcfg, cfg, jp, tp = block
    x = _x(cfg, 3, 1, seed=12)
    st = _state(cfg, 3, seed=13)
    out, new = tm.ssm_decode_step(
        tp, torch.as_tensor(x), {k: torch.as_tensor(v) for k, v in st.items()},
        cfg)
    ref, jnew = jm.ssm_decode_step(
        jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in st.items()}, jcfg)
    _close(out, ref)
    _close(new["conv"], jnew["conv"])
    # the window rolls: its first k-2 rows are the old state's last rows
    assert np.array_equal(new["conv"][:, :-1].numpy(), st["conv"][:, 1:])
    _close(new["ssm"], jnew["ssm"])
    # a decode step after a monolithic pass continues it (the recurrence
    # and the chunked scan agree, 1e-5)
    xs = _x(cfg, 1, 6, seed=14)
    full = tm.ssm_apply(tp, torch.as_tensor(xs), cfg)
    _, state = tm.ssm_apply(tp, torch.as_tensor(xs[:, :5]), cfg,
                            return_state=True)
    step, _ = tm.ssm_decode_step(tp, torch.as_tensor(xs[:, 5:]), state, cfg)
    _close(step[:, 0], full[:, 5])


def test_init_ssm_state_shapes(block):
    jcfg, cfg, _, _ = block
    st = tm.init_ssm_state(cfg, 2, torch.bfloat16, "cpu")
    jst = jm.init_ssm_state(jcfg, 2, jnp.bfloat16)
    for k in ("conv", "ssm"):
        assert tuple(st[k].shape) == tuple(jst[k].shape)
    assert st["ssm"].dtype == torch.float32
    assert st["conv"].dtype == torch.bfloat16
