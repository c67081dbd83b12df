"""Port layers vs ``repro.models.layers`` on the gemma-2b smoke config.

Inputs and weights are made by numpy from a seed and handed to both
sides. Everything is float32 on the CPU. The tolerance is 1e-5 for the
elementwise functions (last-ulp differences in rsqrt/cos/sin) and 1e-4
for the projections and MLP, whose outputs of magnitude up to ~10 are
sums of 64-128 products taken in different orders by the two
frameworks.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers as TL

TOL = 1e-5
CFG = get_smoke_config("gemma-2b")


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               atol=tol, rtol=tol)


def test_smoke_config_matches_reference():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(
        jax_smoke_config("gemma-2b"))


@pytest.mark.parametrize("unit_offset", [False, True])
def test_rmsnorm(unit_offset):
    rng = _rng(1)
    x = rng.standard_normal((2, 5, CFG.d_model), dtype=np.float32) * 3
    w = rng.standard_normal((CFG.d_model,), dtype=np.float32) * 0.1
    ref = JL.rmsnorm(jnp.asarray(x), jnp.asarray(w), eps=CFG.norm_eps,
                     unit_offset=unit_offset)
    port = TL.rmsnorm(torch.as_tensor(x), torch.as_tensor(w),
                      eps=CFG.norm_eps, unit_offset=unit_offset)
    _close(port, ref)


@pytest.mark.parametrize("per_row", [False, True])
def test_rope(per_row):
    rng = _rng(2)
    B, S, H, hd = 2, 6, CFG.num_heads, CFG.head_dim
    x = rng.standard_normal((B, S, H, hd), dtype=np.float32)
    pos = (rng.integers(0, 600, size=(B, S)) if per_row
           else np.arange(S) + 17)
    jc, js = JL.rope_cos_sin(jnp.asarray(pos), hd, CFG.rope_theta)
    tc, ts = TL.rope_cos_sin(torch.as_tensor(pos), hd, CFG.rope_theta)
    _close(tc, jc)
    _close(ts, js)
    ref = JL.apply_rope(jnp.asarray(x), jc, js)
    port = TL.apply_rope(torch.as_tensor(x), tc, ts)
    _close(port, ref)


def _attn_params(rng):
    d, h, hkv, hd = CFG.d_model, CFG.num_heads, CFG.num_kv_heads, CFG.head_dim
    return {"wq": rng.standard_normal((d, h, hd), dtype=np.float32) * 0.1,
            "wk": rng.standard_normal((d, hkv, hd), dtype=np.float32) * 0.1,
            "wv": rng.standard_normal((d, hkv, hd), dtype=np.float32) * 0.1,
            "wo": rng.standard_normal((h, hd, d), dtype=np.float32) * 0.1}


def test_project_qkv_repeat_kv_and_output():
    rng = _rng(3)
    p = _attn_params(rng)
    x = rng.standard_normal((2, 7, CFG.d_model), dtype=np.float32)
    pos = rng.integers(0, 300, size=(2, 7))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    jq, jk, jv = JL.project_qkv(jp, jnp.asarray(x), CFG, jnp.asarray(pos))
    tq, tk, tv = TL.project_qkv(tp, torch.as_tensor(x), CFG,
                                torch.as_tensor(pos))
    for port, ref in ((tq, jq), (tk, jk), (tv, jv)):
        assert tuple(port.shape) == ref.shape
        _close(port, ref, tol=1e-4)
    _close(TL.repeat_kv(tk, CFG.num_heads), JL.repeat_kv(jk, CFG.num_heads),
           tol=1e-4)
    ctx = rng.standard_normal((2, 7, CFG.num_heads, CFG.head_dim),
                              dtype=np.float32)
    _close(TL.attn_output(tp, torch.as_tensor(ctx), torch.float32),
           JL.attn_output(jp, jnp.asarray(ctx), jnp.float32), tol=1e-4)


@pytest.mark.parametrize("act", ["geglu", "swiglu", "gelu"])
def test_mlp_apply(act):
    """GeGLU is gemma's; its GELU is the tanh approximation on both
    sides (jax.nn.gelu's default)."""
    cfg = dataclasses.replace(CFG, mlp_act=act)
    rng = _rng(4)
    d, f = cfg.d_model, cfg.d_ff
    p = {"w_gate": rng.standard_normal((d, f), dtype=np.float32) * 0.2,
         "w_up": rng.standard_normal((d, f), dtype=np.float32) * 0.2,
         "w_down": rng.standard_normal((f, d), dtype=np.float32) * 0.1}
    x = rng.standard_normal((3, 4, d), dtype=np.float32)
    ref = JL.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x), cfg)
    port = TL.mlp_apply({k: torch.as_tensor(v) for k, v in p.items()},
                        torch.as_tensor(x), cfg)
    _close(port, ref, tol=1e-4)


def test_neg_inf_is_finite_like_the_reference():
    assert TL.NEG_INF == JL.NEG_INF == -1e30
