"""Each plain reference against the port at the smoke widths on the CPU,
in float32, on the parameters the benchmark draws."""

import pytest
import torch

from conftest import PORT_FIELDS

CASES = [("olmoe-1b-7b", "olmoe"), ("mamba2-370m", "mamba2")]


def _setup(arch, family, seed):
    import importlib

    from repro_torch.config import ServeConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import build_model
    cfg = get_smoke_config(arch)
    c = {k: getattr(cfg, k) for k in PORT_FIELDS}
    ref = importlib.import_module(f"bench.reference.{family}")
    model = build_model(cfg, ServeConfig(param_dtype="float32",
                                         compute_dtype="float32"),
                        device="cpu")
    return c, ref, model, ref.make_params(c, seed, "cpu", torch.float32)


@pytest.mark.parametrize("arch,family", CASES)
@pytest.mark.parametrize("length", [1, 37, 130])
def test_reference_logits_equal_the_port_s_prefill(arch, family, length):
    c, ref, model, params = _setup(arch, family, 2 ** 31 + length)
    g = torch.Generator().manual_seed(length)
    tok = torch.randint(0, c["vocab_size"], (1, length), generator=g)
    port, _ = model.prefill(params, tok, length + 8)
    mine = ref.logits(params, c, tok[0], 0)
    assert mine.shape == (length, c["vocab_size"])
    torch.testing.assert_close(mine[-1], port[0, :c["vocab_size"]],
                               atol=2e-5, rtol=2e-5)
    # the logits are spread, not collapsed
    assert float(mine[-1].std()) > 0.5


@pytest.mark.parametrize("arch,family", CASES)
def test_control_is_not_the_reference(arch, family):
    c, ref, _, params = _setup(arch, family, 5)
    tok = torch.randint(0, c["vocab_size"], (48,),
                        generator=torch.Generator().manual_seed(5))
    z = ref.logits(params, c, tok, 16)
    z8 = ref.logits(params, c, tok, 16, precision="fp8")
    assert z.shape == z8.shape == (32, c["vocab_size"])
    err = float((z - z8).abs().max())
    assert 1e-3 < err < 0.5 * float(z.abs().max())


@pytest.mark.parametrize("arch,family", CASES)
def test_params_are_the_seed_s(arch, family):
    c, ref, _, a = _setup(arch, family, 3)
    b = ref.make_params(c, 3, "cpu", torch.float32)
    d = ref.make_params(c, 4, "cpu", torch.float32)
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], d["embed"])
