"""Import paths and shared helpers of the benchmark's tests: the port's
``src/`` and the checkout (for ``bench``); cells cut to the port's smoke
configurations for the CPU."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: ModelConfig fields a configuration file's ``port`` object may set
PORT_FIELDS = ("name", "family", "block", "num_layers", "d_model",
               "num_heads", "num_kv_heads", "head_dim", "d_ff", "vocab_size",
               "qk_norm", "mlp_act", "num_experts", "top_k", "ssm_state",
               "ssm_d_inner", "ssm_head_dim", "ssm_conv", "ssm_chunk",
               "tie_embeddings", "pos_embed", "norm_eps", "rope_theta")

#: each cell cut to a CPU size: the smoke configuration of its family,
#: float32, small rows, chunks and lengths, the same loop and arrivals
SMALL = {
    "olmoe-1b-7b.long_docs": dict(
        rows=4, clients=8, prefill_chunk=16,
        prompt={"dist": "lognormal", "median": 48, "sigma": 1.0, "min": 16,
                "max": 96},
        output={"dist": "uniform", "min": 2, "max": 6}),
    "mamba2-370m.long_docs": dict(
        rows=4, clients=8, prefill_chunk=32,
        prompt={"dist": "lognormal", "median": 64, "sigma": 1.0, "min": 16,
                "max": 160},
        output={"dist": "uniform", "min": 2, "max": 6}),
}
#: the gap a float32 program may read against the float32 reference at
#: these sizes (rounding of a different order of sums), for the widest
#: gap and for the mean alike: a sound run reads 0.0 for both, the fp8
#: control's mean over every finished request 0.033 or more
SMALL_LIMIT = 1e-3


def own_number(cell: str) -> str:
    """The number the cell's own ``check`` holds to a limit
    (``logit_gap`` or ``mean_logit_gap``)."""
    from bench import check
    from bench.run import cell_spec
    chk = cell_spec(cell, ROOT).wl["check"]
    (name,) = [k for k in check.NUMBERS if k in chk]
    return name


def small_spec(cell: str, number: str | None = None):
    """The cell's spec (``bench.run.cell_spec``) cut to a CPU size, its
    check holding ``number`` (by default the cell's own) to
    :data:`SMALL_LIMIT`."""
    from bench.run import cell_spec
    from repro_torch.configs import get_smoke_config
    spec = cell_spec(cell, ROOT)
    smoke = get_smoke_config(spec.cfg["port"]["name"])
    port = {k: getattr(smoke, k) for k in PORT_FIELDS}
    spec.cfg = dict(spec.cfg, dtype="float32", port=port)
    spec.wl = dict(spec.wl, **SMALL[cell], check={
        "requests": 4, number or own_number(cell): SMALL_LIMIT})
    return spec


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the benchmark measures the card")
    return torch.device("cuda")
