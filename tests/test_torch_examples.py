"""The port's examples (``repro_torch.examples``, the twins of the
reference's ``examples/*.py``) run on the CPU at their smallest size:
each ``main`` passes its own printed checks, and the paths that reach a
kernel on the card ran through its wrapper (here the wrapper's plain
version: the tensors lie on the CPU)."""

import importlib

import pytest
import torch

#: example -> (argv beyond --device cpu, kernels its path reaches on the
#: card)
EXAMPLES = {
    "quickstart": ([], ("msgq_eager", "msgq_one_copy")),
    "collectives_demo": ([], ("msgq_eager", "msgq_one_copy")),
    "spmv_petsc": (["--n", "16", "--iters", "3"],
                   ("msgq_eager", "msgq_one_copy")),
    "serve_continuous": ([], ("paged_decode", "paged_mq")),
    "serve_fabric": ([], ("paged_decode", "paged_mq")),
    "train_lm": (["--steps", "3"], ()),
}


@pytest.fixture
def one_thread():
    """Tiny ops: one intra-op thread is faster than many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_main_on_cpu(name, one_thread, tmp_path):
    argv, kernels = EXAMPLES[name]
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    if name == "train_lm":
        argv = argv + ["--ckpt-dir", str(tmp_path)]
    out = mod.main(argv + ["--device", "cpu"])
    assert out["ok"], out["checks"]
    counts = out["kernels"]
    # no card here: nothing launched, the kernels' plain versions ran
    assert all(counts[k] == 0 for k in counts if k != "plain_calls")
    assert (counts["plain_calls"] > 0) == bool(kernels), counts


@pytest.mark.parametrize("device", ["cpu", "cuda", "cuda:0"])
def test_serving_examples_take_their_widths_from_the_device(device):
    """The serving examples run the reference's smoke config on the CPU
    and gemma-2b's published widths on the card, whose paged and flash
    kernels take head dims 64/128/256 (building the config needs no
    card)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.examples import serving_config
    cfg = serving_config(device)
    if device == "cpu":
        assert cfg == get_smoke_config("gemma-2b")
    else:
        assert cfg == get_config("gemma-2b")
        assert cfg.head_dim in (64, 128, 256)


def test_examples_default_to_the_card():
    """Each example's ``--device`` defaults to cuda: without a card it
    raises rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    mod = importlib.import_module("repro_torch.examples.quickstart")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
