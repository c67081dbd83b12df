"""What the benchmark may load: nothing of JAX or the JAX package, by
whole top-level name (``repro_torch`` begins with ``repro``), and in the
references nothing of the port either."""

import ast
import sys
import types

import pytest

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
BENCH = ROOT / "bench"


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def _modules():
    return sorted(p for p in BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", _modules(), ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    found = _top_level_imports(path) & FORBIDDEN
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    names = _top_level_imports(path)
    assert "repro_torch" not in names
    assert names <= {"__future__", "math", "torch", "bench"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("bench"):
            assert node.module.startswith("bench.reference"), node.module


def test_the_run_s_module_check_compares_whole_names(monkeypatch):
    import repro_torch  # noqa: F401
    from bench.run import forbidden_modules
    before = set(forbidden_modules())
    assert "repro_torch" not in before
    monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert set(forbidden_modules()) == before | {"repro", "jax"}


@pytest.mark.parametrize("where", [None, "reference", "reader"])
def test_no_result_once_jax_is_loaded_after_the_window(where, monkeypatch,
                                                       capsys):
    """A whole run through ``main`` (the look for a card skipped, the CPU
    at a small size): where the reference or a per-layer reader loads a
    module named ``jax`` after the window, the run ends with no result;
    where nothing does, it prints one."""
    import json
    import time

    import torch

    from bench import run
    from conftest import small_spec

    cell = "mamba2-370m.long_docs"
    spec = small_spec(cell)

    def loads_jax(fn):
        def wrapped(*a, **kw):
            monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(run, "cell_spec", lambda name, root=run.ROOT: spec)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "_prepare", lambda root=run.ROOT: None)
    # the CPU has no device to profile: the slice would start past the
    # window's close (a closed loop is never idle, so it would start)
    monkeypatch.setattr(run, "SLICE_AT", 2.0)
    real_run = run.run_cell
    monkeypatch.setattr(run, "run_cell", lambda s, seed, seconds, trace: (
        real_run(s, seed, seconds, trace, device="cpu",
                 t_start=time.perf_counter())))
    if where == "reference":
        ref = run.reference(spec.cfg)
        monkeypatch.setattr(ref, "logits", loads_jax(ref.logits))
    elif where == "reader":
        real_load = run.load_reader

        def load(name, root=run.ROOT):
            mod = real_load(name, root)
            mod.read = loads_jax(mod.read)
            return mod
        monkeypatch.setattr(run, "load_reader", load)
    argv = ["--workload", cell, "--seed", str(2 ** 31 + 9), "--seconds",
            "1", "--trace", "1" if where == "reader" else "0"]
    if where is None:
        assert run.main(argv) == 0
        out = capsys.readouterr().out.strip().splitlines()
        assert list(json.loads(out[-1]))[-1] == "checks"
        return
    with pytest.raises(SystemExit) as stop:
        run.main(argv)
    assert "jax" in str(stop.value.code)
    assert "{" not in capsys.readouterr().out
