"""The control of ``correct``: the plain reference put in the program's
place at fp8, the precision below the configurations' bf16, must come
out as not correct. On the CPU at the smoke sizes against the small
limit; on the card at each cell's own size against the cell's limit, on
three seeds."""

import json

import pytest

from conftest import ROOT, SMALL, SMALL_LIMIT, small_spec


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_is_not_correct_at_a_cpu_size(cell):
    from bench.calibrate import readings
    spec = small_spec(cell)
    # every finished request: at these widths few tokens change argmax
    spec.wl["check"] = dict(spec.wl["check"], requests=1000)
    rows = list(readings(spec, [2 ** 31 + 7], 2.0, 1, device="cpu"))
    prog, ctrl = rows[0]["program"], rows[0]["control"]
    assert prog["tokens"] > 0 and ctrl["tokens"] == prog["tokens"]
    assert rows[0]["correct"]
    assert prog["logit_gap"] <= SMALL_LIMIT
    assert ctrl["logit_gap"] > SMALL_LIMIT
    assert ctrl["mean_logit_gap"] > prog["mean_logit_gap"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_is_not_correct_at_the_cell_s_size(cell, cuda_device):
    from bench.calibrate import readings
    from bench.run import _prepare, cell_spec
    _prepare(ROOT)
    spec = cell_spec(cell, ROOT)
    from bench import check
    limits = json.loads((ROOT / "bench" / "workloads" / f"{cell}.json")
                        .read_text())["check"]
    rows = list(readings(spec, [101, 102, 103], 10.0, 3))
    for r in rows:
        ok, _ = check.judge(r["control"], limits)
        assert not ok, r
