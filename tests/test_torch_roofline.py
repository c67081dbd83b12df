"""The port's roofline (``repro_torch.roofline``) against the reference's
(``repro.roofline``): the analytic FLOP and byte formulas equal for
every architecture x shape x mesh, the collective summary equal on the
records the reference parses from its own test HLO, the workload shapes
and meshes equal, the H100 constants, and the report rendered from a
temporary artifact directory."""

import dataclasses

import pytest

from repro import config as jconfig
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.roofline import flops as jflops
from repro.roofline.analysis import parse_collectives
from repro.roofline.analysis import \
    summarize_collectives as jsummarize_collectives
from repro_torch import config as tconfig
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.roofline import flops as tflops
from repro_torch.roofline.analysis import (collective_record,
                                           summarize_collectives)
from repro_torch.roofline.hw import H100
from tests.test_dryrun import FAKE_HLO

MESH_NAMES = ("single_pod", "multi_pod", "test8")


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cell_flops_and_bytes_equal_the_reference(arch):
    """Full and smoke configs x every shape x three meshes, with and
    without an explicit cache length: the same dicts, key for key and
    value for value."""
    for tget, jget in ((get_config, jget_config),
                       (get_smoke_config, jget_smoke_config)):
        cfg, jcfg = tget(arch), jget(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        for name, shape in tconfig.SHAPES.items():
            jshape = jconfig.SHAPES[name]
            assert (tflops.cell_compute_flops(cfg, shape)
                    == jflops.cell_compute_flops(jcfg, jshape))
            for mesh in MESH_NAMES:
                for cache_len in (None, 2048):
                    got = tflops.cell_memory_bytes(
                        cfg, shape, tconfig.MESHES[mesh],
                        cache_len=cache_len)
                    want = jflops.cell_memory_bytes(
                        jcfg, jshape, jconfig.MESHES[mesh],
                        cache_len=cache_len)
                    assert got == want, (name, mesh, cache_len)


def test_shapes_meshes_and_applicability_equal_the_reference():
    assert tconfig.SHAPES.keys() == jconfig.SHAPES.keys()
    for name, shape in tconfig.SHAPES.items():
        assert (dataclasses.asdict(shape)
                == dataclasses.asdict(jconfig.SHAPES[name]))
    for name in ("TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K"):
        assert (dataclasses.asdict(getattr(tconfig, name))
                == dataclasses.asdict(getattr(jconfig, name)))
    assert tconfig.MESHES.keys() == jconfig.MESHES.keys()
    for name, mesh in tconfig.MESHES.items():
        jm = jconfig.MESHES[name]
        assert dataclasses.asdict(mesh) == dataclasses.asdict(jm)
        assert (mesh.num_devices, mesh.dp, mesh.tp) == (jm.num_devices,
                                                        jm.dp, jm.tp)
    for arch in ARCH_NAMES:
        for name in tconfig.SHAPES:
            assert (tconfig.shape_applicable(get_config(arch),
                                             tconfig.SHAPES[name])
                    == jconfig.shape_applicable(jget_config(arch),
                                                jconfig.SHAPES[name]))


def test_summarize_collectives_equals_the_reference_on_parsed_records():
    colls = parse_collectives(FAKE_HLO)
    assert summarize_collectives(colls) == jsummarize_collectives(colls)


def test_collective_record_reproduces_the_parsed_arithmetic():
    """Each record the reference parses from its test HLO, rebuilt from
    its op, operand bytes, group and trips."""
    for c in parse_collectives(FAKE_HLO):
        g = c["group_size"] or 2
        rec = collective_record(c["op"], c["computation"],
                                c["operand_bytes"], g, c["trip_multiplier"],
                                num_groups=c["num_groups"])
        for k in ("operand_bytes", "output_bytes", "trip_multiplier",
                  "total_operand_bytes", "total_effective_bytes"):
            assert rec[k] == pytest.approx(c[k], rel=1e-12), (c["op"], k)
        assert rec["source"] == "spec"


def test_h100_constants():
    """The H100 SXM5 80GB data sheet's numbers; no TPU field or value."""
    assert H100.peak_flops_bf16 == 989e12
    assert H100.peak_flops_f32 == 67e12
    assert H100.hbm_bw == 3.35e12
    assert H100.hbm_bytes == 80e9
    assert H100.nvlink_bw == 450e9            # 900 GB/s both directions
    assert H100.network_bw == 50e9            # 400 Gb/s a GPU
    assert H100.smem_per_sm_bytes == 228 * 1024
    fields = {f.name for f in dataclasses.fields(H100)}
    assert not fields & {"ici_link_bw", "dcn_bw", "vmem_bytes"}
    assert 197e12 not in dataclasses.astuple(H100)     # v5e's peak
    assert "tpu" not in H100.name


def test_report_renders_from_an_artifact_directory(tmp_path, monkeypatch,
                                                   capsys):
    """The dry run's CLI writes an artifact under the directory the
    environment names; the report's tables read it back."""
    from repro_torch.launch import dryrun
    from repro_torch.roofline import report
    monkeypatch.setenv("REPRO_TORCH_ARTIFACT_DIR", str(tmp_path))
    dryrun.main(["--smoke", "--arch", "mamba2-370m", "--shape",
                 "decode_32k", "--mesh", "multi_pod"])
    path = tmp_path / "multi_pod" / "mamba2-370m__decode_32k.json"
    assert path.exists()
    assert report.load_records("single_pod") == []
    recs = report.load_records("multi_pod")
    assert len(recs) == 1 and recs[0]["meta"]["arch"] == "mamba2-smoke"
    table = report.roofline_table("multi_pod")
    row = [r for r in table.splitlines() if "mamba2-smoke" in r]
    assert len(row) == 1 and "| decode_32k |" in row[0]
    assert "memory" in row[0] and "batch more" in row[0]
    summary = report.dryrun_summary("multi_pod")
    assert "| trace s |" in summary and "mamba2-smoke" in summary
    capsys.readouterr()
    report.main()
    out = capsys.readouterr().out
    assert "## Roofline — multi_pod" in out and "mamba2-smoke" in out
