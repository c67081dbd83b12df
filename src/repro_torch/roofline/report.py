"""Render the roofline tables from the port's dry-run artifacts — the port
of ``src/repro/roofline/report.py``.

Reads ``<artifact dir>/<mesh>/*.json`` as ``launch/dryrun.py`` writes
them (``build/dryrun/`` unless ``REPRO_TORCH_ARTIFACT_DIR`` says
otherwise).

Run:  PYTHONPATH=src python -m repro_torch.roofline.report
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

_SHAPE_ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2,
                "long_500k": 3}


def artifact_dir() -> str:
    """Where the dry run writes (read at call time, so a caller may move
    it through the environment)."""
    return os.environ.get(
        "REPRO_TORCH_ARTIFACT_DIR",
        os.path.join(os.path.dirname(__file__), "..", "..", "..", "build",
                     "dryrun"))


def _advice(rec: Dict) -> str:
    """One sentence: what would move the dominant term down on an H100."""
    a = rec["analysis"]
    m = rec["meta"]
    dom = a["dominant"]
    if dom == "compute_s":
        ratio = a.get("useful_flops_ratio", 0)
        if ratio < 0.5:
            return ("compute-bound with low useful ratio: skip masked "
                    "attention blocks (the causal schedule the flash "
                    "kernel already runs) and drop the remat recompute on "
                    "cheap ops")
        return ("compute-bound near the useful ceiling: larger per-step "
                "batch or FP8 tensor-core matmuls (wgmma) are the "
                "remaining levers")
    if dom == "memory_s":
        if m["kind"] == "decode":
            return ("decode is weight/cache-bandwidth bound: batch more "
                    "sequences per step, quantize the KV cache to FP8, or "
                    "shrink the replicated weight fraction")
        return ("memory-bound: fuse the optimizer update into one "
                "multi-tensor kernel, keep activations bf16 end to end, "
                "raise arithmetic intensity with larger microbatches")
    return ("collective-bound: overlap the FSDP gathers with compute on "
            "their own CUDA streams, move grad sync to the hierarchical "
            "threadcomm schedule (NVLink first, the network for 1/M of "
            "the bytes), shard less over the slow axis")


def load_records(mesh_name: str, root: Optional[str] = None) -> List[Dict]:
    out = []
    for f in sorted(glob.glob(os.path.join(root or artifact_dir(),
                                           mesh_name, "*.json"))):
        with open(f) as fh:
            d = json.load(fh)
        if "analysis" in d:
            out.append(d)
    out.sort(key=lambda r: (r["meta"]["arch"],
                            _SHAPE_ORDER.get(r["meta"]["shape"], 9)))
    return out


def roofline_table(mesh_name: str, grad_sync: str = "spmd",
                   root: Optional[str] = None) -> str:
    rows = [
        "| arch | shape | compute (s) | memory (s) | collective (s) | "
        "dominant | fits HBM | 6ND/counted | MFU@bound | next lever |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for rec in load_records(mesh_name, root):
        m, a = rec["meta"], rec["analysis"]
        if m.get("grad_sync", "spmd") != grad_sync \
                or m.get("shard_mode", "2d") != "2d":
            continue
        t = a["terms"]
        ratio = a.get("useful_flops_ratio", 0.0)
        mfu = a.get("mfu_at_bound", 0.0)
        rows.append(
            f"| {m['arch']} | {m['shape']} | {t['compute_s']:.4f} | "
            f"{t['memory_s']:.4f} | {t['collective_s']:.4f} | "
            f"{a['dominant'].replace('_s', '')} | "
            f"{'yes' if a['fits_hbm'] else 'NO'} | {ratio:.2f} | "
            f"{mfu:.2f} | {_advice(rec)} |")
    return "\n".join(rows)


def dryrun_summary(mesh_name: str, root: Optional[str] = None) -> str:
    recs = load_records(mesh_name, root)
    lines = [
        "| arch | shape | params | live GB/dev | coll ops (exec) | "
        "coll bytes/dev | trace s |",
        "|---|---|---|---|---|---|---|",
    ]
    for rec in recs:
        m, a = rec["meta"], rec["analysis"]
        if m.get("grad_sync", "spmd") != "spmd" \
                or m.get("shard_mode", "2d") != "2d":
            continue
        tot = a["collectives"]["total"]
        lines.append(
            f"| {m['arch']} | {m['shape']} | {m['params'] / 1e9:.1f}B | "
            f"{a['live_bytes_per_device'] / 1e9:.1f} | "
            f"{tot['executions']} | {tot['operand_bytes']:.3g} | "
            f"{rec['timings']['trace_s']:.1f} |")
    return "\n".join(lines)


def main(argv=None):
    for mesh in ("single_pod", "multi_pod"):
        print(f"\n## Roofline — {mesh}\n")
        print(roofline_table(mesh))
        print(f"\n## Dry-run — {mesh}\n")
        print(dryrun_summary(mesh))


if __name__ == "__main__":
    main()
