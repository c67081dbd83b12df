"""The reference's examples (``examples/*.py``), ported: each a module
with ``main(argv=None)`` and ``--device`` (the card unless the caller
asks for the CPU), runnable as ``python -m repro_torch.examples.<name>``.

The reference's fake host devices (``XLA_FLAGS``) become the port's
rank-stacked threadcomm on one device. Each ``main`` prints the
reference's checks and returns them with the launch counters of the
kernels it drove (:func:`kernel_counts`, zeroed at its start).
"""

from __future__ import annotations

from typing import Dict


def serving_config(device):
    """gemma-2b for the serving examples: the reference's smoke config on
    the CPU, the published widths on the card (its paged and flash
    kernels are built for head dims 64/128/256; the smoke config's is
    32)."""
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    full = torch.device(device).type == "cuda"
    return (get_config if full else get_smoke_config)("gemma-2b")


def reset_counts() -> None:
    """Zero every kernel's launch and plain-call counter."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.msgq import ops as msgq_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    for mod in (flash_ops, msgq_ops, paged_ops, ssd_ops):
        mod.reset_counters()


def kernel_counts() -> Dict[str, int]:
    """Launches of each ported kernel and the plain versions' calls (the
    CPU path, or a comparison on the card) since :func:`reset_counts`."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.msgq import ops as msgq_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return {"msgq_eager": msgq_ops.eager_launches,
            "msgq_one_copy": msgq_ops.one_copy_launches,
            "paged_decode": paged_ops.decode_launches,
            "paged_mq": paged_ops.mq_launches,
            "flash_attention": flash_ops.flash_launches,
            "ssd_scan": ssd_ops.ssd_launches,
            "plain_calls": (msgq_ops.ref_calls + paged_ops.ref_calls
                            + flash_ops.ref_calls + ssd_ops.ref_calls)}


def report(name: str, checks: Dict) -> Dict:
    """Print and return ``{"checks", "kernels", "ok"}`` of an example."""
    out = {"checks": checks, "kernels": kernel_counts(),
           "ok": all(bool(v) for v in checks.values())}
    print(f"{name}: kernels {out['kernels']}; checks "
          f"{'OK' if out['ok'] else 'FAILED'}")
    return out
