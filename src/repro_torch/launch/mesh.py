"""Production mesh construction: the port of ``src/repro/launch/mesh.py``
on ``core.compat.make_mesh`` (every rank on one device: the card unless
the caller asks for the CPU).

Functions, not module-level constants: importing this module touches no
device.
"""

from __future__ import annotations

from repro_torch.config import MULTI_POD, SINGLE_POD, MeshConfig
from repro_torch.core.compat import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """The production mesh: (16, 16) over ``("data", "model")``, or
    (2, 16, 16) over ``("pod", "data", "model")``."""
    return make_mesh_from_config(production_mesh_config(multi_pod=multi_pod),
                                 device)


def production_mesh_config(*, multi_pod: bool = False) -> MeshConfig:
    return MULTI_POD if multi_pod else SINGLE_POD


def make_mesh_from_config(mesh_cfg: MeshConfig, device="cuda") -> Mesh:
    return make_mesh(mesh_cfg.shape, mesh_cfg.axis_names, device=device)
