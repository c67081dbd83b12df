"""Distribution layer of the port: sharding rules over the hierarchical
device mesh as ``core.compat.P`` spec trees (``dist/sharding.py``), the
twin of ``src/repro/dist/``. On one card they are data: the rank-stacked
region reads the batch spec; the rest describe the layout the reference
would give each leaf.
"""

from repro_torch.dist.sharding import (batch_axes, batch_pspec,  # noqa: F401
                                       cache_pspecs, param_pspecs)
