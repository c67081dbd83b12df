"""Device kernels in the profiled slice (``torch.profiler``, device
events, copies left out) over the engine steps in it (layer
``serve/engine.py``)."""

from bench.readers import kernels_per_step as read  # noqa: F401
