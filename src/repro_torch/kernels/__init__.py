"""Hand-written Hopper kernels of the port, built at first use by
``_build``."""
