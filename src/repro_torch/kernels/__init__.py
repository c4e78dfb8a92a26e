"""Hand-written Hopper kernels of the port, their plain versions, and the
sweep descriptions that drive them (``engine``)."""
