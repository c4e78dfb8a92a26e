"""repro_torch — the PyTorch / CUDA port of ``repro``.

The same interleaved batch banded solvers (one factored LHS shared by M
right-hand sides laid out as ``(N, M)``), in PyTorch, with the sweep that
the JAX package runs as Pallas TPU kernels written by hand in CUDA C++ for
Hopper (``repro_torch.kernels``).  The package imports torch and numpy and
nothing of ``repro``.  Entry points run on the CUDA device unless the
caller asks for ``device="cpu"``.

    from repro_torch.solver import BandedSystem, factorize, solve
"""
