"""The benchmark's own code: everything the yardstick is made of.

``manifest`` finds configurations, workloads and metric readers by the
names ``BENCHMARK.json`` gives them; ``window`` runs the measured window;
``trace`` reads a profiler trace (a frozen copy of the port's reader);
``cards`` and ``floors`` hold the peaks and the byte and FLOP arithmetic;
``kinds`` holds one driver per kind of workload; ``cell`` ties them into
one run.  Nothing here imports the JAX package or JAX; the plain
references beside the configurations import nothing of the port.
"""
