"""One driver a kind of workload, named by the workload file's ``driver``.

Each module has a ``Cell(config, workload, seed, device, ref,
control=False)`` that sets the system up on construction (its weights or
data made from the seed, its shapes warmed up) and then offers:

  * ``step(i)`` — enqueue window step i, with no host sync;
  * ``close()`` — the window has ended: no more answers are kept;
  * ``units_per_step`` — the work a step completes (unknowns or tokens);
  * ``floors`` — byte floors and useful FLOPs a step, from the shapes;
  * ``check()`` — free the program's state, run the plain reference and
    return ``{name: number}`` for ``check.verdict``;
  * ``attempted``.

``control=True`` puts the reference, computed one precision below the
configuration's, in the program's place (the control that has to come
out not correct).
"""
