"""Kernel: the fused CN step's share of its roofline, in %: the step's
byte floor (the field read once and written once) over the card's
memory rate, divided by the traced device ms a step of the fused
kernels (``fused_cn_tridiag``, and the partitioned route's ``fused_cn``
stages).  Nothing when no fused kernel ran."""


def read(run):
    if not run.trace or not run.card:
        return None
    ms = sum(run.trace["hand_ms"].get(k, 0.0)
             for k in ("fused_cn_tridiag", "fused_cn"))
    if not ms:
        return None
    floor_ms = run.floors["pde_bytes"] / run.card.hbm_bytes_s * 1e3
    return 100.0 * floor_ms / (ms / run.trace_steps)
