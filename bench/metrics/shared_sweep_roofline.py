"""Kernel: the shared sweep's share of its roofline, in %: the
iteration's byte floor (rhs and cotangent read once, solution and rhs
gradient written once, the diagonals and their gradients) over the card's
memory rate, divided by the traced device ms an iteration of the shared
sweep kernels (forward and transposed).  Nothing when none ran."""


def read(run):
    if not run.trace or not run.card:
        return None
    ms = run.trace["hand_ms"].get("shared_sweep", 0.0)
    if not ms:
        return None
    floor_ms = run.floors["pde_bytes"] / run.card.hbm_bytes_s * 1e3
    return 100.0 * floor_ms / (ms / run.trace_steps)
