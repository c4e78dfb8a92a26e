"""Byte floors and useful FLOPs, reckoned from a cell's shapes alone.

Nothing here reads the program: not its launch byte counts, its route
models nor its count of the rows it ran.  A floor counts each input a step
needs read once and each output written once, whatever route the program
takes, so a share against it cannot pass 100 % unless the time leaves out
part of the work.
"""

from __future__ import annotations

_ITEMSIZE = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2}


def itemsize(dtype: str) -> int:
    return _ITEMSIZE[dtype]


# ---------------------------------------------------------------------------
# The PDE cells: N rows, M systems sharing one LHS
# ---------------------------------------------------------------------------

def cn_step_floor_bytes(n: int, m: int, dtype: str) -> float:
    """One CN step: the (N, M) field read once, the next one written once
    (the shared factor's (N,) vectors are left out: 3N words against 2NM)."""
    return 2.0 * n * m * itemsize(dtype)


def cn_adjoint_floor_bytes(n: int, m: int, dtype: str) -> float:
    """One solve and its adjoint: the rhs and the cotangent read once, the
    solution and the rhs's gradient written once (four (N, M) planes), the
    three (N,) diagonals read and their three gradients written."""
    return (4.0 * n * m + 6.0 * n) * itemsize(dtype)


# ---------------------------------------------------------------------------
# Mamba-2 (SSD): sizes under the published config.json's key names
# ---------------------------------------------------------------------------

def embed_rows(c: dict) -> int:
    """The embedding's and the head's rows: the vocabulary padded up to a
    multiple of ``pad_vocab_size_multiple``, as the published model pads
    it (50277 -> 50288)."""
    pad = c.get("pad_vocab_size_multiple", 1)
    return -(-c["vocab_size"] // pad) * pad


def mamba2_dims(c: dict) -> dict:
    di = c["expand"] * c["d_model"]
    return {"D": c["d_model"], "L": c["n_layer"], "V": embed_rows(c),
            "di": di, "H": di // c["headdim"], "P": c["headdim"],
            "N": c["d_state"], "W": c["d_conv"], "Q": c["chunk_size"]}


def mamba2_params(c: dict) -> dict:
    """Parameter counts: the layers (every leaf of a layer: projections,
    conv, the per-head scalars, the norms), the input embedding and the
    output head, and the final norm.

    Frozen copy of the count the port's spec tree gives
    (``src/repro_torch/models/model.py``'s ``param_specs`` for the ssm
    family and ``src/repro_torch/models/ssm.py``'s ``ssm_specs`` at commit
    3b55662), written out as arithmetic."""
    d = mamba2_dims(c)
    D, di, H, N, W = d["D"], d["di"], d["H"], d["N"], d["W"]
    layer = (D                       # pre-norm
             + 2 * D * di            # z and x projections
             + 2 * D * N             # B and C projections
             + D * H + 3 * H         # dt projection, dt bias, A_log, D
             + W * (di + 2 * N)      # depthwise causal conv
             + di                    # gated norm
             + di * D)               # out projection
    return {"layers": d["L"] * layer, "embed": d["V"] * D,
            "unembed": D * d["V"], "final_norm": D}


def mamba2_scan_flops(c: dict, batch: int, seq: int) -> float:
    """The SSD's forward FLOPs beyond its projections, one layer: C.B
    within each chunk, the chunk's weights applied to X, and the chunk
    states formed and read back.  Frozen copy of the scores, intra and
    states terms of ``_ssd_flops`` (``src/repro_torch/launch/
    analytic_cost.py`` at commit 3b55662); its projection and conv terms
    are counted by the parameters."""
    d = mamba2_dims(c)
    t = batch * seq
    scores = 2.0 * t * d["Q"] * d["N"]
    intra = 2.0 * t * d["Q"] * d["H"] * d["P"]
    states = 2.0 * t * d["N"] * d["H"] * d["P"] * 2
    return scores + intra + states


def mamba2_step_flops(c: dict, batch: int, seq: int, kind: str) -> float:
    """Useful FLOPs of one step: k x (the layers' parameters) x tokens,
    k x the output head x the rows whose logits the task needs (every
    token in training, the last of each sequence in a prefill), and the
    scan terms of every layer; k = 6 and the scan x 3 in training, 2 and
    x 1 in a prefill.  The input embedding is a lookup and adds none."""
    p = mamba2_params(c)
    t = batch * seq
    if kind == "train":
        k, scan_mult, head_rows = 6.0, 3.0, t
    elif kind == "prefill":
        k, scan_mult, head_rows = 2.0, 1.0, batch
    else:
        raise ValueError(kind)
    return (k * (p["layers"] + p["final_norm"]) * t
            + k * p["unembed"] * head_rows
            + scan_mult * mamba2_scan_flops(c, batch, seq) * c["n_layer"])


def mamba2_recur_floor_bytes(c: dict, batch: int, seq: int,
                             kind: str) -> float:
    """Bytes the SSD's inter-chunk scans of one step need: per layer, the
    chunk states read once and the running states written once, (N, M)
    each at N = seq / chunk and M = batch x heads x head_dim x d_state, and
    the per-chunk decay (N, batch x heads) read once; one scan a layer in a
    prefill, two in training (forward and adjoint).  States are fp32."""
    d = mamba2_dims(c)
    n = seq // d["Q"]
    m = batch * d["H"] * d["P"] * d["N"]
    size = itemsize(c.get("state_dtype", "float32"))
    scan = (2.0 * n * m + n * batch * d["H"]) * size
    scans = 2 if kind == "train" else 1
    return scans * scan * c["n_layer"]
