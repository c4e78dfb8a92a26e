#!/usr/bin/env python3
"""How far fp32 rounding alone moves the encdec and vlm serving cases'
log-probs, on the card and on the CPU, over several draws.

    python3 tools/parity_draws.py [--draws 4] [--cases v w]

Run from the root of a checkout on a machine with one CUDA device (it
fails without one).  For ``chip_smoke.py``'s cases (v) seamless-m4t-large-v2
and (w) llama-3.2-vision-90b, at the full width and the depth of their
card-vs-CPU check (2 + 2 layers, one group of 5), with the weights of that
check (seed, cross gates) drawn by JAX's init rule and then with the
attention softened (``chip_smoke._soften_attention``): ``--draws`` batches
of 2 sequences, drawn as the check draws its one batch (the first is the
check's), each prefilled on the card and on the CPU at fp32 and at fp64.
Prints one JSON line a case and weight rule with the per-sequence max|Δ|
of the last token's log-probs: card fp32 vs CPU fp32 (``gap32``), card
fp64 vs CPU fp64 (``gap64``), and each side's fp32 from its own fp64.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--draws", type=int, default=4)
    parser.add_argument("--cases", nargs="+", default=["v", "w"])
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("parity_draws: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import Model, build_model
    from repro_torch.models.params import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)

    def logprobs(model, batches, device):
        return [torch.log_softmax(model.prefill(
            {k: v.to(device) for k, v in b.items()})[0].double(), -1).cpu()
            for b in batches]

    def to_fp64(model):
        with torch.no_grad():
            for p in model.params.parameters():
                p.data = p.data.double()

    for key in args.cases:
        case = cs.CROSS_CASES[key]
        cfg = dataclasses.replace(
            cs._with_depth(get_config(case["arch"]), case["parity_layers"]),
            dtype="float32")
        gen = torch.Generator().manual_seed(cs.SEED + 5)
        batches = []
        for _ in range(args.draws):
            toks = torch.randint(0, cfg.vocab,
                                 (cs.DENSE_PARITY_BATCH, case["parity_seq"]),
                                 generator=gen)
            batches.append({"tokens": toks, **cs._frontend(
                cfg, cs.DENSE_PARITY_BATCH, "cpu", gen)})
        for soft in (False, True):
            t0 = time.perf_counter()
            card = build_model(cfg, device="cuda", seed=cs.SEED + 5)
            if case["gates"] is not None:
                cs._set_gates(card, case["gates"])
            if soft:
                cs._soften_attention(card)
            cpu = Model(cfg, device="cpu", params=tree_map(
                lambda t: t.cpu(), card.params.tree()))
            lp = {"card32": logprobs(card, batches, "cuda")}
            to_fp64(card)
            lp["card64"] = logprobs(card, batches, "cuda")
            del card
            cs._free_device()
            lp["cpu32"] = logprobs(cpu, batches, "cpu")
            to_fp64(cpu)
            lp["cpu64"] = logprobs(cpu, batches, "cpu")
            del cpu

            def dist(a, b):
                return [v for x, y in zip(lp[a], lp[b])
                        for v in (x - y).abs().amax(-1).tolist()]
            print(json.dumps({
                "case": key, "arch": case["arch"], "soft_attention": soft,
                "layers": case["parity_layers"],
                "shape": [cs.DENSE_PARITY_BATCH, case["parity_seq"]],
                "draws": args.draws,
                "gap32": dist("card32", "cpu32"),
                "gap64": dist("card64", "cpu64"),
                "card32_from_fp64": dist("card32", "card64"),
                "cpu32_from_fp64": dist("cpu32", "cpu64"),
                "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
