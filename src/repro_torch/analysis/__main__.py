"""CLI: ``python -m repro_torch.analysis`` — verify the port's registry.

Exit code 0 = clean, 1 = findings.  Modes:

  (default)     run speccheck
  --nan-sweep   run the registry-driven sweep of every kernel route on
                ``--device`` (default ``cuda``: the kernels with NaN-filled
                outputs, which raises without a card; ``cpu``: the plain
                versions under the non-finite guard)
  --all         both
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Verification of the port's sweep registry: pass-table "
                    "invariants and accounting, and a NaN / write-coverage "
                    "sweep of every kernel route.")
    parser.add_argument("--nan-sweep", action="store_true",
                        help="registry-driven ragged/dead-lane/aligned sweep "
                             "of every route")
    parser.add_argument("--all", action="store_true",
                        help="checkers + nan-sweep")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the nan-sweep runs (default: cuda)")
    parser.add_argument("-q", "--quiet", action="store_true",
                        help="suppress per-checker progress lines")
    args = parser.parse_args(argv)

    from repro_torch.kernels.engine import REGISTRY

    from . import run_all
    verbose = not args.quiet
    failed = False

    if args.all or not args.nan_sweep:
        findings = run_all(verbose=verbose)
        for f in findings:
            print(f, file=sys.stderr)
        failed = bool(findings)
        if verbose and not findings:
            print(f"speccheck clean: {len(REGISTRY)} registered specs, "
                  f"0 findings")

    if args.nan_sweep or args.all:
        from . import nansweep
        findings = nansweep.run(args.device)
        for f in findings:
            print(f, file=sys.stderr)
        failed = failed or bool(findings)
        if verbose and not findings:
            print(f"nan-sweep clean on {args.device}: "
                  f"{len(nansweep.kinds())} specs and steps on every route x "
                  f"{len(nansweep.CASES)} shape classes")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
