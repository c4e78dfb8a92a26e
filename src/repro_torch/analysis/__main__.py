"""CLI: ``python -m repro_torch.analysis`` — verify the port's sweep layer.

Exit code 0 = clean, 1 = findings (or a missed mutation).  Modes:

  (default)     run speccheck + gridcheck + tracecheck (with the lint)
  --self-test   run the mutation self-test (each seeded defect class must
                be caught by its checker; on the CPU)
  --nan-sweep   run the registry-driven sweep of every kernel route
  --all         everything above

``--device`` (default ``cuda``, which raises without a card) is where the
checkers run: on the card the kernels, gridcheck against the CUDA sources'
span exports and tracecheck under the sync debug mode too; ``cpu`` the
plain versions.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Verification of the port's sweep layer: pass-table "
                    "invariants and the traffic recount, every route's row "
                    "spans, the host-sync contract, a mutation self-test "
                    "and a NaN / write-coverage sweep of every kernel "
                    "route.")
    parser.add_argument("--self-test", action="store_true",
                        help="mutation self-test: seed known defect classes "
                             "and require the checkers to catch each")
    parser.add_argument("--nan-sweep", action="store_true",
                        help="registry-driven ragged/dead-lane/aligned sweep "
                             "of every route")
    parser.add_argument("--all", action="store_true",
                        help="checkers + self-test + nan-sweep")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the checkers and the nan-sweep run "
                             "(default: cuda)")
    parser.add_argument("-q", "--quiet", action="store_true",
                        help="suppress per-checker progress lines")
    args = parser.parse_args(argv)

    from repro_torch.kernels.engine import REGISTRY

    from . import run_all
    verbose = not args.quiet
    failed = False
    run_checkers = args.all or not (args.self_test or args.nan_sweep)

    if run_checkers:
        findings = run_all(verbose=verbose, device=args.device)
        for f in findings:
            print(f, file=sys.stderr)
        failed = bool(findings)
        if verbose and not findings:
            print(f"speclint clean on {args.device}: {len(REGISTRY)} "
                  f"registered specs, 0 findings")

    if args.self_test or args.all:
        from . import mutation
        if verbose:
            print("mutation self-test:")
        results = mutation.self_test(verbose=verbose)
        missed = [r.name for r in results if not r.detected]
        if missed:
            print(f"mutation self-test MISSED: {', '.join(missed)}",
                  file=sys.stderr)
            failed = True
        elif verbose:
            print(f"mutation self-test: {len(results)}/{len(results)} "
                  f"defect classes caught")

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
