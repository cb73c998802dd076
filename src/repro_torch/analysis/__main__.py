"""Run the port's static analyzers and gate on NEW findings.

    PYTHONPATH=src python -m repro_torch.analysis --check
    PYTHONPATH=src python -m repro_torch.analysis --write-baseline
    PYTHONPATH=src python -m repro_torch.analysis --paths FILE ...

Mirrors ``scripts/repro_lint.py``. The scope is derived, not listed:
``imports.default_scope()``, every module reachable from the SVM roots
(the LM zoo is left out until something there imports it), and the CUDA
sources under ``kernels/csrc``.

Passes:

* ``jit_lint``     — host syncs and timers over the whole scope
* ``kernel_lint``  — the wrappers, grids, shared memory and accumulators
                     (and TF32, over every module of the scope)
* plan smoke       — a small grid-shaped plan through ``analyze_plan`` on
                     the CPU (catches analyzer / study API drift)

The committed baseline (``results/lint_baseline_torch.json``) holds the
findings that are there by design, each with its justification;
``--check`` exits non-zero only on findings NOT in it. Refresh it with
``--write-baseline`` after a change that moves a baselined finding to
another function (justifications carry over by (rule, path, symbol)), and
give a new entry its reason by hand.
"""
import argparse
import json
import pathlib
import sys

from repro_torch.analysis import findings, imports, jit_lint, kernel_lint

REPO = imports.src_root().parent
DEFAULT_BASELINE = REPO / "results" / "lint_baseline_torch.json"


def plan_smoke(report: findings.Report) -> None:
    """Analyze a small grid-shaped plan (2 sources x 2 chained lanes) on
    the CPU. Any finding, or an exception, is a lint failure: the plan is
    well-formed by construction, so noise here means the analyzer or the
    study API drifted."""
    import numpy as np
    import torch

    from repro_torch.analysis.plan_check import analyze_plan
    from repro_torch.core.study import Plan
    from repro_torch.svm.sources import KernelSpec

    X = torch.as_tensor(np.random.default_rng(0).normal(size=(16, 4)))
    y = torch.as_tensor(np.where(np.arange(16) % 2, 1.0, -1.0))
    zeros = torch.zeros(16, dtype=torch.float64)
    plan = Plan(sources={g: KernelSpec(X=X, gamma=0.5 * (g + 1), kind="rbf")
                         for g in range(2)}, y=y, device="cpu")
    for g in range(2):
        plan.lane((g, 0), source=g, train_mask=y != 0, C=1.0,
                  alpha0=zeros, f0=-y)
        plan.lane((g, 1), source=g, train_mask=y != 0, C=1.0,
                  alpha0=zeros, f0=-y, after=(g, 0))
        plan.evaluate((g, 0), torch.arange(4))
        plan.evaluate((g, 1), torch.arange(4))
    try:
        pa = analyze_plan(plan)
    except Exception as e:  # noqa: BLE001 — the smoke must not crash the lint
        report.add("plan-smoke", "<plan:smoke>", "analyze_plan",
                   f"analyzer raised on a well-formed plan: {e!r}")
        return
    report.extend(pa.report)
    if pa.program_count < 1:
        report.add("plan-smoke", "<plan:smoke>", "analyze_plan",
                   "no programs enumerated for a plan with solved lanes")


def run(paths=None) -> findings.Report:
    """Every pass over ``paths`` (default: the derived scope, the CUDA
    sources and the plan smoke)."""
    if paths:
        scope = [pathlib.Path(p) for p in paths]
    else:
        scope = imports.default_scope() + kernel_lint.kernel_sources()
    report = findings.Report()
    report.extend(jit_lint.lint_paths(
        [p for p in scope if p.suffix == ".py"], repo_root=REPO))
    report.extend(kernel_lint.lint_paths(scope, repo_root=REPO))
    if not paths:
        plan_smoke(report)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="exit 1 when findings not in the baseline exist")
    ap.add_argument("--json", metavar="PATH",
                    help="write the full findings report as JSON")
    ap.add_argument("--baseline", default=str(DEFAULT_BASELINE),
                    help="baseline file (default "
                         "results/lint_baseline_torch.json)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept the current findings as the new baseline "
                         "(carries forward existing justifications)")
    ap.add_argument("--paths", nargs="*",
                    help="lint exactly these files instead of the derived "
                         "scope (skips the plan smoke)")
    args = ap.parse_args(argv)

    report = run(args.paths)
    baseline = findings.load_baseline(args.baseline)

    if args.json:
        payload = report.to_json()
        payload["scaffolding"] = imports.scaffolding_inventory()
        pathlib.Path(args.json).write_text(
            json.dumps(payload, indent=2) + "\n")
    if args.write_baseline:
        findings.write_baseline(report, args.baseline, previous=baseline)
        print(f"baseline written: {args.baseline} "
              f"({len(report)} findings)")
        return 0

    new = report.new_against(baseline)
    accepted = len(report) - len(new)
    print(report.render())
    print(f"-- {len(report)} findings "
          f"({accepted} baselined, {len(new)} new)")
    if args.check and new:
        print("NEW findings (fix, or --write-baseline with justification):")
        for f in new:
            print("  " + f.render())
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
