"""The static-analysis gate: run the ``repro_torch.analysis`` rule
families over the port (or explicit files) and fail on violations.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis             # whole port
    PYTHONPATH=src python -m repro_torch.analysis --fail-on warn \\
        --require trace-discipline --require host-dispatch \\
        --require lane-mask --require concurrency             # the gate
    PYTHONPATH=src python -m repro_torch.analysis \\
        tests/lint_corpus_torch/bad_hd002.py

Exit is nonzero when any of these hold:

* a finding at/above ``--fail-on`` severity survived the allowlist
  (default threshold: ``error``; the gate runs ``--fail-on warn``);
* the allowlist has a stale entry (suppresses nothing) — the list must
  stay exact, it can only shrink to fit the tree;
* a rule crashed — a rule that stops executing must fail the job, not
  silently stop finding things;
* a ``--require``d rule id or family did not execute (a skipped gate
  would otherwise pass vacuously).

Explicit file arguments run the AST rules on those files and the
recorder and lane rules on any entries the modules export (the
``LINT_TRACE_ENTRIES`` / ``LINT_LANE_ENTRY`` conventions — see
``repro_torch.analysis.driver``); this is how the negative corpus under
``tests/lint_corpus_torch/`` is executed.
"""
import argparse
import sys

from repro_torch.analysis import driver
from repro_torch.analysis.allowlist import load_allowlist


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="trace-discipline / host-dispatch / lane-mask / "
                    "concurrency lint of the PyTorch port")
    ap.add_argument("paths", nargs="*",
                    help="explicit files to lint (default: the whole port"
                         " + its real entry points)")
    ap.add_argument("--fail-on", choices=("warn", "error"),
                    default="error",
                    help="minimum severity that fails the run"
                         " (the gate uses warn)")
    ap.add_argument("--require", action="append", default=[],
                    metavar="RULE",
                    help="rule id (TD001) or family (lane-mask) that"
                         " must have executed — fail otherwise, so a"
                         " rule that stops running cannot pass"
                         " vacuously")
    ap.add_argument("--allowlist", default=driver.DEFAULT_ALLOWLIST,
                    metavar="PATH",
                    help="TOML allowlist (default: allowlist.toml beside"
                         " the package); 'none' disables")
    ap.add_argument("--list", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    rules = driver.all_rules()
    if args.list:
        for r in rules:
            print(f"{r.id}  {r.family:17s} {r.severity:5s} {r.doc}")
        return 0

    allow = [] if args.allowlist == "none" \
        else load_allowlist(args.allowlist)
    report = driver.run_lint(args.paths or None, allowlist=allow)

    failures = 0
    for f in sorted(report.findings, key=lambda f: (f.path, f.line)):
        print(f.render())
    failures += len(report.failures(args.fail_on))
    below = len(report.findings) - len(report.failures(args.fail_on))

    for f in report.stale_allowlist:
        print("FAIL:", f.render(), file=sys.stderr)
        failures += 1
    for rule_id, err in sorted(report.rule_errors.items()):
        print(f"FAIL: rule {rule_id} crashed ({err}) — a rule that "
              f"stops executing fails the gate", file=sys.stderr)
        failures += 1

    known = {r.id for r in rules} | {r.family for r in rules}
    ran = set(report.executed) | {r.family for r in rules
                                  if r.id in report.executed}
    for req in args.require:
        if req not in known:
            print(f"FAIL: --require {req}: unknown rule/family (catalog"
                  f" drifted? see --list)", file=sys.stderr)
            failures += 1
        elif req not in ran:
            print(f"FAIL: required rule/family {req} did not execute "
                  f"(no entries/files, or it crashed) — its gate would "
                  f"pass vacuously", file=sys.stderr)
            failures += 1

    n = len(report.findings)
    print(f"# lint: {n} finding(s), {len(report.suppressed)} "
          f"allowlisted, {len(report.executed)} rule(s) executed"
          + (f", {below} below --fail-on {args.fail_on}" if below else ""),
          file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
