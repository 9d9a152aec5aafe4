"""The lint runner: rule registry, target discovery, execution tracking (the
JAX package's ``analysis/driver.py`` for the port).

Two modes:

* **tree mode** (no explicit paths): scan every module under
  ``src/repro_torch/`` (eager PyTorch has no trace layer to leave out;
  the repository's ``chip_smoke.py`` and the gate's own package are not
  scanned: their timing syncs and recorded trip probes are their job)
  AND run the recorder-based and lane rules against the port's real
  entry points (``trace_rules.default_*_entries``,
  ``lane_rules.default_lane_entries``).
* **paths mode** (explicit files, e.g. the negative corpus under
  ``tests/lint_corpus_torch/``): AST rules run on those files; the
  recorder and lane rules run on the entries the modules export by these
  conventions, every tensor a torch tensor:
  ``LINT_TRACE_ENTRIES = [{"name", "build"}, ...]`` (``build() -> (fn,
  args, kwargs)``), ``LINT_STATIC_KEY_ENTRIES = [{"name", "static_of",
  "spec_a", "spec_b", "traced_fields"?, "run"?}, ...]``,
  ``LINT_LOAD_ENTRIES = [{"name", "build"}, ...]`` (``build() ->
  (buffers, run)``) and ``LINT_LANE_ENTRY = {"body", "st0",
  "boundary_fields", "boundary"?, "active_key"?, "trace_key"?}``.

Execution is tracked fail-closed: a rule that raises records a rule error
(the run fails regardless of findings), and a rule whose family had no
entries/files to act on is *not* counted as executed, so ``--require``
can detect a gate that went vacuous.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis import concurrency_rules, host_rules, lane_rules, \
    trace_rules
from repro_torch.analysis.allowlist import AllowEntry, apply_allowlist
from repro_torch.analysis.findings import Finding, RuleSpec, Severity

# the host surfaces the AST rules scan in tree mode (repo-relative)
DEFAULT_SCAN = ("src/repro_torch",)
EXCLUDE_DIRS = {"__pycache__", "csrc"}
# the gate's own package: its recorded probes of a trip are its job
EXCLUDE_PATHS = {"src/repro_torch/analysis"}
DEFAULT_ALLOWLIST = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "allowlist.toml")


@dataclasses.dataclass
class Context:
    files: List[Tuple[str, str]]          # (abs, rel)
    trace_entries: List[trace_rules.TraceEntry]
    static_key_entries: List[trace_rules.StaticKeyEntry]
    load_entries: List[trace_rules.LoadEntry]
    lane_entries: List[lane_rules.LaneEntry]


@dataclasses.dataclass
class Report:
    findings: List[Finding]               # post-allowlist
    suppressed: List[Finding]
    stale_allowlist: List[Finding]
    rule_errors: Dict[str, str]
    executed: List[str]                   # rule ids that actually ran

    def failures(self, fail_on: str) -> List[Finding]:
        keep = Severity.ORDER[fail_on]
        return [f for f in self.findings
                if Severity.ORDER[f.severity] >= keep]


def all_rules() -> List[RuleSpec]:
    return [
        RuleSpec("TD001", trace_rules.FAMILY, Severity.ERROR,
                 "no float64/complex128 op in the recorded entry points",
                 trace_rules.rule_td001),
        RuleSpec("TD002", trace_rules.FAMILY, Severity.ERROR,
                 "same ops and dtypes under a float64 default dtype",
                 trace_rules.rule_td002),
        RuleSpec("TD003", trace_rules.FAMILY, Severity.ERROR,
                 "capture key and trip scalars are structure-only",
                 trace_rules.rule_td003),
        RuleSpec("TD004", trace_rules.FAMILY, Severity.ERROR,
                 "every buffer the engine's load fills is read",
                 trace_rules.rule_td004),
        RuleSpec("HD001", host_rules.FAMILY, Severity.WARN,
                 "no host-to-device copy inside a host loop",
                 host_rules.rule_hd001),
        RuleSpec("HD002", host_rules.FAMILY, Severity.WARN,
                 "no host-device synchronization in host code",
                 host_rules.rule_hd002),
        RuleSpec("HD003", host_rules.FAMILY, Severity.WARN,
                 "no per-call CUDA graph / torch.compile (memoize)",
                 host_rules.rule_hd003),
        RuleSpec("HD004", host_rules.FAMILY, Severity.WARN,
                 "no host calls into the engine's per-trip methods",
                 host_rules.rule_hd004),
        RuleSpec("LM001", lane_rules.FAMILY, Severity.ERROR,
                 "every lane-carry write is active-gated",
                 lane_rules.rule_lm001),
        RuleSpec("LM002", lane_rules.FAMILY, Severity.ERROR,
                 "the boundary touches only BOUNDARY_FIELDS + traces",
                 lane_rules.rule_lm002),
        RuleSpec("CC001", concurrency_rules.FAMILY, Severity.ERROR,
                 "multi-context serving mutations carry GUARDED_BY",
                 concurrency_rules.rule_cc001),
        RuleSpec("CC002", concurrency_rules.FAMILY, Severity.ERROR,
                 "GUARDED_BY lock map is exact (no stale entries)",
                 concurrency_rules.rule_cc002),
        RuleSpec("CC003", concurrency_rules.FAMILY, Severity.ERROR,
                 "every GUARDED_BY entry names a real lock held at "
                 "each mutation",
                 concurrency_rules.rule_cc003),
    ]


def _discover_files(repo_root: str) -> List[Tuple[str, str]]:
    out: List[Tuple[str, str]] = []
    for target in DEFAULT_SCAN:
        abs_t = os.path.join(repo_root, target)
        for dirpath, dirnames, filenames in os.walk(abs_t):
            rel_dir = os.path.relpath(dirpath, repo_root) \
                .replace(os.sep, "/")
            dirnames[:] = sorted(
                d for d in dirnames if d not in EXCLUDE_DIRS
                and f"{rel_dir}/{d}" not in EXCLUDE_PATHS)
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    ap = os.path.join(dirpath, fn)
                    out.append((ap, os.path.relpath(ap, repo_root)
                                .replace(os.sep, "/")))
    return out


def _load_module(path: str):
    name = "_lint_target_" + os.path.basename(path).replace(".py", "")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.modules.pop(name, None)
    return mod


def _entries_from_paths(paths: Sequence[str]):
    trace_e, static_e, load_e, lane_e = [], [], [], []
    for p in paths:
        mod = _load_module(p)
        for raw in getattr(mod, "LINT_TRACE_ENTRIES", []):
            trace_e.append(trace_rules.TraceEntry(name=raw["name"],
                                                  build=raw["build"]))
        for raw in getattr(mod, "LINT_STATIC_KEY_ENTRIES", []):
            static_e.append(trace_rules.StaticKeyEntry(
                name=raw["name"], static_of=raw["static_of"],
                spec_a=raw["spec_a"], spec_b=raw["spec_b"],
                traced_fields=tuple(raw.get("traced_fields", ())),
                run=raw.get("run")))
        for raw in getattr(mod, "LINT_LOAD_ENTRIES", []):
            load_e.append(trace_rules.LoadEntry(name=raw["name"],
                                                build=raw["build"]))
        raw = getattr(mod, "LINT_LANE_ENTRY", None)
        if raw:
            lane_e.append(lane_rules.LaneEntry(
                name=raw.get("name", os.path.basename(p)),
                body=raw["body"], st0=raw["st0"],
                boundary_fields=tuple(raw["boundary_fields"])))
    return trace_e, static_e, load_e, lane_e


def repo_root() -> str:
    # src/repro_torch/analysis/driver.py -> the root is three dirs above src
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def build_context(paths: Optional[Sequence[str]] = None,
                  root: Optional[str] = None) -> Context:
    root = root or repo_root()
    if paths:
        files = [(os.path.abspath(p),
                  os.path.relpath(os.path.abspath(p), root)
                  .replace(os.sep, "/")) for p in paths]
        trace_e, static_e, load_e, lane_e = _entries_from_paths(
            [a for a, _ in files])
    else:
        files = _discover_files(root)
        trace_e = trace_rules.default_trace_entries()
        static_e = trace_rules.default_static_key_entries()
        load_e = trace_rules.default_load_entries()
        lane_e = lane_rules.default_lane_entries()
    return Context(files=files, trace_entries=trace_e,
                   static_key_entries=static_e, load_entries=load_e,
                   lane_entries=lane_e)


def _has_work(rule: RuleSpec, ctx: Context) -> bool:
    if rule.id == "TD003":
        return bool(ctx.static_key_entries)
    if rule.id == "TD004":
        return bool(ctx.load_entries)
    if rule.family == trace_rules.FAMILY:
        return bool(ctx.trace_entries)
    if rule.family == lane_rules.FAMILY:
        return bool(ctx.lane_entries)
    return bool(ctx.files)


def run_lint(paths: Optional[Sequence[str]] = None, *,
             allowlist: Optional[List[AllowEntry]] = None,
             root: Optional[str] = None,
             rules: Optional[Sequence[RuleSpec]] = None) -> Report:
    ctx = build_context(paths, root)
    allowlist = allowlist or []
    findings: List[Finding] = []
    rule_errors: Dict[str, str] = {}
    executed: List[str] = []
    for rule in rules or all_rules():
        if not _has_work(rule, ctx):
            continue
        try:
            findings.extend(rule.fn(ctx))
            executed.append(rule.id)
        except Exception as e:  # fail closed: a crashed rule fails the run
            rule_errors[rule.id] = f"{type(e).__name__}: {e}"
    kept, suppressed = apply_allowlist(findings, allowlist)
    stale = [Finding(
        "ALLOW", "allowlist", Severity.ERROR, e.path, 0,
        e.symbol or "*",
        f"stale allowlist entry for {e.rule} (suppresses nothing); "
        f"remove it — reason was: {e.reason}")
        for e in allowlist if e.hits == 0]
    return Report(findings=kept, suppressed=suppressed,
                  stale_allowlist=stale, rule_errors=rule_errors,
                  executed=executed)
