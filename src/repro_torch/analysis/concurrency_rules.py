"""Concurrency-discipline rules (CC*) for ``repro_torch/serving``, the
JAX package's ``analysis/concurrency_rules.py`` copied: pure AST, no
framework.

The serving layer runs under real threads (serving/transport.py drives
the engine and the queue from ingestion/dispatch/worker contexts), so
the ``GUARDED_BY`` maps are no longer documentation — they name live
locks. The contract, one rule per failure mode:

* CC001 — an instance attribute mutated from **more than one** method
  of a serving class must be declared in that class's ``GUARDED_BY``
  class attribute (a ``{attr: "lock: note"}`` dict literal).
* CC002 — a ``GUARDED_BY`` entry for an attribute that is *not*
  multi-context-mutated is stale and fails (the map must shrink with
  the code, mirroring the allowlist's exactness policy).
* CC003 — every (non-stale) ``GUARDED_BY`` entry must correspond to a
  **real acquired lock**: the entry value starts with the lock's
  attribute name (``"_lock: ..."``), a constructor must assign that
  attribute from ``threading.Lock/RLock/Condition/Semaphore``, and
  every mutation of the guarded attribute outside construction must sit
  lexically inside ``with self.<lock>:``. Declared-but-unlocked state
  — the gap CC001/CC002 left open while the transport was future work
  — now fails the gate.

Mutation = assignment/augmented assignment to ``self.X`` (including
``self.X[...] = ...``) or a mutating method call on it
(``self.X.append(...)``, ``.popleft()``, ...). ``__init__`` and
``__post_init__`` are construction, not a call context.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from repro_torch.analysis.findings import Finding, Severity

FAMILY = "concurrency"

MUTATORS = {"append", "appendleft", "add", "remove", "discard", "pop",
            "popleft", "clear", "extend", "insert", "update",
            "setdefault", "sort", "reverse"}
CONSTRUCTORS = {"__init__", "__post_init__", "__new__"}
LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore",
                  "BoundedSemaphore"}


def _self_attr(node: ast.expr) -> str | None:
    """``self.X`` / ``self.X[...]`` -> ``X``."""
    if isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _method_mutations(method: ast.FunctionDef) -> Set[str]:
    muts: Set[str] = set()
    for node in ast.walk(method):
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                attr = _self_attr(t)
                if attr:
                    muts.add(attr)
        elif isinstance(node, ast.Call) and node.func and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in MUTATORS:
            attr = _self_attr(node.func.value)
            if attr:
                muts.add(attr)
    return muts


def _guarded_by(cls: ast.ClassDef) -> Dict[str, Tuple[int, str]]:
    """attr -> (lineno, note) of its GUARDED_BY entry."""
    out: Dict[str, Tuple[int, str]] = {}
    for node in cls.body:
        if isinstance(node, ast.Assign) \
                and any(isinstance(t, ast.Name) and t.id == "GUARDED_BY"
                        for t in node.targets) \
                and isinstance(node.value, ast.Dict):
            for key, val in zip(node.value.keys, node.value.values):
                if isinstance(key, ast.Constant) \
                        and isinstance(key.value, str):
                    note = val.value if (isinstance(val, ast.Constant)
                                         and isinstance(val.value, str)) \
                        else ""
                    out[key.value] = (node.lineno, note)
    return out


def _lock_of(note: str) -> str | None:
    """``"_lock: step() ..."`` -> ``"_lock"``; None when the note does
    not lead with a lock attribute name."""
    head = note.split(":", 1)[0].strip()
    return head if head.isidentifier() else None


def _ctor_locks(cls: ast.ClassDef) -> Set[str]:
    """self attrs a constructor assigns from a threading lock factory."""
    out: Set[str] = set()
    for node in cls.body:
        if not (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node.name in CONSTRUCTORS):
            continue
        for stmt in ast.walk(node):
            if not isinstance(stmt, ast.Assign):
                continue
            if not isinstance(stmt.value, ast.Call):
                continue
            fn = stmt.value.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                fn.id if isinstance(fn, ast.Name) else None
            if name not in LOCK_FACTORIES:
                continue
            for t in stmt.targets:
                attr = _self_attr(t)
                if attr:
                    out.add(attr)
    return out


def _mutation_sites(method: ast.FunctionDef) \
        -> List[Tuple[str, int, Set[str]]]:
    """Every ``self.X`` mutation in ``method`` as (attr, lineno, held):
    ``held`` is the set of ``self.<attr>`` context managers lexically
    enclosing the site (``with self._lock: ...``)."""
    sites: List[Tuple[str, int, Set[str]]] = []

    def visit(node: ast.AST, held: Set[str]) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = set(held)
            for item in node.items:
                attr = _self_attr(item.context_expr)
                if attr:
                    inner.add(attr)
            for child in node.body:
                visit(child, inner)
            return
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                attr = _self_attr(t)
                if attr:
                    sites.append((attr, node.lineno, set(held)))
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in MUTATORS:
            attr = _self_attr(node.func.value)
            if attr:
                sites.append((attr, node.lineno, set(held)))
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    for stmt in method.body:
        visit(stmt, set())
    return sites


def scan_source(rel_path: str, source: str) -> List[Finding]:
    tree = ast.parse(source, filename=rel_path)
    findings: List[Finding] = []
    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        by_attr: Dict[str, Set[str]] = {}
        for node in cls.body:
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if node.name in CONSTRUCTORS:
                continue
            for attr in _method_mutations(node):
                by_attr.setdefault(attr, set()).add(node.name)
        guarded = _guarded_by(cls)
        shared = {a for a, ms in by_attr.items() if len(ms) >= 2}
        for attr in sorted(shared - set(guarded)):
            findings.append(Finding(
                "CC001", FAMILY, Severity.ERROR, rel_path, cls.lineno,
                f"{cls.name}.{attr}",
                f"attribute mutated from multiple call contexts "
                f"({', '.join(sorted(by_attr[attr]))}) without a "
                f"GUARDED_BY entry — declare the lock covering it"))
        for attr in sorted(set(guarded) - shared):
            findings.append(Finding(
                "CC002", FAMILY, Severity.ERROR, rel_path,
                guarded[attr][0], f"{cls.name}.{attr}",
                f"stale GUARDED_BY entry: attribute is not mutated "
                f"from multiple call contexts (mutators: "
                f"{sorted(by_attr.get(attr, set())) or 'none'}) — "
                f"drop it so the lock map stays exact"))
        # CC003: non-stale entries must name a real, held lock (stale
        # entries are CC002's finding — checking them here would double-
        # report one defect under two rules)
        ctor_locks = _ctor_locks(cls)
        for attr in sorted(shared & set(guarded)):
            lineno, note = guarded[attr]
            lock = _lock_of(note)
            if lock is None:
                findings.append(Finding(
                    "CC003", FAMILY, Severity.ERROR, rel_path, lineno,
                    f"{cls.name}.{attr}",
                    f"GUARDED_BY entry names no lock (note "
                    f"{note!r}) — lead the note with the lock "
                    f"attribute, e.g. \"_lock: ...\""))
                continue
            if lock not in ctor_locks:
                findings.append(Finding(
                    "CC003", FAMILY, Severity.ERROR, rel_path, lineno,
                    f"{cls.name}.{attr}",
                    f"GUARDED_BY names self.{lock} but no constructor "
                    f"assigns it from threading.Lock/RLock/Condition/"
                    f"Semaphore — the declared lock does not exist"))
                continue
            for node in cls.body:
                if not isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                if node.name in CONSTRUCTORS:
                    continue
                for m_attr, m_line, held in _mutation_sites(node):
                    if m_attr == attr and lock not in held:
                        findings.append(Finding(
                            "CC003", FAMILY, Severity.ERROR, rel_path,
                            m_line, f"{cls.name}.{attr}",
                            f"mutation in {node.name}() outside "
                            f"`with self.{lock}:` — guarded state "
                            f"touched without its declared lock"))
    return findings


def rule_cc(ctx) -> List[Finding]:
    out: List[Finding] = []
    for abs_path, rel_path in ctx.files:
        if "/serving/" not in rel_path.replace("\\", "/") \
                and not rel_path.startswith("tests/lint_corpus_torch"):
            continue
        with open(abs_path, encoding="utf-8") as f:
            out.extend(scan_source(rel_path, f.read()))
    return out


def rule_cc001(ctx) -> List[Finding]:
    return [f for f in rule_cc(ctx) if f.rule == "CC001"]


def rule_cc002(ctx) -> List[Finding]:
    return [f for f in rule_cc(ctx) if f.rule == "CC002"]


def rule_cc003(ctx) -> List[Finding]:
    return [f for f in rule_cc(ctx) if f.rule == "CC003"]
