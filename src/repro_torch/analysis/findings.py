"""Finding/severity types shared by every rule family (the JAX
package's ``analysis/findings.py``, copied)."""
from __future__ import annotations

import dataclasses


class Severity:
    WARN = "warn"
    ERROR = "error"
    ORDER = {WARN: 0, ERROR: 1}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violation.

    ``path`` is repo-relative for file-based rules and for recorded ops
    that have a source frame (the innermost frame of the port, or of a
    corpus file); properties of a whole recorded program use
    ``<entry:NAME>`` pseudo-paths. ``symbol`` is the enclosing
    function's qualified name (``Class.method``), or the carry buffer /
    entry argument the finding is about — the allowlist matches on
    (rule, path, symbol).
    """
    rule: str
    family: str
    severity: str
    path: str
    line: int
    symbol: str
    message: str

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return (f"{loc}: {self.rule} {self.severity} [{self.symbol}] "
                f"{self.message}")


@dataclasses.dataclass(frozen=True)
class RuleSpec:
    """A registered rule: ``fn(ctx) -> list[Finding]``.

    Rules must *run* to count: the runner records executed rule ids and
    ``python -m repro_torch.analysis --require`` fails the job when a required rule (or
    family) did not execute — a crashed or skipped rule can never pass
    vacuously (mirrors check_bench's ``--require FIGURE``).
    """
    id: str
    family: str
    severity: str
    doc: str
    fn: object
