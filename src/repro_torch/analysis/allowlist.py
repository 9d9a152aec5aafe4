"""Allowlist for justified findings (``allowlist.toml`` beside this
module), the JAX package's ``analysis/allowlist.py`` copied.

Entries are ``[[allow]]`` tables with string fields::

    [[allow]]
    rule = "HD002"
    path = "src/repro_torch/serving/client.py"
    symbol = "DeviceClient.run_local"  # optional: any symbol when absent
    reason = "Eq. 3 reads the confidence on the host, once a sample"

``reason`` is mandatory — an unexplained suppression is itself a lint
failure — and the list must be *exact*: an entry that suppresses
nothing is stale and fails the run (the mirror image of check_bench's
"baseline must be re-captured" discipline, so the allowlist can only
shrink to fit the tree, never accrete).

A Python without ``tomllib`` (before 3.11) falls back on ``_parse_toml``,
a vendored parser covering exactly the subset above (array-of-
tables of string key/values, comments, blank lines) so the linter has
zero third-party dependencies.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.analysis.findings import Finding


def _parse_toml(text: str) -> dict:
    """Minimal TOML subset: ``[[name]]`` array-of-tables with
    ``key = "string"`` pairs. Raises ValueError on anything else."""
    out: dict = {}
    current: Optional[dict] = None
    for ln, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("[[") and line.endswith("]]"):
            name = line[2:-2].strip()
            current = {}
            out.setdefault(name, []).append(current)
            continue
        if "=" in line and current is not None:
            key, _, val = line.partition("=")
            key, val = key.strip(), val.strip()
            # strip a trailing comment outside the quotes
            if val.startswith('"') and val.count('"') >= 2:
                val = val[1:val.index('"', 1)]
            else:
                raise ValueError(
                    f"allowlist line {ln}: only quoted string values are"
                    f" supported ({raw!r})")
            current[key] = val
            continue
        raise ValueError(f"allowlist line {ln}: unsupported syntax {raw!r}")
    return out


def _load_toml(path: str) -> dict:
    try:
        import tomllib
        with open(path, "rb") as f:
            return tomllib.load(f)
    except ModuleNotFoundError:
        with open(path, encoding="utf-8") as f:
            return _parse_toml(f.read())


@dataclasses.dataclass
class AllowEntry:
    rule: str
    path: str
    symbol: Optional[str]
    reason: str
    hits: int = 0

    def matches(self, f: Finding) -> bool:
        if f.rule != self.rule or f.path != self.path:
            return False
        return self.symbol is None or f.symbol == self.symbol


def load_allowlist(path: Optional[str]) -> List[AllowEntry]:
    if path is None:
        return []
    data = _load_toml(path)
    entries = []
    for i, raw in enumerate(data.get("allow", [])):
        missing = [k for k in ("rule", "path", "reason") if not raw.get(k)]
        if missing:
            raise ValueError(
                f"allowlist entry {i}: missing required field(s) "
                f"{missing} (every suppression needs rule, path and a "
                f"one-line reason)")
        entries.append(AllowEntry(rule=raw["rule"], path=raw["path"],
                                  symbol=raw.get("symbol"),
                                  reason=raw["reason"]))
    return entries


def apply_allowlist(findings: List[Finding], entries: List[AllowEntry]):
    """Split findings into (kept, suppressed); bumps entry hit counts.

    Stale entries (``hits == 0`` after the pass) are reported by the
    runner as findings of their own.
    """
    kept, suppressed = [], []
    for f in findings:
        hit = None
        for e in entries:
            if e.matches(f):
                hit = e
                break
        if hit is None:
            kept.append(f)
        else:
            hit.hits += 1
            suppressed.append(f)
    return kept, suppressed
