"""Guards that only a card can run: the runtime side of the HD and TD
rules, used by ``chip_smoke.py``'s "analysis on the card" phase.

* ``SyncCensus``: a context that turns on
  ``torch.cuda.set_sync_debug_mode("warn")`` and counts every
  synchronizing CUDA operation it reports by the innermost frame of the
  port that made it (``Site``: file, line, function). ``unlisted``
  holds the census to the static gate, line by line: a sync on a line
  that carries no allowlisted HD002 finding is one the gate does not
  account for.
* ``CaptureGuard``: deltas of the simulator's ``graphs_captured`` and
  ``engines_built`` over a block, the runtime form of TD003 (a sweep of
  traced values over one structure captures once).
* ``float64_on_card``: TD001 on a recording of an entry run on the card.
"""
from __future__ import annotations

import collections
import os
import sys
import warnings
from typing import Dict, Iterable, List

import torch

from repro_torch.analysis import graph_tools as gt
from repro_torch.analysis import host_rules
from repro_torch.analysis.findings import Finding

SYNC_MESSAGE = "synchronizing CUDA operation"
PORT_PREFIX = "src/repro_torch/"


def port_site(frame=None) -> gt.Site:
    """The innermost frame of the port on the stack (else the innermost
    source frame, else ``NO_SITE``)."""
    frames = gt.source_frames(frame or sys._getframe(1))
    for f in frames:
        site = gt.site_of(f)
        if site.path.startswith(PORT_PREFIX):
            return site
    return gt.site_of(frames[0]) if frames else gt.NO_SITE


class SyncCensus:
    """Counts the syncs the CUDA sync debug mode reports inside the
    block: ``sites`` (a Counter of port ``Site``s) and ``outside`` (syncs
    made by code outside the port, such as the caller's own reads)."""

    def __init__(self):
        self.sites: collections.Counter = collections.Counter()
        self.outside: collections.Counter = collections.Counter()

    def __enter__(self):
        self._mode = torch.cuda.get_sync_debug_mode()
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.filterwarnings("always", message=f".*{SYNC_MESSAGE}")
        self._show = warnings.showwarning
        warnings.showwarning = self._hook
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def _hook(self, message, category, filename, lineno, file=None,
              line=None):
        if SYNC_MESSAGE not in str(message):
            self._show(message, category, filename, lineno, file, line)
            return
        site = port_site(sys._getframe(1))
        if site.path.startswith(PORT_PREFIX):
            self.sites[site] += 1
        else:
            self.outside[site] += 1

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(self._mode)
        self._catch.__exit__(*exc)
        return False

    @property
    def total(self) -> int:
        return sum(self.sites.values())

    def by_symbol(self) -> Dict[tuple, int]:
        out: Dict[tuple, int] = collections.Counter()
        for site, n in self.sites.items():
            out[(site.path, site.symbol)] += n
        return dict(out)

    def unlisted(self, entries: Iterable, root: str) -> List[gt.Site]:
        """The port's sync sites that the static gate does not account
        for. A site is accounted for only if its line carries an HD002
        finding of ``host_rules`` (files read under ``root``) that an
        allowlist entry suppresses: a sync on a line the static rule does
        not flag fails, whatever entry its function has."""
        entries = [e for e in entries if e.rule == "HD002"]
        accounted = set()
        for path in {s.path for s in self.sites}:
            with open(os.path.join(root, path), encoding="utf-8") as f:
                found = host_rules.scan_source(path, f.read())
            accounted.update((f.path, f.line) for f in found
                             if f.rule == "HD002"
                             and any(e.matches(f) for e in entries))
        return sorted((s for s in self.sites
                       if (s.path, s.line) not in accounted),
                      key=lambda s: (s.path, s.line))


class CaptureGuard:
    """``with CaptureGuard() as g: ...``; ``g.delta`` is how many CUDA
    graphs the simulator captured and engines it built inside."""

    FIELDS = ("graphs_captured", "engines_built")

    def __enter__(self):
        from repro_torch.sim import jaxsim
        self._stats = jaxsim.stats
        self._start = {f: getattr(self._stats, f) for f in self.FIELDS}
        self.delta: Dict[str, int] = {}
        return self

    def __exit__(self, *exc):
        self.delta = {f: getattr(self._stats, f) - self._start[f]
                      for f in self.FIELDS}
        return False


def float64_on_card(name: str, fn, *args, **kwargs) -> List[Finding]:
    """TD001's findings on one recorded call (any device)."""
    from repro_torch.analysis.trace_rules import float64_findings
    rec, _ = gt.record(fn, *args, **kwargs)
    return float64_findings(name, rec)
