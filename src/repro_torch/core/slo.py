"""SLO satisfaction-rate accounting (paper Sec. IV-B).

Latency is measured from the start of on-device inference until the final
result is available (locally, or back from the server). Each device
aggregates, over windows of T seconds, the fraction of its completed
samples that met the latency SLO, and reports that SR_update to the
scheduler at the window boundary.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class WindowedSLOTracker:
    """Host-side per-device tracker used by the live serving engine."""
    slo: float                 # latency target (s)
    window: float              # reporting period T (s)
    _window_start: float = 0.0
    _met: int = 0
    _total: int = 0

    def record(self, latency: float) -> None:
        self._met += int(latency <= self.slo)
        self._total += 1

    def maybe_report(self, now: float) -> Optional[float]:
        """Returns SR_update if the window elapsed, else None."""
        if now - self._window_start < self.window:
            return None
        sr = self.satisfaction_rate()
        self._window_start = now
        self._met = 0
        self._total = 0
        return sr

    def satisfaction_rate(self) -> float:
        """Current-window SR in [0,100]; 100 if no samples completed."""
        if self._total == 0:
            return 100.0
        return 100.0 * self._met / self._total
