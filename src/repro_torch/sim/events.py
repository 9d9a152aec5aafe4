"""Event taxonomy and scheduler factory of the reference simulator.

The subset of the JAX package's ``sim/events.py`` that the live cascade
needs: the event kinds in tie-break priority order (a heap keyed
``(time, kind, sequence)`` resolves simultaneous events in this order),
and ``make_scheduler``. The event simulator itself is a later slice
(ROADMAP.md Queue A).
"""
from __future__ import annotations

from repro_torch.core.multitasc import MultiTASC, MultiTASCConfig
from repro_torch.core.multitascpp import MultiTASCPP, MultiTASCPPConfig
from repro_torch.core.static import Static

EV_JOIN = 0     # device joins the fleet (churn)
EV_LEAVE = 1    # device departs the fleet (churn)
EV_DEV = 2      # device completion
EV_ONLINE = 3   # device back online (sample-indexed offline mode)
EV_SRV = 4      # server batch finish
EV_WINDOW = 5   # SLO window boundary


def make_scheduler(name: str, n: int, *, server_profile, slo: float,
                   init_threshold: float = 0.5, sr_target: float = 95.0,
                   a: float = 0.005, static_threshold: float = 0.35):
    if name == "multitasc++":
        return MultiTASCPP(n, MultiTASCPPConfig(a=a, sr_target=sr_target),
                           init_threshold)
    if name == "multitasc":
        return MultiTASC(n, server_profile, slo, MultiTASCConfig(),
                         init_threshold)
    if name == "static":
        return Static(n, static_threshold)
    raise KeyError(name)
