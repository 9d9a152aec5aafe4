"""Dynamic-environment scenario specs: device churn + workload drift.

Own copy of the JAX package's ``configs/scenarios.py`` (numpy only);
``realize`` returns the same arrays as the reference for the same seeds.

A ``ScenarioSpec`` describes the *environment* of a cascade run — which
devices join or leave the fleet mid-run (churn) and how each device's
sample arrival process drifts over time — separately from the fleet
profile (latencies, SLOs, tiers) and the scheduler. ``realize`` turns a
spec into the concrete per-device tensors the simulators consume:

    scn = SCENARIOS["churn_drift"]
    r = realize(scn, seeds, n_devices=20, samples_per_device=600,
                dev_latency=0.1)
    streams["arrive"] = r["arrive"]            # may be None (saturated)
    jaxsim.run_sweep(..., join_t=r["join_t"], leave_t=r["leave_t"])

Semantics (shared by ``repro_torch.sim.jaxsim`` and the
``repro_torch.sim.events`` reference sim):

* a device is a fleet member on ``[join_t, leave_t)`` seconds; its
  first sample starts at ``max(join_t, arrival of sample 0)`` and a
  would-be completion at or past ``leave_t`` drops the rest of its
  stream (see the EV_JOIN/EV_LEAVE taxonomy in ``repro_torch.sim.events``);
* arrival tensors are cumulative seconds per sample
  (``synthetic.piecewise_arrivals`` / ``synthetic.mmpp_arrivals``);
  arrival *rates* here are expressed as multiples of each device's
  service rate ``1 / latency``, so one spec scales across
  heterogeneous fleets — a multiple > 1 keeps the device backlogged
  (saturated behaviour), < 1 opens idle gaps.

Randomness is keyed per sweep seed from dedicated SeedSequence children
(churn: child 2, arrivals: child 1 — ``synthetic._child_rng``), so a
scenario never perturbs the seed's sample streams and two scenarios
sharing a seed draw identical churn schedules where their fractions
overlap.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.sim import synthetic


@dataclasses.dataclass(frozen=True)
class ChurnSpec:
    """Which fraction of the fleet joins late / leaves early, and when
    (as fractions of the scenario horizon)."""
    join_frac: float = 0.0
    leave_frac: float = 0.0
    join_window: Tuple[float, float] = (0.10, 0.45)
    leave_window: Tuple[float, float] = (0.55, 0.90)


@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """Per-device arrival process; rates are multiples of the device's
    service rate ``1 / latency``.

    kind: ``"saturated"`` (no arrival tensor — the legacy back-to-back
    model), ``"piecewise"`` (rate steps through ``rate_scales`` over
    equal sample-index segments) or ``"mmpp"`` (bursty two-state chain
    alternating ``burst_scale`` / ``lull_scale`` with ``switch_prob``).
    """
    kind: str = "saturated"
    rate_scales: Tuple[float, ...] = (1.5, 0.6)
    burst_scale: float = 1.8
    lull_scale: float = 0.55
    switch_prob: float = 0.05


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    name: str
    churn: ChurnSpec = ChurnSpec()
    arrivals: ArrivalSpec = ArrivalSpec()


# the named scenarios the fig_churn benchmark and the scenario tests
# sweep; "steady" is the no-op control (identical to omitting the
# scenario inputs altogether)
SCENARIOS = {
    "steady": ScenarioSpec("steady"),
    "churn": ScenarioSpec(
        "churn", churn=ChurnSpec(join_frac=0.3, leave_frac=0.3)),
    "drift": ScenarioSpec(
        "drift", arrivals=ArrivalSpec(kind="mmpp")),
    "churn_drift": ScenarioSpec(
        "churn_drift",
        churn=ChurnSpec(join_frac=0.25, leave_frac=0.25),
        arrivals=ArrivalSpec(kind="piecewise")),
}


def realize(scn: ScenarioSpec, seeds: Sequence[int], n_devices: int,
            samples_per_device: int, dev_latency,
            horizon: Optional[float] = None):
    """Concretize a scenario into simulator inputs, one row per seed.

    Args:
      scn: the scenario.
      seeds: sweep seeds (one independent realization each).
      n_devices / samples_per_device: fleet shape.
      dev_latency: per-device inference latency, seconds — scalar or
        (n_devices,); sets both the service-rate scaling of arrivals
        and the default horizon.
      horizon: scenario duration in seconds that churn-window fractions
        refer to; defaults to the saturated stream duration
        ``samples_per_device * max(dev_latency)``.

    Returns ``{"join_t": (S, N) float32, "leave_t": (S, N) float32,
    "arrive": (S, N, M) float32 or None}`` ready for
    ``jaxsim.run_sweep(..., join_t=..., leave_t=...)`` and
    ``streams["arrive"]``.
    """
    lat = np.broadcast_to(np.asarray(dev_latency, np.float64),
                          (n_devices,))
    if horizon is None:
        horizon = float(lat.max()) * samples_per_device
    s, n = len(seeds), n_devices

    join_t = np.zeros((s, n), np.float32)
    leave_t = np.full((s, n), np.inf, np.float32)
    ch = scn.churn
    if ch.join_frac > 0 or ch.leave_frac > 0:
        for i, seed in enumerate(seeds):
            rng = synthetic._child_rng(seed, 2)
            joins = rng.random(n) < ch.join_frac
            leaves = rng.random(n) < ch.leave_frac
            join_t[i] = np.where(
                joins, rng.uniform(*ch.join_window, n) * horizon, 0.0)
            leave_t[i] = np.where(
                leaves, rng.uniform(*ch.leave_window, n) * horizon,
                np.inf)

    ar = scn.arrivals
    rate = 1.0 / lat                           # service rate, samples/s
    if ar.kind == "saturated":
        arrive = None
    elif ar.kind == "piecewise":
        arrive = synthetic.piecewise_arrivals(
            seeds, n, samples_per_device,
            [sc * rate for sc in ar.rate_scales])
    elif ar.kind == "mmpp":
        arrive = synthetic.mmpp_arrivals(
            seeds, n, samples_per_device, ar.burst_scale * rate,
            ar.lull_scale * rate, ar.switch_prob)
    else:
        raise ValueError(f"unknown arrival kind {ar.kind!r}")
    return {"join_t": join_t, "leave_t": leave_t, "arrive": arrive}
