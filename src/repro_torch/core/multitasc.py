"""MultiTASC baseline scheduler (Nikolaidis et al., ISCC 2023 — ref [11]).

The predecessor system the paper improves upon: it watches the server's
running batch size against an optimal batch size b* computed once from
the server's throughput profile, and moves every device's threshold by
one fixed step when the observed batch deviates from b*. One global
latency target; no per-device SLO targets.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.cascade_tiers import BATCH_LADDER
from repro_torch.core.multitascpp import lane_values

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class MultiTASCConfig:
    step: float = 0.05          # fixed threshold step
    deadband: int = 0           # tolerated |b - b*| deviation
    window: float = 1.5         # update period (s)


def optimal_batch(server_profile, slo: float) -> int:
    """b*: the largest ladder batch whose batched latency still leaves
    queueing headroom inside the SLO (0.3x budget, computed once)."""
    best = 1
    for b in BATCH_LADDER:
        if b <= server_profile.max_batch and \
                server_profile.batch_latency(b) <= 0.3 * slo:
            best = b
    return best


def init_state(n_devices: int, init_threshold=0.5):
    return {"thresh": torch.full((n_devices,), init_threshold, dtype=_F32)}


def update(state, observed_batch, b_opt, cfg: MultiTASCConfig, active=None):
    """Discrete step update from the batch-size deviation signal.

    state: {"thresh": (N,) or (B, N)} float32. observed_batch and b_opt:
    scalars, or (B,) per lane in the (B, N) form, as is ``cfg.step``. All
    (active) devices of a fleet get the same step. Runs on thresh's device.
    """
    thresh = state["thresh"]
    dev = thresh.device
    observed_batch = lane_values(observed_batch, thresh, torch.int32)
    b_opt = lane_values(b_opt, thresh, torch.int32)
    over = observed_batch > b_opt + cfg.deadband
    under = observed_batch < b_opt - cfg.deadband
    step = lane_values(cfg.step, thresh)
    zero = torch.zeros((), dtype=_F32, device=dev)
    delta = torch.where(over, -step, torch.where(under, step, zero))
    new = torch.clamp(thresh + delta, 0.0, 1.0)
    if active is not None:
        new = torch.where(torch.as_tensor(active, dtype=torch.bool,
                                          device=dev), new, thresh)
    return {"thresh": new}


class MultiTASC:
    name = "multitasc"

    def __init__(self, n_devices: int, server_profile, slo: float,
                 cfg: MultiTASCConfig = MultiTASCConfig(), init_threshold=0.5):
        self.cfg = cfg
        self.state = init_state(n_devices, init_threshold)
        self.b_opt = optimal_batch(server_profile, slo)
        self._recent_batch = 0

    def thresholds(self):
        return self.state["thresh"].numpy().copy()

    def on_server_batch(self, batch_size: int) -> None:
        self._recent_batch = batch_size

    def report(self, device_id: int, sr_update: float) -> float:
        # MultiTASC ignores SR reports; updates happen on its own window
        return float(self.state["thresh"][device_id])

    def on_window(self, active=None) -> None:
        self.state = update(self.state, np.int32(self._recent_batch),
                            self.b_opt, self.cfg,
                            None if active is None else np.asarray(active, bool))
