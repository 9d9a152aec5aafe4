"""MultiTASC++ scheduler (paper Sec. IV) — the paper's core contribution.

Continuous threshold reconfiguration (Eq. 4):

    dthresh = -a * (SR_target - SR_update)

applied per device with *independent* SLO targets, plus the threshold-
scaling multiplier (Alg. 1): when the threshold is being raised
(SR_update > SR_target) the updated threshold is multiplied by m, and
m grows by (1 + 0.1/n) (n = active devices); any non-increase resets
m to 1. Thresholds are continuous in [0, 1]; SR values are in [0, 100].

``update`` is float32 torch over device vectors, in the operation order
of the JAX package's jitted update, so both give the same bits, on the
device of its inputs. It takes one fleet, (N,), or a batch of lanes,
(B, N), whose per-lane gains (``a``, ``sr_target``, ``mult_growth``,
``n_active``) arrive as (B,) tensors, the form the lane-aligned simulator
(``repro_torch.sim.jaxsim``) calls once per window boundary. The host
wrapper runs it on CPU tensors once per report: a control update over N
floats, not model work.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

DEFAULT_A = 0.005        # paper Sec. V-B: scaling variable a
DEFAULT_WINDOW = 1.5     # paper Sec. V-B: reporting window T (s)
DEFAULT_SR_TARGET = 95.0  # paper Sec. V-B

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class MultiTASCPPConfig:
    a: float = DEFAULT_A
    sr_target: float = DEFAULT_SR_TARGET
    window: float = DEFAULT_WINDOW
    mult_growth: float = 0.1   # Alg. 1 line 3
    thresh_min: float = 0.0
    thresh_max: float = 1.0


def init_state(n_devices: int, init_threshold=0.5):
    """Per-device controller state: continuous thresholds + multipliers."""
    return {"thresh": torch.full((n_devices,), init_threshold, dtype=_F32),
            "mult": torch.ones((n_devices,), dtype=_F32)}


def lane_values(x, like, dtype=_F32):
    """``x`` as a ``dtype`` tensor on ``like``'s device that broadcasts
    over ``like``: a scalar stays 0-d, a per-lane (B,) vector against
    (B, N) becomes (B, 1), a per-device vector of ``like``'s own rank
    stays."""
    x = torch.as_tensor(x, dtype=dtype, device=like.device)
    if 0 < x.dim() < like.dim():
        x = x.reshape(x.shape + (1,) * (like.dim() - x.dim()))
    return x


def update(state, sr_update, cfg: MultiTASCPPConfig, *, sr_target=None,
           n_active=None, active=None):
    """One scheduler step for all devices (vectorized Eq. 4 + Alg. 1).

    state: {"thresh": (N,) or (B, N), "mult": same} float32 tensors
    sr_update: SR values in [0, 100] reported this window, like thresh
    sr_target: scalar, (N,) per device, or in the (B, N) form (B,) per
      lane or (B, N) — per-device targets (a MultiTASC++ feature)
    cfg: its ``a`` / ``sr_target`` / ``mult_growth`` may be scalars or, in
      the (B, N) form, (B,) tensors (one gain per lane)
    n_active: scalar, or (B,) in the (B, N) form
    active: optional bool like thresh — inactive devices are left untouched
    """
    thresh, mult = state["thresh"], state["mult"]
    sr_target = lane_values(cfg.sr_target if sr_target is None
                            else sr_target, thresh)
    sr_update = torch.as_tensor(sr_update, dtype=_F32, device=thresh.device)
    if active is not None:
        active = torch.as_tensor(active, dtype=torch.bool,
                                 device=thresh.device)
    if n_active is None:
        n_active = (active.sum(-1) if active is not None
                    else thresh.shape[-1])
    n_active = torch.clamp(lane_values(n_active, thresh), min=1.0)
    a = lane_values(cfg.a, thresh)
    growth = lane_values(cfg.mult_growth, thresh)

    # Eq. 4 (continuous, proportional). XLA compiles thresh + (-a * diff)
    # into one fused multiply-add on FMA hardware, so the JAX package's
    # jitted update rounds once there; the float64 product of two float32
    # values is exact, so this rounds the same way.
    diff = sr_target - sr_update
    thresh_updated = (thresh.double() + (-a).double() * diff.double()).float()

    # Alg. 1 (threshold scaling)
    raising = sr_update > sr_target
    thresh_final = torch.where(raising, mult * thresh_updated, thresh_updated)
    one = torch.ones((), dtype=_F32, device=thresh.device)
    mult_new = torch.where(raising, mult * (1.0 + growth / n_active), one)

    thresh_final = torch.clamp(thresh_final, cfg.thresh_min, cfg.thresh_max)
    if active is not None:
        thresh_final = torch.where(active, thresh_final, thresh)
        mult_new = torch.where(active, mult_new, mult)
    return {"thresh": thresh_final, "mult": mult_new}


class MultiTASCPP:
    """Host-side wrapper used by the live serving engine.

    Keeps the vectorized state on the CPU and applies ``update`` whenever
    a device reports its windowed SR (per-device reporting, as in the
    paper).
    """

    name = "multitasc++"

    def __init__(self, n_devices: int, cfg: MultiTASCPPConfig = MultiTASCPPConfig(),
                 init_threshold=0.5, sr_targets=None):
        self.cfg = cfg
        self.n = n_devices
        self.state = init_state(n_devices, init_threshold)
        self.sr_targets = (np.full((n_devices,), cfg.sr_target, np.float32)
                           if sr_targets is None
                           else np.asarray(sr_targets, np.float32))
        self.active = np.ones((n_devices,), bool)

    def thresholds(self):
        return self.state["thresh"].numpy().copy()

    def set_active(self, active):
        self.active = np.asarray(active, bool)

    def report(self, device_id: int, sr_update: float) -> float:
        """Single-device SR report -> new threshold for that device."""
        mask = np.arange(self.n) == device_id
        sr = np.where(mask, np.float32(sr_update),
                      self.sr_targets)  # no-op delta for other devices
        self.state = update(self.state, torch.from_numpy(sr), self.cfg,
                            sr_target=torch.from_numpy(self.sr_targets),
                            n_active=np.float32(self.active.sum()),
                            active=torch.from_numpy(mask & self.active))
        return float(self.state["thresh"][device_id])

    def on_server_batch(self, batch_size: int) -> None:  # interface parity
        pass
