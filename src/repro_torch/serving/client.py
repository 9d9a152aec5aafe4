"""Device client: light model + forwarding decision function (Fig. 2 left).

Runs the tier's light model on each sample, computes BvSB confidence, and
applies Eq. 3 against the scheduler-controlled threshold. Timing uses the
tier's calibrated latency profile (virtual clock) while logits are real,
computed on the model's device. The single-sample classify function comes
from the process-wide cache (``serving/executables.py``), shared by every
client of one architecture.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.cascade_tiers import DeviceProfile
from repro_torch.core.slo import WindowedSLOTracker
from repro_torch.models.model import Model
from repro_torch.serving.executables import classify_fn


@dataclasses.dataclass
class DeviceClient:
    device_id: int
    model: Model
    profile: DeviceProfile
    slo: float
    window: float
    threshold: float
    confidence: str = "bvsb"

    def __post_init__(self):
        self.tracker = WindowedSLOTracker(self.slo, self.window)
        self._infer = classify_fn(self.model, 1, self.confidence)

    def run_local(self, tokens) -> tuple:
        """Returns (confidence, prediction, forward?)."""
        batch = torch.as_tensor(np.asarray(tokens)[None],
                                device=self.model.device)
        conf, pred = self._infer(self.model, batch)
        conf, pred = float(conf[0]), int(pred[0])
        fwd = conf < self.threshold
        return conf, pred, fwd

    def record_completion(self, latency: float) -> None:
        self.tracker.record(latency)

    def maybe_report(self, now: float) -> Optional[float]:
        return self.tracker.maybe_report(now)
