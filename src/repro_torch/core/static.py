"""Static-threshold baseline (paper Sec. V-A, "equivalent to a set of
state-of-the-art cascades [5], [6], [9]").

Thresholds are calibrated offline and fixed for the whole run.
"""
from __future__ import annotations

import numpy as np


class Static:
    name = "static"

    def __init__(self, n_devices: int, threshold: float):
        self.state = {"thresh": np.full((n_devices,), threshold,
                                        np.float32)}

    def thresholds(self):
        return self.state["thresh"]

    def report(self, device_id: int, sr_update: float) -> float:
        return float(self.state["thresh"][device_id])

    def on_server_batch(self, batch_size: int) -> None:
        pass
