"""The fleet around the program's server: device clients that answer from
the calibrated stream, and an engine subclass that times each batch, opens
the window at the cascade's operating point and closes it.

The devices are phones: their light models do not run on the server's
card. A ``StreamDevice`` is the program's ``serving/replay.py``
``StreamClient`` with the cell's device profile, whose samples are token
arrays that go to the server. ``TimedEngine`` is the program's
``ServerEngine`` with every submitted and served request recorded. Until
the cascade's virtual clock reaches ``opens_at`` it serves batches from a
stand-in on the host and launches nothing: the scheduler's decisions do not
depend on the answers, so the cascade reaches its operating point as it
would with the model. From there each ``execute`` runs the model and is
timed on the host clock, and once the window has closed an ``execute``
raises ``WindowClosed`` and launches nothing, which ends
``run_transport``. With a trace slice it first serves ``slice`` more
batches alone on the card under the profiler.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional

import numpy as np

from repro_torch.configs.cascade_tiers import DeviceProfile
from repro_torch.serving.engine import ServerEngine
from repro_torch.serving.replay import StreamClient


class WindowClosed(Exception):
    """Raised by ``TimedEngine.execute`` to cut the cascade."""


class StreamDevice(StreamClient):
    """``StreamClient`` whose sample j is the j-th ``run_local`` call, the
    order in which the transport hands a device its samples (it is handed
    the sample's tokens, not its index)."""

    def __init__(self, device_id: int, confidence, correct_light,
                 profile: dict, slo: float, window: float, threshold: float):
        super().__init__(device_id, confidence, correct_light,
                         profile["latency"], slo, window, threshold)
        self.profile = DeviceProfile(profile["name"], profile["model"],
                                     "high", float(profile["accuracy"]),
                                     float(profile["latency"]))
        self._j = 0

    def run_local(self, tokens) -> tuple:
        self._j += 1
        return super().run_local(self._j - 1)


@dataclasses.dataclass
class Batch:
    """One executed batch: host-clock start and end of ``execute``, the
    ladder bucket, the requests' (device, sample) keys, the results, and
    whether it ran before the window ("prelude", on the host's stand-in),
    in the window, or in the trace slice."""
    t0: float
    t1: float
    bucket: int
    keys: List[tuple]
    conf: np.ndarray
    pred: np.ndarray
    phase: str


class TimedEngine(ServerEngine):
    """``ServerEngine`` with each ``execute`` recorded, the window opened at
    the operating point and cut. ``arm(opens_at, seconds, slice_batches,
    on_slice)`` sets the window: it opens with the first batch that starts
    at virtual ``opens_at`` or later (``t_start``, host clock; ``opened``
    is set) and lasts ``seconds``; ``on_slice`` is called once, in a worker
    and with no batch executing, before the slice's first batch launches;
    ``slice_done`` is set when the slice's last batch has finished."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.batches: List[Batch] = []
        self.submitted: List[tuple] = []
        self.cut: List[tuple] = []
        self._cv = threading.Condition()
        self._active = 0
        self._state = "idle"
        self._opens_at = 0.0
        self._seconds = float("inf")
        self.t_start: Optional[float] = None
        self.t_end = float("inf")
        self.opened = threading.Event()
        self._slice_left = 0
        self._slice_open = 0
        self._on_slice: Optional[Callable[[], None]] = None
        self.slice_t0: Optional[float] = None
        self.slice_done = threading.Event()

    def arm(self, opens_at: float, seconds: float, slice_batches: int = 0,
            on_slice: Optional[Callable[[], None]] = None) -> None:
        self._opens_at = float(opens_at)
        self._seconds = float(seconds)
        self._slice_left = slice_batches
        self._on_slice = on_slice
        self._state = "prelude"

    def submit(self, req):
        self.submitted.append((req.device_id, req.payload[0]))
        return super().submit(req)

    def _admit(self, record: dict, keys) -> str:
        """The phase this batch runs in, or raise ``WindowClosed``."""
        with self._cv:
            if self._state == "prelude":
                if record["finish"] - record["latency"] < self._opens_at:
                    return "prelude"
                self._state = "window"
                self.t_start = time.perf_counter()
                self.t_end = self.t_start + self._seconds
                self.opened.set()
            if self._state == "window" and time.perf_counter() >= self.t_end:
                self._state = "drain" if self._slice_left else "closed"
            if self._state == "drain":
                self._cv.wait_for(lambda: self._active == 0
                                  or self._state != "drain")
                if self._state == "drain":
                    if self._on_slice is not None:
                        self._on_slice()
                    self.slice_t0 = time.perf_counter()
                    self._state = "slice"
            if self._state == "slice" and self._slice_left > 0:
                self._slice_left -= 1
                self._slice_open += 1
                self._active += 1
                return "slice"
            if self._state in ("slice", "closed"):
                self._state = "closed"
                self.cut.extend(keys)
                raise WindowClosed
            self._active += 1
            return "window"

    def execute(self, record: dict) -> dict:
        keys = [(r.device_id, r.payload[0]) for r in record["requests"]]
        phase = self._admit(record, keys)
        if phase == "prelude":
            record.pop("_served")
            n, t = len(keys), time.perf_counter()
            record["conf"] = np.zeros(n, np.float32)
            record["pred"] = np.zeros(n, np.int32)
            self.batches.append(Batch(t, t, int(record["bucket"]), keys,
                                      record["conf"], record["pred"], phase))
            return record
        try:
            t0 = time.perf_counter()
            out = super().execute(record)
            t1 = time.perf_counter()
        finally:
            with self._cv:
                self._active -= 1
                if phase == "slice":
                    self._slice_open -= 1
                    if self._slice_left == 0 and self._slice_open == 0:
                        self.slice_done.set()
                self._cv.notify_all()
        self.batches.append(Batch(t0, t1, int(record["bucket"]), keys,
                                  np.asarray(out["conf"]),
                                  np.asarray(out["pred"]), phase))
        return out
