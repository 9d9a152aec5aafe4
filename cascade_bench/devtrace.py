"""The device trace of the slice: ``torch.profiler`` over CUDA activity,
exported as a Chrome trace and reduced to what the per-layer readers take.

Only device activity is traced (kernels, copies, sets): CUPTI records it
from every host thread, which the transport's workers need. A device op is
a Chrome-trace complete event ("ph" "X") of category ``kernel``,
``gpu_memcpy`` or ``gpu_memset``. An idle gap is named by the device ops on
either side of it, which says what the host was doing there: between a
batch's copy back to the host and the next batch's copy in, the cascade
loop ran; between two kernels, the host was launching.
"""
from __future__ import annotations

import collections
import json
import os
import re
import tempfile
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters; a copy's kind."""
    name = name.strip()
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return " ".join(name.split()[:2])
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::",
                                                  "")
    cut = min([i for i in (name.find("<"), name.find("(")) if i > 0],
              default=len(name))
    return name[:cut][:96]


def device_ops(events: List[dict]) -> List[Tuple[str, float, float]]:
    """(name, start us, duration us) of every device op, by start."""
    ops = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
           for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    return sorted(ops, key=lambda o: o[1])


def busy_and_gaps(ops) -> Tuple[float, List[Tuple[float, str, str]]]:
    """(seconds in which some device op ran, [(gap seconds, op before,
    op after)] between the union's segments)."""
    busy = 0.0
    gaps = []
    end, last = None, None
    start = None
    for name, ts, dur in ops:
        if end is None or ts > end:
            if end is not None:
                busy += end - start
                gaps.append(((ts - end) * 1e-6, last, name))
            start, end = ts, ts + dur
        elif ts + dur > end:
            end = ts + dur
        if ts + dur >= end:
            last = name
    if end is not None:
        busy += end - start
    return busy * 1e-6, gaps


def summarize(events: List[dict], top: int = 10) -> Dict:
    """What the readers take from a trace: the device ops, the busy
    seconds, and the breakdown's two lists (the device ops that took most
    time, the idle gaps by what was on either side, summed)."""
    ops = device_ops(events)
    busy, gaps = busy_and_gaps(ops)
    by_op = collections.defaultdict(float)
    for name, _, dur in ops:
        by_op[short_name(name)] += dur * 1e-6
    by_gap = collections.defaultdict(float)
    for sec, before, after in gaps:
        by_gap[f"{short_name(before)} -> {short_name(after)}"] += sec
    return {
        "ops": ops,
        "busy_s": busy,
        "device_ops": sorted(([k, v] for k, v in by_op.items()),
                             key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(([k, v] for k, v in by_gap.items()),
                            key=lambda kv: -kv[1])[:top],
    }


class DeviceTrace:
    """``torch.profiler`` over CUDA activity for one slice of batches."""

    def __init__(self):
        self._prof = None

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CUDA])

    def warm(self, work) -> None:
        """Start and stop a profiler around ``work()`` once, so that the
        tracer's own set-up is paid before the window."""
        with self._profile():
            work()

    def start(self) -> None:
        self._prof = self._profile()
        self._prof.start()

    def stop(self) -> Optional[Dict]:
        """Stop, export to a file in the temporary directory, read it back
        and delete it; None if no slice was traced."""
        if self._prof is None:
            return None
        self._prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self._prof = None
        return summarize(events)
