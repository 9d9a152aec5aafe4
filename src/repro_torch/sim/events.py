"""Event-driven reference simulator of the multi-device cascade.

Exact discrete-event reproduction of the paper's system (Fig. 2): devices
stream samples at their inference rate, forward low-confidence samples to
the shared server queue, the server drains the queue with dynamic batching
(paper ladder B = {1,2,4,8,16,32,64} capped per model), results return to
devices, and each device reports its windowed SLO satisfaction rate to the
scheduler. The ground-truth oracle for the lane-aligned simulator
(``repro_torch.sim.jaxsim``) and for the smaller paper experiments.
Counterpart of the JAX package's ``sim/events.py``: plain Python over a
heap, float64 event times, the port's own host-side schedulers.

Event taxonomy
--------------
Six event kinds drive the simulation, processed from a priority heap
keyed ``(time, kind priority, sequence)`` so simultaneous events resolve
deterministically and in the same order as the vectorized event-jump
core:

=========  ========  ====================================================
kind       priority  meaning
=========  ========  ====================================================
EV_JOIN    0         a device joins the fleet (churn): its first sample
                     is scheduled; it becomes reportable at boundaries
EV_LEAVE   1         a device departs the fleet (churn): remaining
                     stream samples are dropped, in-flight server
                     requests still complete
EV_DEV     2         a device finishes local inference on its next sample
                     (classify locally or forward to the server queue)
EV_ONLINE  3         a device returns from a sample-indexed offline gap
EV_SRV     4         a server batch finishes (results return, next batch
                     may start back-to-back)
EV_WINDOW  5         SLO window boundary: per-device SR reports,
                     scheduler update, model-switching decision
=========  ========  ====================================================

At one instant this yields: membership changes first (a join at exactly
``t`` is visible to every same-instant event; a leave at exactly ``t``
beats a completion at ``t`` — the completion is dropped, matching the
vectorized core's ``dev_next >= leave_t`` departure test), then
completions, then batch finish + launch (seeing the just-forwarded
samples), then the window update — exactly the in-instant processing
order of ``jaxsim``'s event loop. A boundary at ``t_end`` therefore
reports a device active iff ``join_t <= t_end < leave_t`` (and it is
not offline), the closed form ``jaxsim`` evaluates from its traced
churn schedule.

Offline gaps come in two flavours: the original *sample-indexed* gap
(``offline_at``/``offline_for``: the device drops out when its cursor
reaches a sample index) and the *time-based* window used by ``jaxsim``
(``offline_start_t``/``offline_for_t``: a completion falling inside
``[start, start + for)`` is deferred to the end of the gap and the device
is reported inactive at window boundaries inside the gap). The
time-based flavour matches the vectorized core sample-for-sample, which
is what the differential harness (tests/test_differential.py) relies on.

Non-stationary arrivals: ``DeviceRuntime.arrive`` (cumulative seconds
per sample, same convention as ``jaxsim``'s ``streams["arrive"]``)
gates when each sample can start — sample ``j`` begins at
``max(previous finish, arrive[j])`` and completes one device latency
later. ``None`` keeps the saturated legacy model.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.configs.cascade_tiers import (BATCH_LADDER, DeviceProfile,
                                               ServerProfile)
from repro_torch.core import switching
from repro_torch.core.multitasc import MultiTASC, MultiTASCConfig
from repro_torch.core.multitascpp import MultiTASCPP, MultiTASCPPConfig
from repro_torch.core.static import Static
from repro_torch.sim.synthetic import SampleStream

# event kinds, in tie-break priority order (see module docstring)
EV_JOIN = 0     # device joins the fleet (churn)
EV_LEAVE = 1    # device departs the fleet (churn)
EV_DEV = 2      # device completion
EV_ONLINE = 3   # device back online (sample-indexed offline mode)
EV_SRV = 4      # server batch finish
EV_WINDOW = 5   # SLO window boundary


@dataclasses.dataclass
class DeviceRuntime:
    profile: DeviceProfile
    stream: SampleStream
    slo: float
    threshold: float
    cursor: int = 0
    met: int = 0
    win_met: int = 0
    win_total: int = 0
    total: int = 0
    correct: int = 0
    forwarded: int = 0
    active: bool = True
    offline_at: Optional[int] = None      # go offline at this sample index
    offline_for: float = 0.0              # seconds (sample-indexed mode)
    offline_start_t: Optional[float] = None  # time-based offline window (s)
    offline_for_t: float = 0.0               # its duration (s)
    join_t: float = 0.0                   # fleet membership [join_t, ...
    leave_t: float = float("inf")         # ..., leave_t) — churn schedule
    joined: bool = True                   # flipped by EV_JOIN / EV_LEAVE
    departed: bool = False
    arrive: Optional[np.ndarray] = None   # (n,) cumulative arrival times

    def offline_during(self, t: float) -> bool:
        """Is ``t`` inside the time-based offline window?"""
        return (self.offline_start_t is not None
                and self.offline_start_t <= t
                < self.offline_start_t + self.offline_for_t)

    def arrival(self, j: int) -> float:
        """Arrival time of sample ``j`` (0.0 in the saturated model)."""
        return 0.0 if self.arrive is None else float(self.arrive[j])


@dataclasses.dataclass
class SimResult:
    sr: float                      # overall SLO satisfaction rate [0,100]
    accuracy: float                # mean per-device accuracy
    throughput: float              # completed samples / s
    per_device_sr: np.ndarray
    per_device_acc: np.ndarray
    forwarded_frac: float
    timeline: Dict[str, List]      # window-resolution traces
    server_model_time: np.ndarray  # seconds spent on each server profile
    # heap pops processed, ALL kinds including EV_WINDOW/EV_ONLINE — a
    # different quantity from jaxsim's n_events (inner event-loop
    # iterations, which exclude window boundaries and may merge a
    # completion cluster with a launch); don't cross-compare the two
    n_events: int = 0
    # samples that actually completed (locally or on the server): equals
    # the stream total without churn; under churn, a departing device's
    # unprocessed samples are dropped and never counted here
    completed: int = 0


def run(devices: List[DeviceRuntime], servers: Sequence[ServerProfile],
        scheduler, *, window: float = 1.5, model_switching: bool = False,
        tier_ids: Optional[np.ndarray] = None,
        c_lower: float = switching.DEFAULT_C_LOWER,
        c_upper: Optional[np.ndarray] = None,
        server_init: int = 0, max_time: float = 10_000.0) -> SimResult:
    n = len(devices)
    tier_ids = np.zeros(n, np.int32) if tier_ids is None else np.asarray(tier_ids)
    n_tiers = int(tier_ids.max()) + 1
    if c_upper is None:
        c_upper = np.full(n_tiers, 0.8)
    server_idx = server_init
    server_time = np.zeros(len(servers))
    server_busy = False

    heap: list = []
    seq = 0
    n_events = 0

    def push(t, kind, payload=None):
        nonlocal seq
        heapq.heappush(heap, (t, kind, seq, payload))
        seq += 1

    for i, dev in enumerate(devices):
        if dev.join_t > 0.0:
            dev.joined = False
            push(dev.join_t, EV_JOIN, i)
        else:
            # sample 0 starts when the device is present AND the sample
            # has arrived (saturated model: both are 0)
            push(max(dev.join_t, dev.arrival(0)) + dev.profile.latency,
                 EV_DEV, i)
        if np.isfinite(dev.leave_t):
            push(dev.leave_t, EV_LEAVE, i)
    push(window, EV_WINDOW, None)

    queue: deque = deque()    # (start_time, device_id, sample_idx)
    completed = 0
    last_t = 0.0
    timeline = {"t": [], "thresholds": [], "sr": [], "active": [],
                "accuracy": [], "server_idx": [], "forwarded": []}
    win_sr_last = np.full(n, 100.0)

    def record_completion(dev: DeviceRuntime, latency: float, correct: int):
        nonlocal completed
        met = latency <= dev.slo
        dev.met += met
        dev.win_met += met
        dev.win_total += 1
        dev.total += 1
        dev.correct += correct
        completed += 1

    def try_start_batch(t):
        nonlocal server_busy
        if server_busy or not queue:
            return
        prof = servers[server_idx]
        b = 1
        for x in BATCH_LADDER:
            if x <= min(len(queue), prof.max_batch):
                b = x
        batch = [queue.popleft() for _ in range(b)]
        scheduler.on_server_batch(b)
        lat = prof.batch_latency(b)
        server_time[server_idx] += lat
        server_busy = True
        push(t + lat, EV_SRV, (batch, server_idx))

    def on_device(t, i):
        dev = devices[i]
        if dev.cursor >= len(dev.stream):
            return
        if dev.departed:
            # lazy departure, as in the vectorized core: the would-be
            # completion past leave_t drops the rest of the stream (a
            # same-instant EV_LEAVE pops first, so a completion at
            # exactly leave_t is dropped in both simulators)
            dev.cursor = len(dev.stream)
            return
        if dev.offline_at is not None and dev.cursor >= dev.offline_at:
            dev.offline_at = None
            dev.active = False
            push(t + dev.offline_for, EV_ONLINE, i)
            return
        if dev.offline_during(t):
            # time-based offline: the completion fires when the device
            # returns; the sample is not dropped (jaxsim defer semantics)
            push(dev.offline_start_t + dev.offline_for_t, EV_DEV, i)
            return
        j = dev.cursor
        dev.cursor += 1
        if dev.stream.confidence[j] >= dev.threshold:  # Eq. 3: local
            record_completion(dev, dev.profile.latency,
                              int(dev.stream.correct_light[j]))
        else:
            dev.forwarded += 1
            queue.append((t - dev.profile.latency, i, j))
            # the launch attempt happens in the main loop once every
            # same-instant completion has enqueued (simultaneous arrivals
            # must form one batch, as in the vectorized core)
        if dev.cursor < len(dev.stream):
            push(max(t, dev.arrival(dev.cursor)) + dev.profile.latency,
                 EV_DEV, i)

    def on_online(t, i):
        dev = devices[i]
        dev.active = True
        if dev.cursor < len(dev.stream):
            push(max(t, dev.arrival(dev.cursor)) + dev.profile.latency,
                 EV_DEV, i)

    def on_join(t, i):
        dev = devices[i]
        dev.joined = True
        if dev.cursor < len(dev.stream):
            # scheduled even when already departed (join_t >= leave_t):
            # the orphan EV_DEV drops the stream on pop, exactly like
            # the vectorized core's lazy departure
            push(max(t, dev.arrival(dev.cursor)) + dev.profile.latency,
                 EV_DEV, i)

    def on_leave(t, i):
        # only the flag flips here; the pending in-flight completion
        # converts itself when it pops (lazy, as in the vectorized core)
        devices[i].departed = True

    def on_server(t, payload):
        nonlocal server_busy
        batch, sidx = payload
        server_busy = False
        for (start, i, j) in batch:
            dev = devices[i]
            record_completion(dev, t - start,
                              int(dev.stream.correct_heavy[j, sidx]))
        try_start_batch(t)

    def on_window(t):
        nonlocal server_idx
        # membership flags are flipped by EV_JOIN/EV_LEAVE, which beat
        # EV_WINDOW at equal timestamps — so this equals the vectorized
        # core's closed form join_t <= t_end < leave_t
        active = np.array([d.joined and not d.departed and d.active
                           and not d.offline_during(t) for d in devices])
        if hasattr(scheduler, "set_active"):
            scheduler.set_active(active)   # n_active drives Alg. 1 growth
        for i, dev in enumerate(devices):
            if not active[i]:
                continue
            sr = 100.0 if dev.win_total == 0 else \
                100.0 * dev.win_met / dev.win_total
            win_sr_last[i] = sr
            dev.win_met = 0
            dev.win_total = 0
            dev.threshold = scheduler.report(i, sr)
        if isinstance(scheduler, MultiTASC):
            scheduler.on_window(active=active)
            th = np.asarray(scheduler.thresholds())
            for i, dev in enumerate(devices):
                dev.threshold = float(th[i])
        if model_switching:
            th = np.array([d.threshold for d in devices], np.float32)
            s = int(switching.decide(
                th, np.asarray(tier_ids, np.int32), n_tiers,
                np.float32(c_lower), np.asarray(c_upper, np.float32),
                active=active))
            if s == -1 and server_idx > 0:
                server_idx -= 1     # faster model
            elif s == 1 and server_idx < len(servers) - 1:
                server_idx += 1     # heavier model
        timeline["t"].append(t)
        timeline["thresholds"].append([d.threshold for d in devices])
        timeline["sr"].append(win_sr_last.copy())
        timeline["active"].append(float(active.mean()))
        accs = [d.correct / d.total if d.total else 1.0 for d in devices]
        timeline["accuracy"].append(float(np.mean(accs)))
        timeline["server_idx"].append(server_idx)
        timeline["forwarded"].append(sum(d.forwarded for d in devices))

        if any(d.cursor < len(d.stream) for d in devices) or queue \
                or server_busy:
            push(t + window, EV_WINDOW, None)

    while heap:
        t, kind, _, payload = heapq.heappop(heap)
        if t > max_time:
            break
        last_t = max(last_t, t)
        n_events += 1

        if kind == EV_JOIN:
            on_join(t, payload)
        elif kind == EV_LEAVE:
            on_leave(t, payload)
        elif kind == EV_DEV:
            on_device(t, payload)
            # launch only after the whole same-instant completion cluster
            # has been processed: a fleet of identical-latency devices
            # forwarding at the same t forms ONE batch (the in-instant
            # order documented above), not a b=1 batch plus stragglers
            if not heap or heap[0][0] != t or heap[0][1] != EV_DEV:
                try_start_batch(t)
        elif kind == EV_ONLINE:
            on_online(t, payload)
        elif kind == EV_SRV:
            on_server(t, payload)
        elif kind == EV_WINDOW:
            on_window(t)

    per_sr = np.array([
        100.0 * d.met / d.total if d.total else 100.0 for d in devices])
    per_acc = np.array([
        d.correct / d.total if d.total else 1.0 for d in devices])
    total = sum(d.total for d in devices)
    fwd = sum(d.forwarded for d in devices)
    return SimResult(
        sr=float(100.0 * sum(d.met for d in devices) / max(total, 1)),
        accuracy=float(np.mean(per_acc)),
        throughput=float(total / max(last_t, 1e-9)),
        per_device_sr=per_sr,
        per_device_acc=per_acc,
        forwarded_frac=float(fwd / max(total, 1)),
        timeline=timeline,
        server_model_time=server_time,
        n_events=n_events,
        completed=int(total),
    )


# ---------------------------------------------------------------------------
# convenience harness used by benchmarks/tests
# ---------------------------------------------------------------------------
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
