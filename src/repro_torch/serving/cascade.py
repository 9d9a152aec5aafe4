"""End-to-end live cascade orchestrator.

Wires N DeviceClients (real light-model logits), the ServerEngine (real
heavy-model logits, continuous dynamic batching, model switching) and a
scheduler (MultiTASC++/MultiTASC/Static) into the closed loop of
Fig. 2/3, driven by a deterministic virtual clock (event heap) with the
reference simulator's event taxonomy (EV_JOIN < EV_LEAVE < EV_DEV <
EV_SRV < EV_WINDOW at equal timestamps). The logits come from the
models' forwards on their device; the clock comes from the paper's
latency profiles, so ``throughput`` is a virtual-clock figure, not a
measurement of the device.

Semantics, as in the JAX package's ``serving/cascade.py``:

* dispatch happens after the whole same-instant completion cluster has
  enqueued (simultaneous forwards form ONE batch) and drains as many
  batches as the engine has free slots;
* throughput divides by the last completion time;
* empty devices report SR 100 / accuracy 1.0;
* device churn (``join_t``/``leave_t``) and non-stationary arrivals
  (``arrive``): a join delays the first sample, a leave lazily drops the
  unprocessed stream at the first would-be completion past ``leave_t``
  (in-flight server requests still complete), sample ``j`` starts at
  ``max(previous finish, arrive[j])``;
* a bounded engine queue sheds under backpressure: the dropped request
  completes with the device-local prediction it already computed, and
  ``scheduler.on_queue_drop(device_id)`` fires when the scheduler
  defines it.
"""
from __future__ import annotations

import dataclasses
import heapq
import threading
from typing import Dict, List

import numpy as np

from repro_torch.core import switching
from repro_torch.core.multitasc import MultiTASC
from repro_torch.serving.client import DeviceClient
from repro_torch.serving.engine import ServerEngine
from repro_torch.serving.queue import Request
from repro_torch.sim.events import EV_DEV, EV_JOIN, EV_LEAVE, EV_SRV, EV_WINDOW


@dataclasses.dataclass
class CascadeResult:
    sr: float                      # overall SLO satisfaction rate [0,100]
    accuracy: float                # mean per-device accuracy (NaN w/o labels)
    throughput: float              # completed samples / last completion (s)
    forwarded_frac: float
    per_device_sr: np.ndarray
    per_device_acc: np.ndarray
    timeline: Dict[str, list]
    switches: int
    completed: int                 # samples that finished (local or server)
    dropped: int                   # requests shed/rejected by the queue
    queue_peak: int                # realized queue high-water mark
    last_completion_t: float


class CascadeBook:
    """Completion/metric bookkeeping of the virtual-clock loop.

    Thread-safe: every counter update runs under ``_lock``, a leaf lock
    (no other lock is acquired while holding it), so completions may
    arrive from more than one thread.
    """

    GUARDED_BY = {
        "win_met": "_lock: complete() accrues, window_sr() resets",
        "win_total": "_lock: complete() accrues, window_sr() resets",
    }

    def __init__(self, clients: List[DeviceClient], have_labels: bool):
        n = len(clients)
        self._lock = threading.Lock()
        self.clients = clients
        self.have_labels = have_labels
        self.met = np.zeros(n, int)
        self.total = np.zeros(n, int)
        self.correct = np.zeros(n, int)
        self.win_met = np.zeros(n, int)
        self.win_total = np.zeros(n, int)
        self.fwd_count = np.zeros(n, int)
        self.drop_count = np.zeros(n, int)
        self.completed = 0
        self.switches = 0
        self.last_done_t = 0.0
        self.win_sr_last = np.full(n, 100.0)
        self.timeline: Dict[str, list] = {
            "t": [], "thresholds": [], "model": [], "sr": [],
            "active": [], "forwarded": []}

    def complete(self, i: int, latency: float, pred, label, t: float):
        with self._lock:
            self.clients[i].record_completion(latency)
            ok = latency <= self.clients[i].slo
            self.met[i] += ok
            self.win_met[i] += ok
            self.total[i] += 1
            self.win_total[i] += 1
            self.completed += 1
            self.last_done_t = max(self.last_done_t, t)
            if label is not None:
                self.correct[i] += int(pred == label)

    def drop(self, req: Request, t: float, scheduler=None):
        """Backpressure fallback: the queue's victim completes with the
        local prediction its device already computed."""
        j, label, local_pred = req.payload
        self.drop_count[req.device_id] += 1
        self.complete(req.device_id, t - req.start_time, local_pred,
                      label, t)
        hook = getattr(scheduler, "on_queue_drop", None)
        if hook is not None:
            hook(req.device_id)

    def window_sr(self, i: int) -> float:
        """Read-and-reset device ``i``'s window SLO rate (one window
        boundary's worth of completions)."""
        with self._lock:
            sr = 100.0 if self.win_total[i] == 0 else \
                100.0 * self.win_met[i] / self.win_total[i]
            self.win_sr_last[i] = sr
            self.win_met[i] = 0
            self.win_total[i] = 0
        return sr

    def result(self, engine: ServerEngine) -> CascadeResult:
        n = len(self.clients)
        met, total, correct = self.met, self.total, self.correct
        per_sr = np.where(total > 0,
                          100.0 * met / np.maximum(total, 1), 100.0)
        per_acc = np.where(total > 0,
                           correct / np.maximum(total, 1), 1.0)
        return CascadeResult(
            sr=float(100.0 * met.sum() / max(total.sum(), 1)),
            accuracy=(float(per_acc.mean()) if self.have_labels
                      else float("nan")),
            throughput=float(total.sum() / max(self.last_done_t, 1e-9)),
            forwarded_frac=float(self.fwd_count.sum()
                                 / max(total.sum(), 1)),
            per_device_sr=per_sr,
            per_device_acc=(per_acc if self.have_labels
                            else np.full(n, np.nan)),
            timeline=self.timeline,
            switches=self.switches,
            completed=int(self.completed),
            dropped=int(self.drop_count.sum()),
            queue_peak=int(engine.queue.peak),
            last_completion_t=float(self.last_done_t),
        )


def window_step(t: float, *, book: CascadeBook,
                clients: List[DeviceClient], engine: ServerEngine,
                scheduler, active: np.ndarray, model_switching: bool,
                tier_ids, n_tiers: int, c_lower: float, c_upper) -> None:
    """One window boundary — scheduler reports, MultiTASC batch update,
    the switching decision S(C), and the timeline row."""
    if hasattr(scheduler, "set_active"):
        scheduler.set_active(active)
    for i, c in enumerate(clients):
        if not active[i]:
            continue
        c.threshold = scheduler.report(i, book.window_sr(i))
    if isinstance(scheduler, MultiTASC):
        scheduler.on_window(active=active)
        th = np.asarray(scheduler.thresholds())
        for i, c in enumerate(clients):
            c.threshold = float(th[i])
    if model_switching:
        th = np.array([c.threshold for c in clients], np.float32)
        s = int(switching.decide(
            th, np.asarray(tier_ids, np.int32), n_tiers,
            np.float32(c_lower), np.asarray(c_upper, np.float32),
            active=active))
        if s != 0 and engine.switch(s):
            book.switches += 1
    tl = book.timeline
    tl["t"].append(t)
    tl["thresholds"].append([c.threshold for c in clients])
    tl["model"].append(engine.active.name)
    tl["sr"].append(book.win_sr_last.copy())
    tl["active"].append(float(active.mean()))
    tl["forwarded"].append(int(book.fwd_count.sum()))


def run_cascade(clients: List[DeviceClient], engine: ServerEngine,
                scheduler, datasets, labels=None, *, window: float = 1.5,
                model_switching: bool = False, tier_ids=None,
                c_lower: float = switching.DEFAULT_C_LOWER, c_upper=None,
                join_t=None, leave_t=None, arrive=None,
                max_time: float = 3600.0) -> CascadeResult:
    """datasets: per-device list of samples (e.g. (S,) token arrays).

    labels: optional per-device list of int labels — when given, accuracy
    is measured against them; otherwise accuracy is NaN.
    join_t / leave_t: optional (n,) churn schedule in seconds (fleet
    membership on [join_t, leave_t), scenario semantics above).
    arrive: optional per-device (S,) cumulative arrival times in seconds
    (list of arrays or (n, S) array); None = saturated streams.
    """
    n = len(clients)
    tier_ids = np.zeros(n, np.int32) if tier_ids is None else np.asarray(tier_ids)
    n_tiers = int(tier_ids.max()) + 1
    if c_upper is None:
        c_upper = np.full(n_tiers, 0.8)
    join_t = np.zeros(n) if join_t is None else np.asarray(join_t, np.float64)
    leave_t = (np.full(n, np.inf) if leave_t is None
               else np.asarray(leave_t, np.float64))

    def arrival(i: int, j: int) -> float:
        return 0.0 if arrive is None else float(arrive[i][j])

    heap, seq = [], 0

    def push(t, kind, payload=None):
        nonlocal seq
        heapq.heappush(heap, (t, kind, seq, payload))
        seq += 1

    joined = join_t <= 0.0
    departed = np.zeros(n, bool)
    for i, c in enumerate(clients):
        if joined[i]:
            push(max(join_t[i], arrival(i, 0)) + c.profile.latency,
                 EV_DEV, i)
        else:
            push(join_t[i], EV_JOIN, i)
        if np.isfinite(leave_t[i]):
            push(leave_t[i], EV_LEAVE, i)
    push(window, EV_WINDOW, None)

    cursor = np.zeros(n, int)
    book = CascadeBook(clients, have_labels=labels is not None)

    def dispatch(t):
        """Drain: launch batches while the engine has free slots and the
        ladder admits one (the engine refuses past its capacity)."""
        while True:
            out = engine.step(t)
            if out is None:
                return
            scheduler.on_server_batch(len(out["requests"]))
            push(out["finish"], EV_SRV, out)

    def on_device(t, i):
        if cursor[i] >= len(datasets[i]):
            return
        if departed[i]:
            # lazy departure (scenario semantics): the would-be
            # completion past leave_t drops the rest of the stream
            cursor[i] = len(datasets[i])
            return
        j = cursor[i]
        cursor[i] += 1
        tokens = datasets[i][j]
        conf, pred, do_fwd = clients[i].run_local(tokens)
        label = labels[i][j] if labels is not None else None
        if do_fwd:
            book.fwd_count[i] += 1
            victim = engine.submit(Request(
                i, tokens, t, t - clients[i].profile.latency,
                payload=(j, label, pred)))
            if victim is not None:
                book.drop(victim, t, scheduler)
        else:
            book.complete(i, clients[i].profile.latency, pred, label, t)
        if cursor[i] < len(datasets[i]):
            push(max(t, arrival(i, cursor[i])) + clients[i].profile.latency,
                 EV_DEV, i)

    def on_server(t, out):
        engine.complete(out)
        for r, pred in zip(out["requests"], out["pred"]):
            j, label, _local = r.payload
            book.complete(r.device_id, t - r.start_time, int(pred),
                          label, t)
        dispatch(t)

    def on_window(t):
        window_step(t, book=book, clients=clients, engine=engine,
                    scheduler=scheduler, active=joined & ~departed,
                    model_switching=model_switching, tier_ids=tier_ids,
                    n_tiers=n_tiers, c_lower=c_lower, c_upper=c_upper)
        if any(cursor[i] < len(datasets[i]) for i in range(n)) \
                or len(engine.queue) or engine.in_flight:
            push(t + window, EV_WINDOW, None)

    while heap:
        t, kind, _, payload = heapq.heappop(heap)
        if t > max_time:
            break
        if kind == EV_JOIN:
            joined[payload] = True
            if cursor[payload] < len(datasets[payload]):
                push(max(t, arrival(payload, cursor[payload]))
                     + clients[payload].profile.latency, EV_DEV, payload)
        elif kind == EV_LEAVE:
            departed[payload] = True
        elif kind == EV_DEV:
            on_device(t, payload)
            # launch only after the whole same-instant completion
            # cluster has enqueued: simultaneous forwards form one batch
            if not heap or heap[0][0] != t or heap[0][1] != EV_DEV:
                dispatch(t)
        elif kind == EV_SRV:
            on_server(t, payload)
        elif kind == EV_WINDOW:
            on_window(t)

    return book.result(engine)
