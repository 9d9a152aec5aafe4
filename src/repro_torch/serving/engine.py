"""Server engine: continuous-batching inference over the shared heavy
model(s).

Hosts one or more server models (paper Sec. IV-E model switching keeps
all candidates resident; switching changes which model is dispatched —
no weight reload). Pulls ladder-bucketed batches from the request queue,
runs the classification forward (next-token logits of the last position
as the label distribution) on the served model's device, and returns
per-sample (prediction, confidence) as numpy arrays.

Up to ``max_in_flight`` dispatched batches may be outstanding at once.
``step(now)`` dispatches at most one batch and returns its completion
record; the caller hands the record back through ``complete`` at its
``finish`` time, freeing the slot. ``step`` refuses to dispatch while
every slot is occupied.

While the span recorder is on (``serving/spans.py``), ``execute``
records ``engine.execute`` with its children
``engine.stack``, ``engine.copy_in`` (the blocking copy to the card),
``engine.forward`` (the host time in which the classify function launches
its kernels) and ``engine.copy_out`` (the two reads back, which wait for
the card), all keyed by the batch id.

Latency accounting is virtual: the calibrated ``ServerProfile`` latency
curve gives each batch's duration, while the logits are real.

A ``ServedModel`` may instead carry an ``oracle`` callable
(``(requests) -> (conf, pred) arrays``) and no model, which replays
confidences through the same queue/bucket/capacity machinery.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.cascade_tiers import ServerProfile
from repro_torch.models.model import Model
from repro_torch.serving import spans
from repro_torch.serving.batching import pick_bucket
from repro_torch.serving.executables import classify_fn
from repro_torch.serving.queue import Request, RequestQueue


@dataclasses.dataclass
class ServedModel:
    name: str
    model: Optional[Model]
    profile: ServerProfile
    # replay mode: host-side (requests) -> (conf (n,), pred (n,)) oracle
    # standing in for the model forward (None = real model)
    oracle: Optional[Callable] = None


class ServerEngine:
    """Batched cascade server: bounded queue, in-flight slot tracking,
    ladder-bucket dispatch, model switching.

    ``step_begin`` (slot + batch assembly) and ``complete`` hold ``_lock``
    for their whole critical section, so a slot is acquired and released
    exactly once per batch id. ``execute`` (the forward) takes no lock.
    Lock order: ``ServerEngine._lock`` -> ``RequestQueue._lock``.
    """

    GUARDED_BY = {
        "in_flight": "_lock: step_begin() acquires a slot, complete()"
                     " releases it",
        "_open": "_lock: step_begin() registers a batch id, complete()"
                 " retires it",
    }

    def __init__(self, served: Sequence[ServedModel], confidence="bvsb",
                 *, max_in_flight: int = 1,
                 queue: Optional[RequestQueue] = None):
        if max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        self.served = list(served)
        self.active_idx = 0
        self.queue = RequestQueue() if queue is None else queue
        self.confidence = confidence
        self.max_in_flight = int(max_in_flight)
        self.in_flight = 0
        self.batch_history: List[int] = []
        self._lock = threading.Lock()
        self._batch_ids = itertools.count()
        self._open: set = set()

    # -- model switching ---------------------------------------------------
    @property
    def active(self) -> ServedModel:
        return self.served[self.active_idx]

    def switch(self, direction: int) -> bool:
        """-1 => faster model (lower index), +1 => heavier. Returns True
        if a switch happened."""
        new = min(max(self.active_idx + direction, 0), len(self.served) - 1)
        changed = new != self.active_idx
        self.active_idx = new
        return changed

    # -- admission ----------------------------------------------------------
    def submit(self, req: Request) -> Optional[Request]:
        """Enqueue; under a bounded queue returns the dropped request
        (see ``RequestQueue.put``) for the caller's local fallback."""
        return self.queue.put(req)

    # -- dispatch / completion ----------------------------------------------
    @property
    def slots_free(self) -> int:
        return self.max_in_flight - self.in_flight

    def step_begin(self, now: float) -> Optional[dict]:
        """Acquire a slot and assemble one dynamic batch — no forward.
        None when the queue is idle or every slot is busy."""
        with self._lock:
            if self.in_flight >= self.max_in_flight:
                return None
            sm = self.active
            bucket = pick_bucket(len(self.queue), sm.profile.max_batch)
            if bucket == 0:
                return None
            reqs = self.queue.pop_batch(bucket)
            self.batch_history.append(len(reqs))
            lat = sm.profile.batch_latency(bucket)
            self.in_flight += 1
            bid = next(self._batch_ids)
            self._open.add(bid)
            return {
                "requests": reqs,
                "bucket": bucket,
                "conf": None,
                "pred": None,
                "latency": lat,
                "finish": now + lat,
                "model": sm.name,
                "batch_id": bid,
                "_served": sm,
            }

    def execute(self, record: dict) -> dict:
        """Run the forward for a dispatched record, filling ``conf`` /
        ``pred`` (numpy). The served model is pinned at dispatch time, so
        a later ``switch`` never retargets an in-flight batch."""
        sm = record.pop("_served")
        reqs = record["requests"]
        bid = record["batch_id"]
        with spans.span("engine.execute", bid):
            if sm.oracle is not None:
                conf, pred = sm.oracle(reqs)
                conf, pred = np.asarray(conf), np.asarray(pred)
            else:
                with spans.span("engine.stack", bid):
                    rows = np.stack([np.asarray(r.sample) for r in reqs])
                with spans.span("engine.copy_in", bid):
                    batch = torch.as_tensor(rows, device=sm.model.device)
                fn = classify_fn(sm.model, record["bucket"], self.confidence)
                with spans.span("engine.forward", bid):
                    conf, pred = fn(sm.model, batch)
                with spans.span("engine.copy_out", bid):
                    conf, pred = conf.cpu().numpy(), pred.cpu().numpy()
        record["conf"] = conf[:len(reqs)]
        record["pred"] = pred[:len(reqs)]
        return record

    def step(self, now: float) -> Optional[dict]:
        """``step_begin`` + ``execute``: dispatch one dynamic batch if a
        slot is free and the ladder admits one; None otherwise.

        Returns {"requests", "conf", "pred", "latency", "finish",
        "model", "batch_id", "bucket"}; the caller hands the record back
        via ``complete`` once its ``finish`` time is reached.
        """
        record = self.step_begin(now)
        if record is None:
            return None
        return self.execute(record)

    def complete(self, out: dict) -> None:
        """Mark a dispatched batch finished, freeing its slot. Each record
        completes exactly once (a second call raises)."""
        bid = out["batch_id"]
        with self._lock:
            if bid not in self._open:
                raise ValueError(f"batch {bid} is not in flight")
            self._open.remove(bid)
            self.in_flight -= 1
