"""Server request queue (paper Fig. 2, "Request queue") with backpressure.

FIFO staging area for forwarded samples. In-process deque standing in for
the paper's AMQP broker; semantics preserved (FIFO order, timestamped
entries, result-distribution callbacks carried with the request) — plus a
bounded-capacity mode the paper's broker would enforce physically:

* ``capacity=None`` (default): unbounded, the legacy behaviour.
* ``capacity=K, policy="reject"``: an arriving request that would exceed
  K is refused admission (returned to the caller, who falls back to the
  device's local prediction — admission control at the broker).
* ``capacity=K, policy="shed_oldest"``: the *oldest* queued request is
  displaced to admit the new one (bounded staleness: under overload the
  queue serves the freshest work; the shed request is returned to the
  caller for local fallback).

``put`` returns the displaced request (the new one under ``reject``, the
evicted head under ``shed_oldest``) or ``None`` when admission needed no
drop, so the serving loop can surface every drop to the scheduler and
complete the victim with its device-local result. Drop/peak counters
(``n_rejected``/``n_shed``/``peak``) ride the queue for the engine's
backpressure telemetry.

While the span recorder (``serving/spans.py``) is on, ``put`` stamps a
request's arrival and ``pop_batch`` records its ``queue.wait`` span,
keyed by ``request_key``.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Any, Optional

from repro_torch.serving import spans

POLICIES = ("reject", "shed_oldest")


@dataclasses.dataclass
class Request:
    device_id: int
    sample: Any                  # model input (e.g. token array)
    enqueue_time: float
    start_time: float            # when on-device inference began
    payload: Any = None          # opaque (e.g. sample index, label)
    put_ns: Optional[int] = None  # put's spans.stamp(), while recording


def request_key(req: Request) -> tuple:
    """(device id, sample): the serving loops' payloads lead with the
    sample's index."""
    p = req.payload
    return req.device_id, p[0] if isinstance(p, tuple) else p


class RequestQueue:
    # Lock map: the deque is mutated by producers (put) and the
    # dispatcher (pop_batch, under the engine lock). ``_lock`` is a leaf
    # in the lock order engine -> queue: it never calls out while held.
    GUARDED_BY = {
        "_q": "_lock: put() appends/sheds, pop_batch() drains",
    }

    def __init__(self, capacity: Optional[int] = None,
                 policy: str = "reject"):
        if capacity is not None and capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES},"
                             f" got {policy!r}")
        self.capacity = capacity
        self.policy = policy
        self.n_rejected = 0      # arrivals refused admission ("reject")
        self.n_shed = 0          # queued heads displaced ("shed_oldest")
        self.peak = 0            # realized high-water mark
        self._lock = threading.Lock()
        self._q: deque[Request] = deque()

    def put(self, req: Request) -> Optional[Request]:
        """Admit ``req``; returns the dropped request under backpressure
        (``req`` itself when rejecting, the displaced head when
        shedding) or ``None`` when nothing was dropped. Linearizable:
        the capacity check and the append/shed are one atomic section,
        so concurrent producers can neither oversubscribe the bound nor
        shed the same head twice."""
        req.put_ns = spans.stamp()
        with self._lock:
            if self.capacity is not None and len(self._q) >= self.capacity:
                if self.policy == "reject":
                    self.n_rejected += 1
                    return req
                dropped = self._q.popleft()
                self.n_shed += 1
                self._q.append(req)
                return dropped
            self._q.append(req)
            self.peak = max(self.peak, len(self._q))
            return None

    def pop_batch(self, max_n: int) -> list[Request]:
        with self._lock:
            n = min(max_n, len(self._q))
            out = [self._q.popleft() for _ in range(n)]
        if spans.on():
            for r in out:
                spans.record("queue.wait", r.put_ns, request_key(r))
        return out

    def __len__(self) -> int:
        return len(self._q)
