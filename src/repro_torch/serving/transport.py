"""Wall-clock async serving transport: overlapped ingestion and dispatch.

``run_cascade`` interleaves device-local inference and server batch
execution on one thread, so host batching idles while the card runs and
the other way round. This module runs the same cascade on threads so
that the two overlap, as the JAX package's ``serving/transport.py`` does:

* the **ingestion thread** owns the device-side event heap (EV_JOIN /
  EV_LEAVE / EV_DEV / EV_WINDOW): it runs device-local inference,
  buffers the forwards of each same-instant completion cluster, hands
  the cluster to the dispatch thread as one token, and runs
  ``window_step`` at each window barrier;
* the **dispatch thread** owns the engine: it merges cluster tokens with
  the pending-completion heap in virtual-time order, submits forwarded
  requests (shedding victims under backpressure), drains
  ``engine.step_begin`` into in-flight slots, and books completions;
* a **worker pool** of ``engine.max_in_flight`` threads runs
  ``engine.execute``, the forward on the served model's device, outside
  every lock.

Determinism: virtual timestamps ride with every token and completion,
and the dispatch thread replays them in the sequential loop's event
order (EV_DEV < EV_SRV < EV_WINDOW at equal instants: a pending
completion goes before a cluster token only when strictly earlier, and
before a window or cut token also at ties). Cluster tokens double as a
watermark: dispatch never books a completion until ingestion has passed
its finish time. Window boundaries are a barrier: dispatch parks
(``drained`` / ``resume``) while the ingestion thread runs
``window_step``, so the scheduler, the clients' thresholds and S(C) see a
quiescent engine. ``run_transport`` thus returns a ``CascadeResult``
equal to ``run_cascade``'s on the same inputs.

On the card the workers launch on the default stream of the served
model's device (``model.device``, an indexed device, never a bare
"cuda" resolved in the worker), so a batch's results do not depend on
which thread launched it. The kernel launch counters and the classify
cache are locked for the same reason (``kernels/ops.py``,
``serving/executables.py``).

While the span recorder is on (``serving/spans.py``) the threads record
where they wait and work: ``transport.cluster`` (ingestion: one
same-instant cluster's local inference up to its token being put),
``transport.barrier`` (dispatch, parked from the WINDOW token until
``resume``), ``transport.pool_wait`` (a batch from ``pool.submit`` to its
worker entering ``execute``, keyed by the batch id) and
``transport.wait_result`` (dispatch, blocked in ``fut.result()``).

Lock order: ``ServerEngine._lock -> RequestQueue._lock``;
``CascadeBook._lock`` and ``_Channel._lock`` are leaves. No code path
takes the engine lock while it holds any other.
"""
from __future__ import annotations

import heapq
import itertools
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np

from repro_torch.core import switching
from repro_torch.serving import spans
from repro_torch.serving.cascade import CascadeBook, CascadeResult, window_step
from repro_torch.serving.client import DeviceClient
from repro_torch.serving.engine import ServerEngine
from repro_torch.serving.queue import Request
from repro_torch.sim.events import EV_DEV, EV_JOIN, EV_LEAVE, EV_WINDOW

# token kinds on the ingestion -> dispatch channel: CLUSTER carries the
# forwarded requests of one same-instant device completion cluster (and
# is the virtual-time watermark), WINDOW parks dispatch at the barrier,
# CUT carries the max_time horizon on early termination
CLUSTER, WINDOW, CUT = "cluster", "window", "cut"


class _Channel:
    """FIFO token stream from the ingestion thread to the dispatch thread.
    Tokens are produced in nondecreasing virtual time, so FIFO order is
    virtual-time order. The lock is a leaf."""

    GUARDED_BY = {
        "_tokens": "_lock: put() produces, pop() consumes, head() peeks "
                   "under the condition",
        # _closed: close() alone sets it (under _lock), head() reads it
        # under the condition; one mutator, so it is not in the map
    }

    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._tokens: deque = deque()
        self._closed = False

    def put(self, t: float, kind: str, payload=None):
        with self._lock:
            self._tokens.append((t, kind, payload))
            self._cv.notify_all()

    def close(self):
        with self._lock:
            self._closed = True
            self._cv.notify_all()

    def head(self):
        """Block until a token is available or the channel is closed; the
        head token without consuming it (None: closed and drained)."""
        with self._lock:
            while not self._tokens and not self._closed:
                self._cv.wait()
            return self._tokens[0] if self._tokens else None

    def pop(self):
        with self._lock:
            return self._tokens.popleft()


def run_transport(clients: List[DeviceClient], engine: ServerEngine,
                  scheduler, datasets, labels=None, *,
                  window: float = 1.5, model_switching: bool = False,
                  tier_ids=None,
                  c_lower: float = switching.DEFAULT_C_LOWER,
                  c_upper=None, join_t=None, leave_t=None, arrive=None,
                  max_time: float = 3600.0) -> CascadeResult:
    """Drop-in for ``run_cascade`` (same signature, same
    ``CascadeResult``) that runs the wall-clock async transport."""
    n = len(clients)
    tier_ids = np.zeros(n, np.int32) if tier_ids is None \
        else np.asarray(tier_ids)
    n_tiers = int(tier_ids.max()) + 1
    if c_upper is None:
        c_upper = np.full(n_tiers, 0.8)
    join_t = np.zeros(n) if join_t is None \
        else np.asarray(join_t, np.float64)
    leave_t = (np.full(n, np.inf) if leave_t is None
               else np.asarray(leave_t, np.float64))

    def arrival(i: int, j: int) -> float:
        return 0.0 if arrive is None else float(arrive[i][j])

    book = CascadeBook(clients, have_labels=labels is not None)
    channel = _Channel()
    drained = threading.Event()    # dispatch -> ingestion: barrier reached
    resume = threading.Event()     # ingestion -> dispatch: window done
    errors: list = []              # the first exception of either thread
    pool = ThreadPoolExecutor(max_workers=engine.max_in_flight,
                              thread_name_prefix="accel")

    # ------------------------------------------------------------------
    # ingestion thread: device events, local inference, cluster tokens
    # ------------------------------------------------------------------
    def ingest():
        heap, seq = [], itertools.count()

        def push(t, kind, payload=None):
            heapq.heappush(heap, (t, kind, next(seq), payload))

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
        cluster: list = []         # forwards buffered for the open cluster
        cluster_t0 = None          # its spans.stamp()

        def on_device(t, i):
            if cursor[i] >= len(datasets[i]):
                return
            if departed[i]:
                cursor[i] = len(datasets[i])
                return
            j = cursor[i]
            cursor[i] += 1
            tokens = datasets[i][j]
            conf, pred, do_fwd = clients[i].run_local(tokens)
            label = labels[i][j] if labels is not None else None
            if do_fwd:
                book.fwd_count[i] += 1
                cluster.append(Request(
                    i, tokens, t, t - clients[i].profile.latency,
                    payload=(j, label, pred)))
            else:
                book.complete(i, clients[i].profile.latency, pred,
                              label, t)
            if cursor[i] < len(datasets[i]):
                push(max(t, arrival(i, cursor[i]))
                     + clients[i].profile.latency, EV_DEV, i)

        try:
            while heap:
                t, kind, _, payload = heapq.heappop(heap)
                if t > max_time:
                    channel.put(max_time, CUT, None)
                    break
                if kind == EV_JOIN:
                    joined[payload] = True
                    if cursor[payload] < len(datasets[payload]):
                        push(max(t, arrival(payload, cursor[payload]))
                             + clients[payload].profile.latency,
                             EV_DEV, payload)
                elif kind == EV_LEAVE:
                    departed[payload] = True
                elif kind == EV_DEV:
                    if cluster_t0 is None:
                        cluster_t0 = spans.stamp()
                    on_device(t, payload)
                    # hand the whole same-instant cluster over at once:
                    # simultaneous forwards form one batch
                    if not heap or heap[0][0] != t \
                            or heap[0][1] != EV_DEV:
                        channel.put(t, CLUSTER, cluster)
                        cluster = []
                        spans.record("transport.cluster", cluster_t0)
                        cluster_t0 = None
                elif kind == EV_WINDOW:
                    channel.put(t, WINDOW, None)
                    drained.wait()
                    drained.clear()
                    if errors:
                        break
                    window_step(
                        t, book=book, clients=clients, engine=engine,
                        scheduler=scheduler, active=joined & ~departed,
                        model_switching=model_switching,
                        tier_ids=tier_ids, n_tiers=n_tiers,
                        c_lower=c_lower, c_upper=c_upper)
                    more = any(cursor[i] < len(datasets[i])
                               for i in range(n)) \
                        or len(engine.queue) or engine.in_flight
                    if more:
                        push(t + window, EV_WINDOW, None)
                    resume.set()
        except BaseException as e:  # noqa: BLE001 (re-raised by the caller)
            errors.append(e)
        finally:
            channel.close()
            resume.set()           # never strand dispatch at a barrier

    # ------------------------------------------------------------------
    # dispatch thread: engine ownership, in-flight slots, completions
    # ------------------------------------------------------------------
    def dispatch():
        pending: list = []         # (finish, seq, future of the record)
        seq = itertools.count()

        def forward(rec, t_submit):
            """A worker's job: the batch's ``engine.execute``, after the
            span of its wait for the worker."""
            spans.record("transport.pool_wait", t_submit, rec["batch_id"])
            return engine.execute(rec)

        def drain(t):
            """Launch batches while the engine has free slots and the
            ladder admits one; the forwards go to the worker pool."""
            while True:
                rec = engine.step_begin(t)
                if rec is None:
                    return
                scheduler.on_server_batch(len(rec["requests"]))
                fut = pool.submit(forward, rec, spans.stamp())
                heapq.heappush(pending, (rec["finish"], next(seq), fut))

        def finish(f, fut):
            with spans.span("transport.wait_result"):
                out = fut.result()  # wall-clock wait on the forward
            engine.complete(out)
            for r, pred in zip(out["requests"], out["pred"]):
                j, label, _local = r.payload
                book.complete(r.device_id, f - r.start_time, int(pred),
                              label, f)
            drain(f)

        def completion_first(f, t_tok, kind) -> bool:
            # EV_DEV < EV_SRV < EV_WINDOW at equal instants: a pending
            # completion precedes a cluster only when strictly earlier,
            # and a window or cut boundary also at ties
            return f < t_tok if kind == CLUSTER else f <= t_tok

        try:
            while not errors:
                head = channel.head()
                if head is None:   # ingestion done: drain the tail
                    if not pending:
                        break
                    f, _, fut = heapq.heappop(pending)
                    if f > max_time:
                        break      # past the horizon, as in run_cascade
                    finish(f, fut)
                    continue
                t_tok, kind, payload = head
                if pending and completion_first(pending[0][0], t_tok,
                                                kind):
                    f, _, fut = heapq.heappop(pending)
                    finish(f, fut)
                    continue
                channel.pop()
                if kind == CLUSTER:
                    for req in payload:
                        victim = engine.submit(req)
                        if victim is not None:
                            book.drop(victim, t_tok, scheduler)
                    drain(t_tok)
                elif kind == WINDOW:
                    with spans.span("transport.barrier"):
                        resume.clear()
                        drained.set()
                        resume.wait()
                else:              # CUT: stop at the max_time horizon
                    break
        except BaseException as e:  # noqa: BLE001 (re-raised by the caller)
            errors.append(e)
        finally:
            drained.set()          # never strand ingestion at a barrier

    ti = threading.Thread(target=ingest, name="ingest")
    td = threading.Thread(target=dispatch, name="dispatch")
    ti.start()
    td.start()
    ti.join()
    td.join()
    pool.shutdown(wait=True)
    if errors:
        raise errors[0]
    return book.result(engine)
