"""The span recorder of the port's serving path
(``repro_torch.serving.spans``) on the CPU.

What must hold:

* off (the default), a span site records nothing and never reads a
  clock: every site below runs with the recorder's clock made to raise;
* spans nest per thread: each one's parent is the span open on its own
  thread, whatever other threads record meanwhile;
* on, a ``run_transport`` over a real model records, for every batch, one
  ``engine.execute`` with its four children under its batch id, the
  model's head inside the forward, and for every served request one
  ``queue.wait``;
* the recorder changes no result: the ``CascadeResult`` is the same with
  it on and off.

Every join in this file has a timeout.
"""
import collections
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.cascade_tiers import DEVICE_PROFILES, SERVER_PROFILES
from repro_torch.models.model import init_params
from repro_torch.serving import spans
from repro_torch.serving.client import DeviceClient
from repro_torch.serving.engine import ServedModel, ServerEngine
from repro_torch.serving.queue import Request, RequestQueue, request_key
from repro_torch.serving.transport import run_transport
from repro_torch.sim.events import make_scheduler

torch.set_num_threads(2)

JOIN = 60.0
N_DEV, N_SAMPLES = 4, 12


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off and empty."""
    spans.drain()
    yield
    spans.drain()


class _NoClock:
    """Stands in for the ``time`` module inside the recorder: any read of a
    clock fails the test."""

    def __getattr__(self, name):
        raise AssertionError(f"the recorder read time.{name} while off")


@pytest.fixture(scope="module")
def models():
    g = torch.Generator().manual_seed(0)
    return {name: init_params(cfg, g, device="cpu") for name, cfg in (
        ("tier-low", get_config("tier-low").with_(init_scale=0.5)),
        ("tier-server-fast", get_config("tier-server-fast")))}


def _cascade(models, max_in_flight=2):
    """A tiny live cascade through ``run_transport``: tier-low clients on
    the ingestion thread, tier-server-fast in the worker pool."""
    rng = np.random.default_rng(0)
    data = [[rng.integers(0, 2048, 16).astype(np.int32)
             for _ in range(N_SAMPLES)] for _ in range(N_DEV)]
    labels = [rng.integers(0, 2048, N_SAMPLES) for _ in range(N_DEV)]
    clients = [DeviceClient(i, models["tier-low"], DEVICE_PROFILES["low"],
                            0.15, 0.25, 0.5) for i in range(N_DEV)]
    engine = ServerEngine([ServedModel(
        "fast", models["tier-server-fast"], SERVER_PROFILES["inceptionv3"])],
        max_in_flight=max_in_flight)
    sched = make_scheduler("multitasc++", N_DEV,
                           server_profile=SERVER_PROFILES["inceptionv3"],
                           slo=0.15, init_threshold=0.5)
    return run_transport(clients, engine, sched, data, labels,
                         window=0.1), engine


def _assert_same_result(a, b):
    assert a.completed == b.completed and a.completed > 0
    for f in ("sr", "throughput", "forwarded_frac", "accuracy", "dropped",
              "switches", "queue_peak", "last_completion_t"):
        assert getattr(a, f) == getattr(b, f), f
    np.testing.assert_array_equal(a.per_device_sr, b.per_device_sr)
    np.testing.assert_array_equal(a.per_device_acc, b.per_device_acc)
    for k in ("t", "thresholds", "model", "active", "forwarded"):
        assert a.timeline[k] == b.timeline[k], k


# ---------------------------------------------------------------------------
# off: nothing recorded, no clock read
# ---------------------------------------------------------------------------
def _site_span(models):
    with spans.span("a", 1) as sp:
        assert sp is spans.OFF
        with spans.span("b", 2):
            pass


def _site_stamp_record(models):
    t0 = spans.stamp()
    assert t0 is None
    spans.record("w", t0, key=3)


def _site_queue(models):
    q = RequestQueue()
    for i in range(3):
        q.put(Request(i, None, 0.0, 0.0, payload=(i, None, 0)))
    assert all(r.put_ns is None for r in q.pop_batch(3))


def _site_cascade(models):
    _cascade(models)


SITES = {"span": _site_span, "stamp_record": _site_stamp_record,
         "queue": _site_queue, "cascade": _site_cascade}


@pytest.mark.parametrize("site", sorted(SITES))
def test_off_records_nothing_and_reads_no_clock(site, models, monkeypatch):
    monkeypatch.setattr(spans, "time", _NoClock())
    SITES[site](models)
    monkeypatch.undo()
    assert spans.drain().spans == []


def test_off_site_is_one_shared_object():
    assert spans.span("x") is spans.span("y", 7) is spans.OFF


# ---------------------------------------------------------------------------
# nesting and parents, per thread
# ---------------------------------------------------------------------------
def _nest(tag, barrier):
    with spans.span("outer", tag):
        barrier.wait(JOIN)
        with spans.span("mid", tag):
            t0 = spans.stamp()
            barrier.wait(JOIN)
            with spans.span("inner", tag):
                pass
            spans.record("wait", t0, tag)


@pytest.mark.parametrize("n_threads", [1, 4])
def test_nesting_and_parents_per_thread(n_threads):
    barrier = threading.Barrier(n_threads)
    spans.enable()
    threads = [threading.Thread(target=_nest, args=(k, barrier))
               for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN)
    assert not any(t.is_alive() for t in threads)
    out = spans.drain()
    assert len(out.spans) == 4 * n_threads
    by_id = {s.id: s for s in out.spans}
    assert len(by_id) == len(out.spans)
    for k in range(n_threads):
        mine = {s.name: s for s in out.spans if s.key == k}
        assert set(mine) == {"outer", "mid", "inner", "wait"}
        assert mine["outer"].parent == 0
        assert mine["mid"].parent == mine["outer"].id
        assert mine["inner"].parent == mine["mid"].id
        assert mine["wait"].parent == mine["mid"].id
        assert len({s.tid for s in mine.values()}) == 1
        for s in mine.values():
            assert s.start <= s.end
        assert mine["outer"].start <= mine["mid"].start \
            <= mine["wait"].start <= mine["inner"].start \
            <= mine["inner"].end <= mine["wait"].end \
            <= mine["mid"].end <= mine["outer"].end
    assert len({s.tid for s in out.spans}) == n_threads
    assert {s.tid for s in out.spans} <= set(out.threads)


def test_drain_hands_over_both_pairs_and_drops_open_spans():
    spans.enable((10, 20))
    with spans.span("closed"):
        pass
    open_span = spans.span("open")
    open_span.__enter__()
    out = spans.drain((30, 40))
    open_span.__exit__(None, None, None)
    assert [s.name for s in out.spans] == ["closed"]
    assert out.pairs == ((10, 20), (30, 40))
    spans.enable()
    assert spans.drain().spans == []
    assert spans.span("after") is spans.OFF


def test_threads_map_native_ids_to_idents():
    spans.enable()
    seen = {}

    def work():
        with spans.span("t"):
            seen[threading.get_native_id()] = threading.get_ident()

    t = threading.Thread(target=work)
    t.start()
    t.join(JOIN)
    assert not t.is_alive()
    out = spans.drain()
    for native, ident in seen.items():
        assert out.threads[native] == ident


def test_queue_wait_only_for_requests_put_and_popped_while_on():
    q = RequestQueue()
    q.put(Request(0, None, 0.0, 0.0, payload=(5, None, 0)))
    spans.enable()
    q.put(Request(1, None, 0.0, 0.0, payload=(6, None, 0)))
    q.put(Request(2, None, 0.0, 0.0, payload=(7, None, 0)))
    popped = q.pop_batch(2)
    out = spans.drain()
    q.pop_batch(1)
    assert [request_key(r) for r in popped] == [(0, 5), (1, 6)]
    waits = [s for s in out.spans if s.name == "queue.wait"]
    assert [s.key for s in waits] == [(1, 6)]


# ---------------------------------------------------------------------------
# on, through the transport
# ---------------------------------------------------------------------------
CHILDREN = ["engine.stack", "engine.copy_in", "engine.forward",
            "engine.copy_out"]


@pytest.mark.parametrize("slots", [1, 2])
def test_transport_records_every_batch_and_request(models, slots):
    spans.enable()
    _, engine = _cascade(models, max_in_flight=slots)
    out = spans.drain()
    by_id = {s.id: s for s in out.spans}
    names = collections.Counter(s.name for s in out.spans)
    n_batches = len(engine.batch_history)
    assert n_batches > 0
    execs = [s for s in out.spans if s.name == "engine.execute"]
    assert sorted(s.key for s in execs) == list(range(n_batches))
    for e in execs:
        kids = [s for s in out.spans if s.parent == e.id]
        assert [s.name for s in sorted(kids, key=lambda s: s.start)] \
            == CHILDREN
        assert all(s.key == e.key and s.tid == e.tid for s in kids)
        assert all(e.start <= s.start <= s.end <= e.end for s in kids)
    assert sorted(s.key for s in out.spans
                  if s.name == "transport.pool_wait") == list(range(n_batches))
    # each batch's forward holds the server's head; the clients' forwards
    # run in transport.cluster spans

    def ancestor(s, name):
        while s.parent:
            s = by_id[s.parent]
            if s.name == name:
                return s
        return None

    in_fwd = collections.Counter(s.name for s in out.spans
                                 if ancestor(s, "engine.forward"))
    assert in_fwd == {"model.head": n_batches}
    # every sample's local forward on the ingestion thread, inside the
    # transport.cluster span of its completion cluster
    local = [s for s in out.spans if s.name == "model.head"
             and not ancestor(s, "engine.forward")]
    assert len(local) == N_DEV * N_SAMPLES
    clusters = [s for s in out.spans if s.name == "transport.cluster"]
    for h in local:
        assert any(c.tid == h.tid and c.start <= h.start <= h.end <= c.end
                   for c in clusters)
    # one queue.wait per served request, ended on the dispatch thread
    waits = [s for s in out.spans if s.name == "queue.wait"]
    assert len(waits) == sum(engine.batch_history)
    assert len({s.key for s in waits}) == len(waits)
    assert {s.key for s in waits} <= {(i, j) for i in range(N_DEV)
                                      for j in range(N_SAMPLES)}
    dispatch = {s.tid for s in out.spans if s.name == "transport.wait_result"}
    assert len(dispatch) == 1
    for w in waits:
        assert w.tid in dispatch and w.parent == 0
        assert w.start <= w.end
    assert names["transport.wait_result"] == n_batches
    assert names["transport.barrier"] >= 1
    assert names["transport.cluster"] >= 1


@pytest.mark.parametrize("slots", [1, 2])
def test_result_is_the_same_with_the_recorder_on(models, slots):
    off, _ = _cascade(models, max_in_flight=slots)
    spans.enable()
    on, _ = _cascade(models, max_in_flight=slots)
    assert spans.drain().spans
    _assert_same_result(on, off)
