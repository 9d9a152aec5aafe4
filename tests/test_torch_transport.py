"""The port's async serving transport (``repro_torch.serving.transport``)
on the CPU.

What must hold, each case a port of tests/test_transport.py:

* ``run_transport`` returns a ``CascadeResult`` exactly equal to the
  port's ``run_cascade`` on the same scenario (every field, the timeline's
  times, thresholds and models): steady / churn x three schedulers,
  switching with four in-flight slots, a shedding queue, and the live
  tier models themselves;
* the port's ``run_transport`` exactly equals the JAX package's
  ``run_transport`` on the same oracle scenarios;
* engine and queue stay linearizable under threads, ``on_queue_drop``
  fires once per victim, and a worker's exception leaves
  ``run_transport`` instead of stranding a barrier;
* host and accelerator overlap, shown by a witness (``threading.Event``
  records a device-local inference while a server forward is in
  flight), not by a wall-clock ratio;
* the kernels' launch counters and the classify cache's counters lose no
  increment under eight threads.

Every wait and join in this file has a timeout.
"""
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.configs import scenarios as jscenarios
from repro.configs.cascade_tiers import ServerProfile as JServerProfile
from repro.serving.queue import RequestQueue as JRequestQueue
from repro.serving.replay import replay_cascade as jreplay_cascade
from repro.sim import synthetic as jsynthetic
from repro_torch.configs import get_config
from repro_torch.configs.cascade_tiers import (DEVICE_PROFILES,
                                               SERVER_PROFILES, ServerProfile)
from repro_torch.kernels import _build, ops
from repro_torch.models.model import init_params
from repro_torch.serving import executables
from repro_torch.serving.cascade import run_cascade
from repro_torch.serving.client import DeviceClient
from repro_torch.serving.engine import ServedModel, ServerEngine
from repro_torch.serving.queue import Request, RequestQueue
from repro_torch.serving.replay import StreamClient, _oracle, replay_cascade
from repro_torch.serving.transport import run_transport
from repro_torch.sim.events import make_scheduler

torch.set_num_threads(2)

N, S, SEED = 10, 80, 11
SLO, BASE_LAT = 0.16, 0.06
SERVERS = (ServerProfile("tx-fast", "synthetic", 0.90, 0.045, 16),
           ServerProfile("tx-heavy", "synthetic", 0.94, 0.070, 16))
J_SERVERS = tuple(JServerProfile(p.name, p.model, p.accuracy,
                                 p.base_latency, p.max_batch)
                  for p in SERVERS)
JOIN = 60.0        # seconds any thread of a test may take before it fails


def _scenario(name):
    """tests/test_transport.py's scenario, made with the JAX package's own
    generators (the port's equal them, tests/test_torch_sim.py)."""
    streams = jsynthetic.device_streams(N, S, 0.70, [0.90, 0.94], SEED)
    rng = np.random.default_rng(2)
    lat = (BASE_LAT * rng.uniform(0.9, 1.1, N)).astype(np.float32)
    r = jscenarios.realize(jscenarios.SCENARIOS[name], [SEED], N, S, lat)
    st = dict(streams)
    if r["arrive"] is not None:
        st["arrive"] = r["arrive"][0]
    return st, lat, r["join_t"][0], r["leave_t"][0]


def _replay(replay, servers, scn, sched, transport, **kw):
    st, lat, join_t, leave_t = _scenario(scn)
    return replay(sched, st, lat, np.full(N, SLO, np.float32), servers,
                  join_t=join_t, leave_t=leave_t, transport=transport, **kw)


def assert_results_equal(a, b):
    assert a.completed == b.completed and a.completed > 0
    for f in ("sr", "throughput", "forwarded_frac", "accuracy", "dropped",
              "switches", "queue_peak", "last_completion_t"):
        assert getattr(a, f) == getattr(b, f), f
    np.testing.assert_array_equal(a.per_device_sr, b.per_device_sr)
    np.testing.assert_array_equal(a.per_device_acc, b.per_device_acc)
    for k in ("t", "thresholds", "model", "active", "forwarded"):
        assert a.timeline[k] == b.timeline[k], k
    assert len(a.timeline["sr"]) == len(b.timeline["sr"])
    for x, y in zip(a.timeline["sr"], b.timeline["sr"]):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# determinism: the transport gives run_cascade's result
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sched", ["static", "multitasc", "multitasc++"])
@pytest.mark.parametrize("scn", ["steady", "churn"])
def test_async_equals_sync(scn, sched):
    assert_results_equal(
        _replay(replay_cascade, SERVERS, scn, sched, "async"),
        _replay(replay_cascade, SERVERS, scn, sched, "event"))


def test_async_equals_sync_switching_and_slots():
    """Churn + drift + model switching + 4 in-flight slots."""
    kw = dict(model_switching=True, max_in_flight=4)
    a = _replay(replay_cascade, SERVERS, "churn_drift", "multitasc++",
                "async", **kw)
    assert_results_equal(a, _replay(replay_cascade, SERVERS, "churn_drift",
                                    "multitasc++", "event", **kw))


def test_async_equals_sync_under_shedding():
    """A tiny shedding queue: victims complete with their local prediction
    on the dispatch thread, and the drop accounting stays exact."""
    out = [_replay(replay_cascade, SERVERS, "steady", "multitasc++", t,
                   queue=RequestQueue(capacity=2, policy="shed_oldest"))
           for t in ("async", "event")]
    assert out[0].dropped > 0
    assert_results_equal(*out)


def test_async_equals_sync_with_the_tier_models():
    """The live path itself: tier-low clients and the two tier servers on
    the CPU, their forwards in the worker pool (two slots)."""
    g = torch.Generator().manual_seed(0)
    models = {name: init_params(cfg, g, device="cpu") for name, cfg in (
        ("tier-low", get_config("tier-low").with_(init_scale=0.5)),
        ("tier-server-fast", get_config("tier-server-fast")))}
    rng = np.random.default_rng(0)
    data = [[rng.integers(0, 2048, 16).astype(np.int32) for _ in range(12)]
            for _ in range(4)]
    labels = [rng.integers(0, 2048, 12) for _ in range(4)]
    results = []
    for run in (run_transport, run_cascade):
        clients = [DeviceClient(i, models["tier-low"],
                                DEVICE_PROFILES["low"], 0.15, 0.25, 0.5)
                   for i in range(4)]
        engine = ServerEngine([ServedModel(
            "fast", models["tier-server-fast"],
            SERVER_PROFILES["inceptionv3"])], max_in_flight=2)
        sched = make_scheduler("multitasc++", 4,
                               server_profile=SERVER_PROFILES["inceptionv3"],
                               slo=0.15, init_threshold=0.5)
        results.append(run(clients, engine, sched, data, labels,
                           window=0.1))
    assert 0 < results[0].forwarded_frac < 1
    assert len(results[0].timeline["t"]) > 2
    assert_results_equal(*results)


# ---------------------------------------------------------------------------
# the port's transport against the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sched", ["static", "multitasc", "multitasc++"])
@pytest.mark.parametrize("scn", ["steady", "churn", "churn_drift"])
def test_async_equals_the_reference(scn, sched):
    assert_results_equal(
        _replay(replay_cascade, SERVERS, scn, sched, "async"),
        _replay(jreplay_cascade, J_SERVERS, scn, sched, "async"))


@pytest.mark.parametrize("path", ["switching-slots", "shedding"])
def test_async_deep_paths_equal_the_reference(path):
    outs = []
    for replay, servers, queue_cls in (
            (replay_cascade, SERVERS, RequestQueue),
            (jreplay_cascade, J_SERVERS, JRequestQueue)):
        if path == "shedding":
            scn, kw = "steady", dict(queue=queue_cls(capacity=2,
                                                     policy="shed_oldest"))
        else:
            scn, kw = "churn_drift", dict(model_switching=True,
                                          max_in_flight=4)
        outs.append(_replay(replay, servers, scn, "multitasc++", "async",
                            **kw))
    assert_results_equal(*outs)
    assert outs[0].dropped > 0 or path != "shedding"


# ---------------------------------------------------------------------------
# threaded stress: engine and queue linearizability
# ---------------------------------------------------------------------------
def _stress_engine(max_in_flight):
    profile = ServerProfile("stress", "synthetic", 0.9, 1e-4, 8)

    def oracle(reqs):
        return np.ones(len(reqs), np.float32), np.ones(len(reqs), np.int32)

    return ServerEngine([ServedModel("stress", None, profile, oracle=oracle)],
                        max_in_flight=max_in_flight)


def _run_threads(threads):
    for th in threads:
        th.start()
    for th in threads:
        th.join(JOIN)
    assert not any(th.is_alive() for th in threads)


def test_stress_engine_step_complete():
    """8 producers and 8 dispatchers hammer submit / step / complete: every
    request completes exactly once, the slot bound holds, no batch
    completes twice."""
    engine = _stress_engine(max_in_flight=3)
    n_threads, per_thread = 8, 200
    done, over = [], []
    done_lock = threading.Lock()
    stop = threading.Event()

    def produce(k):
        for j in range(per_thread):
            engine.submit(Request(k, j, 0.0, 0.0))

    def dispatch():
        deadline = time.monotonic() + JOIN
        while (not stop.is_set() or len(engine.queue)) \
                and time.monotonic() < deadline:
            out = engine.step(0.0)
            if out is None:
                time.sleep(1e-4)
                continue
            if engine.in_flight > engine.max_in_flight:
                over.append(engine.in_flight)
            got = [(r.device_id, r.sample) for r in out["requests"]]
            engine.complete(out)
            with done_lock:
                done.extend(got)

    producers = [threading.Thread(target=produce, args=(k,))
                 for k in range(n_threads)]
    dispatchers = [threading.Thread(target=dispatch) for _ in range(8)]
    for th in dispatchers:
        th.start()
    _run_threads(producers)
    stop.set()
    for th in dispatchers:
        th.join(JOIN)
    assert not any(th.is_alive() for th in dispatchers)
    assert not over and engine.in_flight == 0
    expected = {(k, j) for k in range(n_threads) for j in range(per_thread)}
    assert len(done) == len(expected) and set(done) == expected


def test_stress_engine_double_complete_raises():
    """Four threads race ``complete`` on one record: one wins."""
    engine = _stress_engine(max_in_flight=1)
    engine.submit(Request(0, 0, 0.0, 0.0))
    out = engine.step(0.0)
    failures = []

    def racer():
        try:
            engine.complete(out)
        except ValueError:
            failures.append(1)

    _run_threads([threading.Thread(target=racer) for _ in range(4)])
    assert len(failures) == 3 and engine.in_flight == 0


def test_stress_queue_put_shed():
    """Concurrent producers on a bounded shed_oldest queue: every request
    ends queued or returned as a victim, exactly once."""
    q = RequestQueue(capacity=16, policy="shed_oldest")
    n_threads, per_thread = 8, 300
    victims = []
    vlock = threading.Lock()

    def produce(k):
        mine = []
        for j in range(per_thread):
            v = q.put(Request(k, j, 0.0, 0.0))
            if v is not None:
                mine.append((v.device_id, v.sample))
        with vlock:
            victims.extend(mine)

    _run_threads([threading.Thread(target=produce, args=(k,))
                  for k in range(n_threads)])
    left = [(r.device_id, r.sample) for r in q.pop_batch(10 ** 9)]
    total = n_threads * per_thread
    assert len(victims) == q.n_shed == total - len(left)
    assert len(left) == 16
    accounted = victims + left
    assert len(set(accounted)) == len(accounted) == total


def _oracle_fleet(queue=None, oracle=None, client_cls=StreamClient, n=N,
                  s=S, **client_kw):
    st, lat, _, _ = _scenario("steady")
    conf = np.asarray(st["confidence"], np.float32)
    cl = np.asarray(st["correct_light"])
    ch = np.asarray(st["correct_heavy"])
    clients = [client_cls(i, conf[i], cl[i], lat[i], SLO, 1.5, 0.5,
                          **client_kw) for i in range(n)]
    engine = ServerEngine(
        [ServedModel(p.name, None, p, oracle=oracle or _oracle(ch, k))
         for k, p in enumerate(SERVERS)], queue=queue)
    sched = make_scheduler("multitasc++", n, server_profile=SERVERS[0],
                           slo=SLO, init_threshold=0.5)
    return clients, engine, sched, [np.arange(s)] * n, \
        [np.ones(s, np.int64)] * n


def test_on_queue_drop_exactly_once_per_victim():
    counts = {}
    for run in (run_cascade, run_transport):
        args = _oracle_fleet(
            queue=RequestQueue(capacity=2, policy="shed_oldest"))
        hooked = []
        args[2].on_queue_drop = hooked.append
        res = run(*args)
        assert res.dropped > 0 and len(hooked) == res.dropped
        counts[run.__name__] = (res.dropped, sorted(hooked))
    assert counts["run_cascade"] == counts["run_transport"]


# ---------------------------------------------------------------------------
# overlap, witnessed; failure propagation
# ---------------------------------------------------------------------------
class _WitnessClient(StreamClient):
    """A client whose local inference costs 2 ms of host time (as a light
    model's does), and which records whether one ran while a server
    forward was in flight. The ~250 inferences before the first window
    barrier give the first forward half a second to start beside them."""

    def __init__(self, *args, in_forward, overlapped, **kw):
        super().__init__(*args, **kw)
        self.in_forward, self.overlapped = in_forward, overlapped

    def run_local(self, j):
        time.sleep(2e-3)
        if self.in_forward.is_set():
            self.overlapped.set()
        return super().run_local(j)


@pytest.mark.parametrize("run,wait,overlap", [
    (run_transport, JOIN, True), (run_cascade, 0.2, False)],
    ids=["async", "event"])
def test_host_overlaps_the_forward(run, wait, overlap):
    """The first server forward holds until some device-local inference
    runs beside it (or ``wait`` passes). The transport's ingestion thread
    keeps inferring while a worker is inside the forward; the one-thread
    loop cannot, so there the witness stays clear."""
    in_forward, overlapped = threading.Event(), threading.Event()
    st, _, _, _ = _scenario("steady")
    base = _oracle(np.asarray(st["correct_heavy"]), 0)
    calls = []

    def oracle(reqs):
        if not calls:
            in_forward.set()
            overlapped.wait(wait)
            in_forward.clear()
        calls.append(len(reqs))
        return base(reqs)

    args = _oracle_fleet(oracle=oracle, client_cls=_WitnessClient,
                         in_forward=in_forward, overlapped=overlapped)
    res = run(*args)
    assert res.completed == N * S and calls
    assert overlapped.is_set() == overlap


def test_worker_exception_propagates():
    """A forward that raises on a worker leaves ``run_transport``."""
    def bomb(reqs):
        raise RuntimeError("accelerator on fire")

    args = _oracle_fleet(oracle=bomb)
    box = []
    th = threading.Thread(target=lambda: box.append(
        pytest.raises(RuntimeError, run_transport, *args)))
    th.start()
    th.join(JOIN)
    assert not th.is_alive() and box
    assert "on fire" in str(box[0].value)


# ---------------------------------------------------------------------------
# counters under the worker pool
# ---------------------------------------------------------------------------
class _OnCard:
    """Stands in for a CUDA tensor: the wrappers read only ``.device``
    before they hand it to their (stubbed) entry point."""
    device = torch.device("cuda")


def _hammer(fn, threads=8, calls=1000):
    """``threads`` threads released together, ``calls`` calls each, with
    the interpreter switching threads as often as it can."""
    start = threading.Barrier(threads, timeout=JOIN)

    def work():
        start.wait()
        for _ in range(calls):
            fn()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _run_threads([threading.Thread(target=work) for _ in range(threads)])
    finally:
        sys.setswitchinterval(old)


@pytest.mark.parametrize("name", ["bvsb", "flash_attention",
                                  "decode_attention", "rglru_scan",
                                  "moe_dispatch", "moe_combine"])
def test_launch_counts_exact_under_threads(name, monkeypatch):
    """8 threads x 1,000 calls of a kernel wrapper, its launch stubbed out:
    the count reads 8,000."""
    mod = ops._KERNELS[name]
    entry = {"moe_dispatch": "run_dispatch_entry",
             "moe_combine": "run_combine_entry"}.get(name, "run_entry")
    monkeypatch.setattr(mod, entry, lambda *a, **k: None)
    monkeypatch.setattr(_build, "library", lambda: type(
        "Lib", (), {"repro_flash_attention": None})())
    card = _OnCard()
    call = {"bvsb": lambda: ops.bvsb(card),
            "flash_attention": lambda: ops.flash_attention(card, card, card),
            "decode_attention": lambda: ops.decode_attention(card, card,
                                                             card, card),
            "rglru_scan": lambda: ops.rglru_scan(card, card),
            "moe_dispatch": lambda: ops.moe_dispatch(card, card, 4, 8),
            "moe_combine": lambda: ops.moe_combine(card, card, card, card,
                                                   card)}[name]
    ops.reset_launch_counts()
    try:
        _hammer(call)
        assert ops.launch_counts() == {k: 8000 if k == name else 0
                                       for k in ops._KERNELS}
    finally:
        ops.reset_launch_counts()


def test_classify_cache_counts_exact_under_threads():
    """8 threads x 1,000 lookups of one classify entry: one miss, 7,999
    hits, one entry."""
    model = init_params(get_config("tier-low"),
                        torch.Generator().manual_seed(0), device="cpu")
    executables.clear_cache()
    try:
        _hammer(lambda: executables.classify_fn(model, 4))
        assert executables.cache_stats() == {"executables": 1,
                                             "hits": 7999, "misses": 1}
    finally:
        executables.clear_cache()
