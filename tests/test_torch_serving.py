"""The port's serving layer: engine behaviour, the classify cache, and the
whole live cascade held to the JAX package's on the CPU.

Engine cases follow tests/test_serving.py. The whole-slice test carries
the JAX package's weights across with ``params_from_jax`` and runs the
same tokens and profiles through ``repro.serving.cascade.run_cascade`` and
``repro_torch.serving.cascade.run_cascade``: exactly equal under a static
threshold placed in the widest gap between the JAX confidences (so float
noise cannot flip a decision), within ``SERVING_TOL`` under MultiTASC++.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.cascade_tiers import DEVICE_PROFILES as J_DEVICE_PROFILES
from repro.configs.cascade_tiers import SERVER_PROFILES as J_SERVER_PROFILES
from repro.models.model import build_model as jbuild_model
from repro.serving.batching import pick_bucket as jpick_bucket
from repro.serving.cascade import run_cascade as jrun_cascade
from repro.serving.client import DeviceClient as JDeviceClient
from repro.serving.engine import ServedModel as JServedModel
from repro.serving.engine import ServerEngine as JServerEngine
from repro.serving.replay import SERVING_TOL
from repro.sim.events import make_scheduler as jmake_scheduler
from repro_torch.configs import get_config
from repro_torch.configs.cascade_tiers import (BATCH_LADDER, DEVICE_PROFILES,
                                               SERVER_PROFILES, ServerProfile)
from repro_torch.kernels import ops
from repro_torch.models.model import params_from_jax
from repro_torch.serving import executables
from repro_torch.serving.batching import pick_bucket
from repro_torch.serving.cascade import run_cascade
from repro_torch.serving.client import DeviceClient
from repro_torch.serving.engine import ServedModel, ServerEngine
from repro_torch.serving.queue import Request, RequestQueue
from repro_torch.sim.events import make_scheduler

torch.set_num_threads(2)

SLO, WINDOW, L = 0.15, 1.5, 16


@pytest.fixture(scope="module")
def tiers():
    """(light, heavy) as (jax model, jax params, port model on the CPU)."""
    out = []
    for i, name in enumerate(("tier-low", "tier-server-fast")):
        jm = jbuild_model(jget_config(name))
        jp = jm.init(jax.random.key(i))
        tm = params_from_jax(jax.tree.map(np.asarray, jp), get_config(name),
                             device="cpu")
        out.append((jm, jp, tm))
    return out


def _tokens(n, s, seed=1):
    rng = np.random.default_rng(seed)
    return [[rng.integers(0, 2048, L).astype(np.int32) for _ in range(s)]
            for _ in range(n)]


# ---------------------------------------------------------------------------
# queue and ladder: own copies, same answers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ladder", [BATCH_LADDER, (8, 1, 64, 4, 2, 32, 16),
                                    (5, 3, 9), (2, 4)])
def test_pick_bucket_matches_jax(ladder):
    for qlen in range(0, 70):
        for cap in (0, 1, 3, 16, 64):
            assert pick_bucket(qlen, cap, ladder) == \
                jpick_bucket(qlen, cap, ladder)


def test_queue_policies():
    q = RequestQueue(capacity=2, policy="reject")
    assert q.put(Request(0, None, 0.0, 0.0)) is None
    assert q.put(Request(1, None, 0.0, 0.0)) is None
    late = Request(2, None, 0.0, 0.0)
    assert q.put(late) is late and q.n_rejected == 1
    assert [r.device_id for r in q.pop_batch(4)] == [0, 1]
    q = RequestQueue(capacity=2, policy="shed_oldest")
    for i in range(3):
        victim = q.put(Request(i, None, 0.0, 0.0))
    assert victim.device_id == 0 and q.n_shed == 1
    with pytest.raises(ValueError):
        RequestQueue(capacity=0)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------
def test_engine_dynamic_batching(tiers):
    _, (_, _, hm) = tiers
    engine = ServerEngine([ServedModel("fast", hm,
                                       SERVER_PROFILES["inceptionv3"])])
    for i, tok in enumerate(_tokens(1, 10)[0]):
        engine.submit(Request(i % 3, tok, 0.0, 0.0))
    out = engine.step(now=1.0)
    assert len(out["requests"]) == 8 and len(engine.queue) == 2
    assert isinstance(out["conf"], np.ndarray) and out["conf"].shape == (8,)
    assert out["pred"].dtype == np.int32 and out["finish"] > 1.0


def test_engine_model_switching(tiers):
    _, (_, _, hm) = tiers
    engine = ServerEngine([
        ServedModel("fast", hm, SERVER_PROFILES["inceptionv3"]),
        ServedModel("heavy", hm, SERVER_PROFILES["efficientnetb3"])])
    assert engine.active.name == "fast"
    assert engine.switch(+1) and engine.active.name == "heavy"
    assert not engine.switch(+1)
    assert engine.switch(-1) and engine.active.name == "fast"


def _oracle_engine(max_in_flight=1, queue=None, max_batch=8,
                   base_latency=0.02):
    def oracle(reqs):
        return np.ones(len(reqs)), np.ones(len(reqs), np.int32)
    prof = ServerProfile("osrv", "oracle", 0.9, base_latency, max_batch)
    return ServerEngine([ServedModel("osrv", None, prof, oracle=oracle)],
                        max_in_flight=max_in_flight, queue=queue)


def test_engine_refuses_double_dispatch_and_double_complete():
    engine = _oracle_engine()
    for i in range(6):
        engine.submit(Request(i, None, 0.0, 0.0))
    out = engine.step(0.0)
    assert out is not None and engine.in_flight == 1
    assert engine.step(0.0) is None
    assert len(engine.queue) == 6 - len(out["requests"])
    engine.complete(out)
    with pytest.raises(ValueError):
        engine.complete(out)
    assert engine.in_flight == 0 and engine.step(out["finish"]) is not None


def test_engine_two_slots():
    engine = _oracle_engine(max_in_flight=2, max_batch=4)
    for i in range(6):
        engine.submit(Request(i, None, 0.0, 0.0))
    out1, out2 = engine.step(0.0), engine.step(0.0)
    assert len(out1["requests"]) == 4 and len(out2["requests"]) == 2
    assert engine.in_flight == 2 and engine.step(0.0) is None
    assert out2["finish"] < out1["finish"]
    engine.complete(out2)
    assert engine.slots_free == 1
    engine.complete(out1)
    assert engine.in_flight == 0


class _DropCounter:
    """Static scheduler that counts ``on_queue_drop`` calls."""

    def __init__(self, n):
        self.inner = make_scheduler("static", n, server_profile=None,
                                    slo=SLO, static_threshold=1.0)
        self.drops = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def on_queue_drop(self, device_id):
        self.drops += 1


def test_bounded_queue_sheds_to_local_fallback(tiers):
    """Everything forwards into a capacity-1 queue in front of a slow
    server: shed requests complete with the device's local prediction,
    nothing is lost, and the drop hook fires once per drop."""
    (_, _, lm), _ = tiers
    n, s = 3, 8
    clients = [DeviceClient(i, lm, DEVICE_PROFILES["low"], 1.0, WINDOW, 1.0)
               for i in range(n)]
    q = RequestQueue(capacity=1, policy="shed_oldest")
    engine = _oracle_engine(queue=q, max_batch=2, base_latency=0.5)
    sched = _DropCounter(n)
    res = run_cascade(clients, engine, sched, _tokens(n, s))
    assert res.completed == n * s and res.forwarded_frac == 1.0
    assert res.dropped > 0 and res.dropped == q.n_shed == sched.drops
    assert res.queue_peak <= 1


# ---------------------------------------------------------------------------
# classify cache: entries bounded by distinct buckets, never objects
# ---------------------------------------------------------------------------
def test_client_fleet_shares_one_entry(tiers):
    (_, _, lm), _ = tiers
    executables.clear_cache()
    clients = [DeviceClient(i, lm, DEVICE_PROFILES["low"], SLO, WINDOW, 0.5)
               for i in range(12)]
    for c in clients:
        c.run_local(np.zeros(L, np.int32))
    assert executables.cache_stats() == {"executables": 1, "hits": 11,
                                         "misses": 1}


def test_engine_entries_bounded_by_buckets(tiers):
    _, (_, _, hm) = tiers
    executables.clear_cache()
    prof = SERVER_PROFILES["inceptionv3"]

    def drive(engine):
        for i, tok in enumerate(_tokens(1, 10)[0]):
            engine.submit(Request(i % 3, tok, 0.0, 0.0))
        t = 0.0
        while (out := engine.step(t)) is not None:
            engine.complete(out)
            t = out["finish"]

    engine = ServerEngine([ServedModel("fast", hm, prof),
                           ServedModel("heavy", hm, prof)])
    drive(engine)
    assert set(engine.batch_history) == {8, 2}
    assert executables.cache_stats()["misses"] <= len({8, 2}) + 1
    engine2 = ServerEngine([ServedModel("fast", hm, prof),
                            ServedModel("heavy", hm, prof)])
    engine2.switch(+1)
    misses = executables.cache_stats()["misses"]
    drive(engine2)
    assert executables.cache_stats()["misses"] == misses
    assert executables.cache_stats()["executables"] == 2


# ---------------------------------------------------------------------------
# the whole slice against the JAX package
# ---------------------------------------------------------------------------
N_DEV, N_SAMPLES = 3, 12
# a tight SLO and short windows, so that SR moves and the scheduler acts
# several times within the 12 samples' 0.37 s of virtual time
SLICE_SLO, SLICE_WINDOW = 0.05, 0.1


def _run_both(tiers, scheduler, threshold, **kw):
    (jlm, jlp, lm), (jhm, jhp, hm) = tiers
    data = _tokens(N_DEV, N_SAMPLES, seed=4)
    sched_kw = dict(server_profile=SERVER_PROFILES["inceptionv3"],
                    slo=SLICE_SLO, static_threshold=threshold)
    jsched_kw = dict(sched_kw,
                     server_profile=J_SERVER_PROFILES["inceptionv3"])
    jclients = [JDeviceClient(i, jlm, jlp, J_DEVICE_PROFILES["low"],
                              SLICE_SLO, SLICE_WINDOW, threshold)
                for i in range(N_DEV)]
    jengine = JServerEngine([
        JServedModel("fast", jhm, jhp, J_SERVER_PROFILES["inceptionv3"]),
        JServedModel("heavy", jhm, jhp, J_SERVER_PROFILES["efficientnetb3"])])
    jres = jrun_cascade(jclients, jengine,
                        jmake_scheduler(scheduler, N_DEV, **jsched_kw),
                        data, window=SLICE_WINDOW, **kw)
    ops.reset_launch_counts()
    clients = [DeviceClient(i, lm, DEVICE_PROFILES["low"], SLICE_SLO,
                            SLICE_WINDOW, threshold) for i in range(N_DEV)]
    engine = ServerEngine([
        ServedModel("fast", hm, SERVER_PROFILES["inceptionv3"]),
        ServedModel("heavy", hm, SERVER_PROFILES["efficientnetb3"])])
    res = run_cascade(clients, engine,
                      make_scheduler(scheduler, N_DEV, **sched_kw),
                      data, window=SLICE_WINDOW, **kw)
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)
    return jres, res


def _widest_gap_threshold(tiers):
    """Mid-point of the widest gap between the JAX light confidences."""
    (jlm, jlp, _), _ = tiers
    client = JDeviceClient(0, jlm, jlp, J_DEVICE_PROFILES["low"], SLO,
                           WINDOW, 0.5)
    confs = np.sort([client.run_local(tok)[0]
                     for dev in _tokens(N_DEV, N_SAMPLES, seed=4)
                     for tok in dev])
    i = int(np.argmax(np.diff(confs)))
    return float((confs[i] + confs[i + 1]) / 2)


def test_whole_slice_static_equals_jax(tiers):
    threshold = _widest_gap_threshold(tiers)
    jres, res = _run_both(tiers, "static", threshold)
    assert 0.0 < res.forwarded_frac < 1.0   # the threshold splits the data
    assert res.sr < 100.0                   # and the SLO binds
    assert res.completed == jres.completed == N_DEV * N_SAMPLES
    assert res.forwarded_frac == jres.forwarded_frac
    assert res.sr == jres.sr
    assert res.throughput == jres.throughput
    assert np.array_equal(res.per_device_sr, jres.per_device_sr)
    assert res.timeline["thresholds"] == jres.timeline["thresholds"]
    assert res.timeline["model"] == jres.timeline["model"]


def test_whole_slice_multitascpp_within_serving_tol(tiers):
    jres, res = _run_both(tiers, "multitasc++", 0.5, model_switching=True)
    tol = SERVING_TOL["multitasc++"]
    assert res.completed == jres.completed == N_DEV * N_SAMPLES
    assert abs(res.sr - jres.sr) <= tol["sr"]
    assert abs(res.throughput - jres.throughput) \
        <= tol["thr_rel"] * jres.throughput
    assert abs(res.forwarded_frac - jres.forwarded_frac) <= tol["fwd"]
    assert res.switches == jres.switches
