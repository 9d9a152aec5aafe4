"""The port's sim-vs-serving replay (``repro_torch.serving.replay``) held
to the JAX package's on the CPU.

The same scenarios as tests/test_serving_differential.py (N 10, S 80:
steady / churn / churn_drift x the three schedulers) go through both
packages' ``serving_vs_sim``:

* the live half (``replay_cascade``, host-only, oracles for the models)
  equals the JAX package's field for field, the timeline included;
* the simulator half is the port's ``jaxsim.run`` on the CPU, held to the
  JAX package's as tests/test_torch_sim.py holds it: counts, ratios of
  counts and per-device fields exact, ``accuracy`` (a float32 sum over
  the devices, taken in another order) within ``AGG_RTOL`` = 1e-5
  relative;
* so the deltas ``d_sr``, ``d_thr_rel``, ``d_fwd`` and ``d_completed``
  equal the JAX package's exactly, and ``d_acc`` within ``AGG_RTOL`` of
  the simulator's accuracy; every delta is within ``SERVING_TOL``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import scenarios as jscenarios
from repro.configs.cascade_tiers import ServerProfile as JServerProfile
from repro.serving import replay as jreplay
from repro.sim import synthetic as jsynthetic
from repro_torch import serving
from repro_torch.configs.cascade_tiers import ServerProfile
from repro_torch.serving import replay
from test_torch_sim import AGG_RTOL, assert_port_matches
from test_torch_transport import assert_results_equal

torch.set_num_threads(2)

N, S, SEED = 10, 80, 11
SLO, BASE_LAT = 0.16, 0.06
SERVERS = (ServerProfile("sdiff-fast", "synthetic", 0.90, 0.045, 16),
           ServerProfile("sdiff-heavy", "synthetic", 0.94, 0.070, 16))
J_SERVERS = tuple(JServerProfile(**dataclasses.asdict(p)) for p in SERVERS)
SCHEDULERS = ("static", "multitasc", "multitasc++")
SCENARIOS = ("steady", "churn", "churn_drift")


def _scenario(name):
    streams = jsynthetic.device_streams(N, S, 0.70, [0.90, 0.94], SEED)
    rng = np.random.default_rng(2)
    lat = (BASE_LAT * rng.uniform(0.9, 1.1, N)).astype(np.float32)
    r = jscenarios.realize(jscenarios.SCENARIOS[name], [SEED], N, S, lat)
    st = dict(streams)
    if r["arrive"] is not None:
        st["arrive"] = r["arrive"][0]
    return st, lat, r["join_t"][0], r["leave_t"][0]


def _both(fn_ours, fn_ref, scn, sched, **kw):
    st, lat, join_t, leave_t = _scenario(scn)
    slo = np.full(N, SLO, np.float32)
    common = dict(join_t=join_t, leave_t=leave_t,
                  model_switching=scn == "churn_drift", **kw)
    return (fn_ours(sched, st, lat, slo, SERVERS, **common),
            fn_ref(sched, st, lat, slo, J_SERVERS, **common))


def test_tolerances_transports_and_exports_equal_the_reference():
    assert replay.SERVING_TOL == jreplay.SERVING_TOL
    assert replay.TRANSPORTS.keys() == jreplay.TRANSPORTS.keys()
    from repro import serving as jserving
    assert sorted(serving.__all__) == sorted(jserving.__all__)


def test_stream_client_equals_the_reference():
    st, lat, _, _ = _scenario("steady")
    ours = replay.StreamClient(3, st["confidence"][3], st["correct_light"][3],
                               lat[3], SLO, 1.5, 0.41)
    ref = jreplay.StreamClient(3, st["confidence"][3],
                               st["correct_light"][3], lat[3], SLO, 1.5, 0.41)
    assert [ours.run_local(j) for j in range(S)] == \
        [ref.run_local(j) for j in range(S)]
    assert ours.profile.latency == ref.profile.latency


@pytest.mark.parametrize("transport", ["event", "async"])
@pytest.mark.parametrize("sched", SCHEDULERS)
@pytest.mark.parametrize("scn", SCENARIOS)
def test_replay_cascade_equals_the_reference(scn, sched, transport):
    ours, ref = _both(replay.replay_cascade, jreplay.replay_cascade, scn,
                      sched, transport=transport, max_in_flight=2)
    assert_results_equal(ours, ref)


@pytest.mark.parametrize("sched", SCHEDULERS)
@pytest.mark.parametrize("scn", SCENARIOS)
def test_serving_vs_sim_equals_the_reference(scn, sched):
    (live, sim, d), (jlive, jsim, jd) = _both(
        lambda *a, **k: replay.serving_vs_sim(*a, device="cpu", **k),
        jreplay.serving_vs_sim, scn, sched)
    assert_results_equal(live, jlive)
    assert_port_matches(jsim, {k: np.asarray(v) for k, v in sim.items()
                               if k != "traces"} | {"traces": sim["traces"]})
    assert d.keys() == jd.keys()
    for k in ("d_sr", "d_thr_rel", "d_fwd", "d_completed"):
        assert d[k] == jd[k], k
    assert abs(d["d_acc"] - jd["d_acc"]) <= AGG_RTOL * float(jsim["accuracy"])
    tol = replay.SERVING_TOL[sched]
    assert d["d_completed"] == 0 and live.completed > 0
    assert d["d_sr"] <= tol["sr"] and d["d_thr_rel"] <= tol["thr_rel"]
    assert d["d_fwd"] <= tol["fwd"]


def test_serving_vs_sim_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    st, lat, _, _ = _scenario("steady")
    with pytest.raises(RuntimeError, match="CUDA"):
        replay.serving_vs_sim("static", st, lat, np.full(N, SLO), SERVERS)
