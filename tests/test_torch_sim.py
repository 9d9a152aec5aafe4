"""The port's simulator path held to the JAX package on the CPU: synthetic
streams, scenarios, the reference event simulator and the lane-aligned
sweep core (``repro_torch.sim.jaxsim``, ``device="cpu"``).

The same seeded numpy inputs go through both packages. What must agree:

* streams, arrival tensors and scenario arrays: ``np.array_equal``;
* ``events.run``: every field of ``SimResult`` equal (both are float64
  Python over the same heap; the schedulers' float32 updates are bitwise,
  tests/test_torch_scheduler.py);
* ``jaxsim.run_sweep`` against the JAX package's jitted ``run_sweep``:
  counts (``completed``, ``queue_left``, ``queue_peak``, ``n_events``),
  ratios of integer counts (``sr``, ``forwarded_frac``, ``throughput``),
  per-device fields, final thresholds and the traces' ``server_idx``,
  ``fwd`` and ``active`` bitwise; the aggregates that sum floats over
  devices (``accuracy`` and the traces' ``thresh``, ``sr``, ``acc``
  means) within ``AGG_RTOL`` = 1e-5 relative, a few float32 ulp of a sum
  over at most 128 devices taken in another order (both devices have
  given these bitwise so far; the tolerance states what is promised).

The segmented frontier (``frontier_seg``) is held to the JAX package's
segmented run with the same rules, ``n_events`` included (a tie across
segments takes one trip a segment on both sides), and to the port's flat
run bit for bit in every field but ``n_events``. ``lane_stepper``'s
state after k trips equals the JAX package's ``lane_stepper`` state:
every field exactly, the traces' float means within ``AGG_RTOL``.

Sizes stay small (N <= 12, S <= 80, few static structures, since each
costs a JAX compile; the segmented cases take N 150-200 and one fleet of
``SEG_AUTO_MIN`` devices at S = 3).
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from lane_utils import assert_lane_bitwise, pack_lanes
from repro.configs import scenarios as jscenarios
from repro.configs.cascade_tiers import SERVER_PROFILES as J_SERVER_PROFILES
from repro.configs.cascade_tiers import DeviceProfile as JDeviceProfile
from repro.configs.cascade_tiers import ServerProfile as JServerProfile
from repro.sim import events as jevents
from repro.sim import jaxsim as J
from repro.sim import synthetic as jsynthetic
from repro_torch.configs import scenarios
from repro_torch.configs.cascade_tiers import (DeviceProfile, ServerProfile)
from repro_torch.sim import events, jaxsim, synthetic
from test_differential import WINDOW, random_config

torch.set_num_threads(2)

AGG_RTOL = 1e-5
EXACT = ("completed", "queue_left", "queue_peak", "n_events", "sr",
         "forwarded_frac", "throughput")
EXACT_DEVICE = ("per_device_sr", "per_device_acc", "final_thresh")
EXACT_TRACES = ("server_idx", "fwd", "active")


# ---------------------------------------------------------------------------
# streams and scenarios
# ---------------------------------------------------------------------------
def _assert_dicts_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if a[k] is None:
            assert b[k] is None, k
            continue
        assert a[k].dtype == b[k].dtype, k
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("light", [0.72, (0.70, 0.75, 0.78, 0.71)])
@pytest.mark.parametrize("heavy", [0.80, (0.78, 0.81, 0.83)])
def test_streams_equal_the_reference(light, heavy):
    seeds = (0, 3, 11)
    _assert_dicts_equal(
        synthetic.batched_device_streams(seeds, 4, 50, light, heavy),
        jsynthetic.batched_device_streams(seeds, 4, 50, light, heavy))
    _assert_dicts_equal(synthetic.device_streams(4, 50, light, heavy, 7),
                        jsynthetic.device_streams(4, 50, light, heavy, 7))
    assert synthetic.STREAM_FIXTURE_VERSION == \
        jsynthetic.STREAM_FIXTURE_VERSION


def test_generate_and_calibration_set_equal_the_reference():
    for ours, ref in ((synthetic.generate(200, 0.7, [0.8, 0.85], 5),
                       jsynthetic.generate(200, 0.7, [0.8, 0.85], 5)),
                      (synthetic.calibration_set(0.72, 0.81, n=500),
                       jsynthetic.calibration_set(0.72, 0.81, n=500))):
        for f in dataclasses.fields(ref):
            a, b = getattr(ours, f.name), getattr(ref, f.name)
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        assert len(ours) == len(ref)


@pytest.mark.parametrize("chunk", [1, 3, 7])
def test_stream_chunks_equal_the_dense_tensors(chunk):
    seeds, n, m = (1, 4), 7, 30
    light, heavy = (0.7, 0.72, 0.74, 0.76, 0.7, 0.71, 0.73), (0.8, 0.84)
    lazy = synthetic.chunked_device_streams(seeds, n, m, light, heavy, chunk)
    dense = jsynthetic.batched_device_streams(seeds, n, m, light, heavy)
    assert lazy.shape == (2, n, m) and lazy.n_profiles == 2
    _assert_dicts_equal(lazy.materialize(), dense)
    covered = 0
    for lo, hi, blk in lazy.chunks():
        assert lo == covered and hi - lo <= chunk
        for k, v in blk.items():
            assert np.array_equal(v, dense[k][:, lo:hi]), k
        covered = hi
    assert covered == n


@pytest.mark.parametrize("kind", ["piecewise", "piecewise_fracs", "mmpp"])
def test_arrival_tensors_equal_the_reference(kind):
    seeds, n, m = (0, 2), 5, 40
    rate = np.linspace(5.0, 15.0, n)
    for mod_ours, mod_ref in ((synthetic, jsynthetic),):
        if kind == "piecewise":
            args = (seeds, n, m, [rate * 1.5, rate * 0.6])
            fn = "piecewise_arrivals"
        elif kind == "piecewise_fracs":
            args = (seeds, n, m, [rate, 2.0, rate * 0.5], (0.2, 0.5, 0.3))
            fn = "piecewise_arrivals"
        else:
            args = (seeds, n, m, rate * 1.8, rate * 0.55, 0.1)
            fn = "mmpp_arrivals"
        a = getattr(mod_ours, fn)(*args)
        b = getattr(mod_ref, fn)(*args)
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


@pytest.mark.parametrize("name", sorted(jscenarios.SCENARIOS))
def test_scenarios_realize_equal_the_reference(name):
    lat = np.array([0.031, 0.043, 0.033, 0.057, 0.031, 0.043])
    kw = dict(seeds=(0, 1, 5), n_devices=6, samples_per_device=40,
              dev_latency=lat)
    _assert_dicts_equal(scenarios.realize(scenarios.SCENARIOS[name], **kw),
                        jscenarios.realize(jscenarios.SCENARIOS[name], **kw))
    assert repr(scenarios.SCENARIOS[name]).replace("repro_torch.", "") == \
        repr(jscenarios.SCENARIOS[name]).replace("repro.", "")


def test_scenario_specs_equal_the_reference():
    custom = dict(churn=dict(join_frac=0.5, leave_frac=0.2,
                             join_window=(0.0, 0.3)),
                  arrivals=dict(kind="mmpp", burst_scale=2.5,
                                switch_prob=0.2))
    ours = scenarios.ScenarioSpec(
        "custom", scenarios.ChurnSpec(**custom["churn"]),
        scenarios.ArrivalSpec(**custom["arrivals"]))
    ref = jscenarios.ScenarioSpec(
        "custom", jscenarios.ChurnSpec(**custom["churn"]),
        jscenarios.ArrivalSpec(**custom["arrivals"]))
    kw = dict(seeds=(4,), n_devices=9, samples_per_device=25,
              dev_latency=0.05, horizon=3.0)
    _assert_dicts_equal(scenarios.realize(ours, **kw),
                        jscenarios.realize(ref, **kw))
    with pytest.raises(ValueError):
        scenarios.realize(scenarios.ScenarioSpec(
            "bad", arrivals=scenarios.ArrivalSpec(kind="poisson")), **kw)


# ---------------------------------------------------------------------------
# the reference event simulator
# ---------------------------------------------------------------------------
def _servers(cfg):
    return tuple(ServerProfile(**dataclasses.asdict(p)) for p in cfg.servers)


def _runtimes(cfg, mod, profile_cls, gen):
    init = (cfg.static_threshold if cfg.scheduler == "static"
            else cfg.init_threshold)
    devs = []
    for i in range(cfg.n):
        prof = profile_cls(f"d{i}", "diff", "low", 0.72,
                           float(cfg.latencies[i]))
        stream = gen(cfg.samples, 0.72, [s.accuracy for s in cfg.servers],
                     cfg.seed * 977 + i)
        dev = mod.DeviceRuntime(prof, stream, float(cfg.slos[i]), init)
        if cfg.offline_start is not None \
                and np.isfinite(cfg.offline_start[i]):
            dev.offline_start_t = float(cfg.offline_start[i])
            dev.offline_for_t = float(cfg.offline_for[i])
        if cfg.join_t is not None:
            dev.join_t = float(cfg.join_t[i])
        if cfg.leave_t is not None:
            dev.leave_t = float(cfg.leave_t[i])
        if cfg.arrive is not None:
            dev.arrive = cfg.arrive[i].astype(np.float64)
        devs.append(dev)
    return devs


def _events_run(cfg, mod, profile_cls, gen, servers):
    sched = mod.make_scheduler(
        cfg.scheduler, cfg.n, server_profile=servers[0],
        slo=float(cfg.slos.min()), init_threshold=cfg.init_threshold,
        static_threshold=cfg.static_threshold)
    return mod.run(_runtimes(cfg, mod, profile_cls, gen), servers, sched,
                   window=WINDOW, model_switching=cfg.model_switching,
                   tier_ids=cfg.tier_ids, c_upper=cfg.c_upper)


EVENT_CASES = (
    [(seed, sched, {}) for seed in (0, 1) for sched in
     ("multitasc++", "multitasc", "static")]
    + [(100, "multitasc++", dict(model_switching=True)),
       (101, "static", dict(model_switching=True)),
       (200, "multitasc++", dict(offline=True)),
       (201, "static", dict(offline=True)),
       (401, "multitasc++", dict(churn=True, stress=True)),
       (402, "multitasc", dict(churn=True)),
       (421, "multitasc++", dict(drift=True, stress=True)),
       (441, "static", dict(churn=True, drift=True, stress=True))])


@pytest.mark.parametrize("seed,scheduler,kw", EVENT_CASES,
                         ids=lambda x: str(x))
def test_event_simulator_equals_the_reference(seed, scheduler, kw):
    kw = dict(kw)
    kw.setdefault("stress", bool(seed % 2))
    cfg = random_config(seed, scheduler, **kw)
    ref = _events_run(cfg, jevents, JDeviceProfile, jsynthetic.generate,
                      cfg.servers)
    ours = _events_run(cfg, events, DeviceProfile, synthetic.generate,
                       _servers(cfg))
    assert isinstance(ours, events.SimResult)
    for f in dataclasses.fields(jevents.SimResult):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if f.name == "timeline":
            assert a.keys() == b.keys()
            for k in b:
                assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b)), f.name
    assert ref.completed > 0


# ---------------------------------------------------------------------------
# the lane-aligned sweep core
# ---------------------------------------------------------------------------
def _spec(mod, cfg, **kw):
    return mod.JaxSimSpec(
        scheduler=cfg.scheduler, n_devices=cfg.n,
        samples_per_device=cfg.samples, window=WINDOW,
        init_threshold=cfg.init_threshold,
        static_threshold=cfg.static_threshold,
        model_switching=cfg.model_switching, **kw)


def _lane(cfg, mod, **spec_kw):
    per_dev = [jsynthetic.generate(cfg.samples, 0.72,
                                   [s.accuracy for s in cfg.servers],
                                   cfg.seed * 977 + i) for i in range(cfg.n)]
    streams = {
        "confidence": np.stack([s.confidence for s in per_dev]),
        "correct_light": np.stack([s.correct_light for s in per_dev]),
        "correct_heavy": np.stack([s.correct_heavy for s in per_dev]),
    }
    if cfg.arrive is not None:
        streams["arrive"] = cfg.arrive
    return dict(spec=_spec(mod, cfg, **spec_kw), streams=streams,
                lat=cfg.latencies, slo=cfg.slos, tier=cfg.tier_ids,
                c_upper=cfg.c_upper, off_start=cfg.offline_start,
                off_for=cfg.offline_for, join_t=cfg.join_t,
                leave_t=cfg.leave_t)


def _sweep_both(cfgs, **spec_kw):
    """One batched call of each package on the same packed lanes."""
    servers = cfgs[0].servers
    assert all(c.servers == servers for c in cfgs)
    outs = []
    for mod, srv in ((J, servers),
                     (jaxsim, tuple(ServerProfile(**dataclasses.asdict(p))
                                    for p in servers))):
        specs, streams, lat, slo, kw = pack_lanes(
            [_lane(c, mod, **spec_kw) for c in cfgs])
        call = dict(device="cpu") if mod is jaxsim else {}
        outs.append(mod.run_sweep(specs, streams, lat, slo, srv, **kw,
                                  **call))
    return outs


def assert_port_matches(ref, ours, n=None):
    for k in EXACT:
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)
    for k in EXACT_DEVICE:
        a, b = ours[k], np.asarray(ref[k])
        if n is not None:
            a, b = a[..., :n], b[..., :n]
        np.testing.assert_array_equal(a, b, err_msg=k)
    np.testing.assert_allclose(ours["accuracy"], np.asarray(ref["accuracy"]),
                               rtol=AGG_RTOL, atol=0)
    assert ours["traces"].keys() == ref["traces"].keys()
    for k, v in ref["traces"].items():
        v = np.asarray(v)
        if k in EXACT_TRACES:
            np.testing.assert_array_equal(ours["traces"][k], v, err_msg=k)
        else:
            np.testing.assert_allclose(ours["traces"][k], v, rtol=AGG_RTOL,
                                       atol=0, equal_nan=True, err_msg=k)


def _slice(cfgs, samples=48):
    """Differential configs shaped for one batch: a shared sample count
    (the static structure) and the first config's server pair (the server
    tables are shared by the lanes), everything else free."""
    for c in cfgs:
        if c.arrive is not None:
            c.arrive = c.arrive[:, :samples]
        c.samples = samples
        c.servers = cfgs[0].servers
    return cfgs


def test_run_sweep_three_schedulers_equal_the_reference():
    cfgs = _slice([random_config(s, sched, stress=bool(s % 2))
                   for s, sched in ((1, "multitasc++"), (2, "multitasc"),
                                    (3, "static"))])
    assert cfgs[0].servers[0].name == "diff-slow"   # congested
    ref, ours = _sweep_both(cfgs)
    assert_port_matches(ref, ours)
    assert set(ours["n_events"]) and (ours["completed"]
                                      == [c.n * 48 for c in cfgs]).all()


def test_run_sweep_heterogeneous_lane_mix_equals_the_reference():
    """Four lanes in one call: all three schedulers, 2-8 devices, easy and
    congested regimes, model switching over tiers with per-lane c_upper,
    an offline lane and a churn lane."""
    cfgs = [random_config(100, "multitasc++", model_switching=True),
            random_config(13, "static", stress=True, model_switching=True),
            random_config(200, "multitasc", offline=True),
            random_config(401, "multitasc++", churn=True, stress=True)]
    # static thresholds above every tier's c_upper: S(C) moves the server
    # to the heavier model at the first boundary
    cfgs[1].static_threshold = 0.95
    ref, ours = _sweep_both(_slice(cfgs))
    assert_port_matches(ref, ours)
    assert np.nanmax(ours["traces"]["server_idx"][1]) == 1


@pytest.mark.parametrize("scheduler", ["multitasc++", "multitasc", "static"])
def test_run_sweep_churn_and_arrivals_equal_the_reference(scheduler):
    """Churn with piecewise-rate arrivals, MMPP arrivals, and a plain
    saturated control, in one call with an arrival tensor."""
    n, s = 9, 60
    lat = np.linspace(0.04, 0.09, n).astype(np.float32)
    seeds = (0, 1, 2)
    r1 = jscenarios.realize(jscenarios.SCENARIOS["churn_drift"], seeds, n, s,
                            lat)
    r2 = jscenarios.realize(jscenarios.SCENARIOS["drift"], seeds, n, s, lat)
    streams = jsynthetic.batched_device_streams(seeds, n, s, 0.72,
                                                (0.78, 0.81))
    arrive = np.stack([r1["arrive"][0], r2["arrive"][1],
                       np.zeros((n, s), np.float32)])
    join = np.stack([r1["join_t"][0], r2["join_t"][1], np.zeros(n)])
    leave = np.stack([r1["leave_t"][0], r2["leave_t"][1],
                      np.full(n, np.inf)])
    kw = dict(tier_ids=np.arange(n) % 3, c_upper=(0.85, 0.8, 0.75),
              join_t=join, leave_t=leave)
    outs = []
    for mod, sp in ((J, jsynthetic), (jaxsim, synthetic)):
        spec = mod.JaxSimSpec(scheduler, n, s, static_threshold=0.4,
                              model_switching=True)
        srv = tuple(mod_srv for mod_srv in (
            (JServerProfile if mod is J else ServerProfile)(
                "fast", "x", 0.78, 0.012, 64),
            (JServerProfile if mod is J else ServerProfile)(
                "slow", "x", 0.81, 0.03, 16)))
        call = dict(device="cpu") if mod is jaxsim else {}
        outs.append(mod.run_sweep(spec, dict(streams, arrive=arrive), lat,
                                  lat * 2.5, srv, **kw, **call))
    ref, ours = outs
    assert_port_matches(ref, ours)
    assert np.isfinite(leave[:2]).any() and ours["completed"][2] == n * s


def test_run_sweep_small_queue_cap_wraps_the_ring():
    """A ring of 65 slots behind a slow server: the tail wraps past the
    capacity, the realized peak stays under it."""
    cfgs = _slice([random_config(s, sched, stress=True)
                   for s, sched in ((5, "multitasc++"), (7, "static"))])
    ref, ours = _sweep_both(cfgs, queue_cap=65)
    assert_port_matches(ref, ours)
    fwd = np.round(ours["forwarded_frac"] * ours["completed"])
    assert (fwd > 65).any() and (ours["queue_peak"] < 65).all()


def test_run_sweep_batch_latency_takes_the_fused_rounding():
    """Batches of 32 behind a server whose base latency makes
    base * (1 + 0.05 * 31) round differently with and without a fused
    multiply-add: the finish times, and so the throughput, are the jitted
    JAX core's bits only when both multiply-adds round once."""
    n, s = 64, 20
    rng = np.random.default_rng(0)
    streams = {"confidence": rng.uniform(0, 0.9, (n, s)).astype(np.float32),
               "correct_light": rng.integers(0, 2, (n, s)).astype(np.int8),
               "correct_heavy": rng.integers(0, 2, (n, s, 1)).astype(np.int8)}
    base = float(np.float32(0.01))
    assert np.float32(np.float32(base) * np.float32(2.5500002)) != \
        np.float32(np.float32(base) * np.float32(2.55))
    lat = np.full(n, 0.05, np.float32)
    outs = []
    for mod, prof in ((J, JServerProfile), (jaxsim, ServerProfile)):
        call = dict(device="cpu") if mod is jaxsim else {}
        outs.append(mod.run(mod.JaxSimSpec("static", n, s,
                                           static_threshold=1.0),
                            streams, lat, np.full(n, 0.2, np.float32),
                            (prof("x", "x", 0.8, base, 32),), **call))
    ref, ours = outs
    for k in EXACT:
        assert float(ours[k]) == float(ref[k]), k


def test_lane_of_a_batch_equals_its_own_run():
    """B = 1 ``run`` against the same point as a lane of a B = 3 batch
    with other companions: bitwise, traces included."""
    cfgs = _slice([random_config(s, sched, stress=bool(s % 2))
                   for s, sched in ((21, "multitasc++"), (22, "static"),
                                    (23, "multitasc"))])
    srv = tuple(ServerProfile(**dataclasses.asdict(p))
                for p in cfgs[0].servers)
    specs, streams, lat, slo, kw = pack_lanes(
        [_lane(c, jaxsim) for c in cfgs])
    batch = jaxsim.run_sweep(specs, streams, lat, slo, srv, device="cpu",
                             **kw)
    for i in (0, 2):
        ln = _lane(cfgs[i], jaxsim)
        solo = jaxsim.run(ln["spec"], ln["streams"], ln["lat"], ln["slo"],
                          srv, tier_ids=ln["tier"], c_upper=ln["c_upper"],
                          offline_start=ln["off_start"],
                          offline_for=ln["off_for"], join_t=ln["join_t"],
                          leave_t=ln["leave_t"], device="cpu")
        assert_lane_bitwise(batch, i, solo, cfgs[i].n)


def _tiny():
    streams = synthetic.device_streams(3, 10, 0.72, 0.8, 0)
    spec = jaxsim.JaxSimSpec("static", 3, 10)
    srv = (ServerProfile("x", "x", 0.8, 0.02, 16),)
    return spec, streams, np.full(3, 0.05), np.full(3, 0.2), srv


def test_unported_paths_raise():
    """The device-sharded engine needs the segmented frontier: a call over
    four lanes with ``frontier_seg=False`` raises before any collective
    (the mesh is a stand-in with a DeviceMesh's axis names and shape;
    tests/test_torch_sharded.py makes the same call over four real ranks).
    The flat frontier itself still runs."""
    spec, streams, lat, slo, srv = _tiny()
    four = types.SimpleNamespace(mesh_dim_names=("data",), shape=(4,))
    with pytest.raises(ValueError, match="segmented frontier"):
        jaxsim.run_device_sharded(spec, streams, lat, slo, srv, mesh=four,
                                  frontier_seg=False, device="cpu")
    with pytest.raises(ValueError, match="segmented frontier"):
        jaxsim._seg_layout(128, False, device_shards=4)
    assert jaxsim._seg_layout(128, False) == (0, 128)
    out = jaxsim.run(spec, streams, lat, slo, srv, frontier_seg=False,
                     device="cpu")
    assert int(out["completed"]) == 30


def test_run_sweep_results_survive_the_next_run():
    """The metric arrays are the caller's: a later run of the same
    structure reuses the engine's buffers and must not write into them."""
    spec, streams, lat, slo, srv = _tiny()
    first = jaxsim.run_sweep([spec], streams, lat, slo, srv, device="cpu")
    kept = {k: np.copy(v) for k, v in first.items() if k != "traces"}
    kept_traces = {k: np.copy(v) for k, v in first["traces"].items()}
    other = dataclasses.replace(spec, scheduler="multitasc",
                                static_threshold=0.9)
    second = jaxsim.run_sweep([other], synthetic.device_streams(
        3, 10, 0.72, 0.8, 5), np.array([0.05, 0.07, 0.11]), slo, srv,
        device="cpu")
    assert not np.array_equal(second["n_events"], kept["n_events"])
    _assert_bitwise(first, dict(kept, traces=kept_traces))


def test_run_sweep_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    spec, streams, lat, slo, srv = _tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        jaxsim.run(spec, streams, lat, slo, srv)
    with pytest.raises(RuntimeError, match="CUDA"):
        jaxsim.run_sweep([spec], streams, lat, slo, srv)


def test_stats_snapshot_counts_points_events_and_trips():
    spec, streams, lat, slo, srv = _tiny()
    before = jaxsim.stats_snapshot()
    out = jaxsim.run_sweep([spec, spec], streams, lat, slo, srv,
                           device="cpu")
    after = jaxsim.stats_snapshot()
    assert set(after) >= {"points", "events", "trips", "graphs_captured",
                          "engines_built"}
    assert after["points"] - before["points"] == 2
    assert after["events"] - before["events"] == int(out["n_events"].sum())
    assert after["trips"] - before["trips"] >= int(out["n_events"].max())
    assert (after["trips"] - before["trips"]) % jaxsim.GRAPH_TRIPS == 0
    assert after["graphs_captured"] == before["graphs_captured"]


# ---------------------------------------------------------------------------
# the segmented frontier and lane_stepper
# ---------------------------------------------------------------------------
SEG_SERVERS = (J_SERVER_PROFILES["inceptionv3"],
               J_SERVER_PROFILES["efficientnetb3"])


def _seg_sweep(mod, seeds, n, s, scheduler, frontier_seg, lat, **kw):
    """One batched run of ``mod`` over seeded lanes of the fleet-scale
    tests' point (tests/test_scale.py ``_point``): SLO twice the latency,
    model switching over inceptionv3 / efficientnetb3."""
    servers = SEG_SERVERS if mod is J else tuple(
        ServerProfile(**dataclasses.asdict(p)) for p in SEG_SERVERS)
    streams = jsynthetic.batched_device_streams(
        seeds, n, s, 0.72, [p.accuracy for p in SEG_SERVERS])
    spec = mod.JaxSimSpec(scheduler=scheduler, n_devices=n,
                          samples_per_device=s, model_switching=True)
    call = dict(device="cpu") if mod is jaxsim else {}
    return mod.run_sweep(spec, streams, lat, (lat * 2.0).astype(np.float32),
                         servers, frontier_seg=frontier_seg, **kw, **call)


def _assert_bitwise(a, b, skip=()):
    assert a.keys() == b.keys()
    for k in a:
        if k in skip:
            continue
        if k == "traces":
            for t in a[k]:
                np.testing.assert_array_equal(a[k][t], b[k][t], err_msg=t)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _seg_against_both(seeds, n, s, scheduler, frontier_seg, lat, ties=False,
                      **kw):
    ours = _seg_sweep(jaxsim, seeds, n, s, scheduler, frontier_seg, lat, **kw)
    ref = _seg_sweep(J, seeds, n, s, scheduler, frontier_seg, lat, **kw)
    assert_port_matches(ref, ours)
    flat = _seg_sweep(jaxsim, seeds, n, s, scheduler, False, lat, **kw)
    _assert_bitwise(ours, flat, skip=("n_events",) if ties else ())
    assert (ours["n_events"] >= flat["n_events"]).all()
    return ours, flat


@pytest.mark.parametrize("scheduler", ["multitasc++", "multitasc", "static"])
def test_seg_frontier_heterogeneous_equals_the_reference(scheduler):
    """Three seeds as lanes, raw-uniform latencies per lane (no ties):
    equal to JAX's segmented run and to the port's flat run, even in
    ``n_events``."""
    seeds, n, s = (0, 1, 2), 200, 10
    lat = np.stack([np.random.default_rng(x).uniform(0.04, 0.2, n)
                    for x in seeds]).astype(np.float32)
    ours, flat = _seg_against_both(seeds, n, s, scheduler, True, lat)
    np.testing.assert_array_equal(ours["n_events"], flat["n_events"])


@pytest.mark.parametrize("scheduler", ["multitasc++", "static"])
def test_seg_frontier_tie_storm_equals_the_reference(scheduler):
    """Every device completes at the same instants: the tie drains one
    segment a trip before the launch, so only ``n_events`` grows, by the
    JAX package's count."""
    n, s = 200, 25
    ours, flat = _seg_against_both((0,), n, s, scheduler, True,
                                   np.full(n, 0.125, np.float32), ties=True)
    assert (ours["n_events"] > flat["n_events"]).all()


@pytest.mark.parametrize("width", [128, 256])
def test_seg_frontier_explicit_widths_equal_the_reference(width):
    n, s = 200, 10
    lat = np.random.default_rng(7).uniform(0.05, 0.18, n).astype(np.float32)
    ours, _ = _seg_against_both((7,), n, s, "multitasc++", width, lat)
    assert ours["completed"][0] == n * s


def test_seg_frontier_scenarios_equal_the_reference():
    """Churn, offline windows and tiered switching through the segment
    slices: join / leave and the offline deferral survive the per-lane
    base offset."""
    n, s = 150, 12
    rng = np.random.default_rng(11)
    lat = rng.uniform(0.05, 0.2, n).astype(np.float32)
    total_t = float(lat.max()) * s
    kw = dict(
        tier_ids=rng.integers(0, 3, n).astype(np.int32),
        c_upper=np.asarray([0.85, 0.8, 0.75], np.float32),
        offline_start=np.where(rng.random(n) < 0.3,
                               rng.uniform(0.2, 0.6, n) * total_t,
                               np.inf).astype(np.float32),
        offline_for=rng.uniform(1.0, 3.0, n).astype(np.float32),
        join_t=np.where(rng.random(n) < 0.3,
                        rng.uniform(0.1, 0.4, n) * total_t,
                        0.0).astype(np.float32),
        leave_t=np.where(rng.random(n) < 0.3,
                         rng.uniform(0.5, 0.9, n) * total_t,
                         np.inf).astype(np.float32))
    ours, _ = _seg_against_both((11,), n, s, "multitasc++", True, lat, **kw)
    assert 0 < ours["completed"][0] < n * s


def test_seg_frontier_with_arrivals_equals_the_reference():
    """An arrival tensor (churn + drift) through the segmented gather of
    each device's next arrival."""
    n, s = 150, 8
    lat = np.linspace(0.04, 0.09, n).astype(np.float32)
    r = jscenarios.realize(jscenarios.SCENARIOS["churn_drift"], (3,), n, s,
                           lat)
    streams = jsynthetic.batched_device_streams(
        (3,), n, s, 0.72, [p.accuracy for p in SEG_SERVERS])
    outs = []
    for mod in (J, jaxsim, jaxsim):
        servers = SEG_SERVERS if mod is J else tuple(
            ServerProfile(**dataclasses.asdict(p)) for p in SEG_SERVERS)
        seg = False if len(outs) == 2 else True
        call = dict(device="cpu") if mod is jaxsim else {}
        outs.append(mod.run_sweep(
            mod.JaxSimSpec("multitasc++", n, s, model_switching=True),
            dict(streams, arrive=r["arrive"]), lat, lat * 2.5, servers,
            join_t=r["join_t"], leave_t=r["leave_t"], frontier_seg=seg,
            **call))
    ref, ours, flat = outs
    assert_port_matches(ref, ours)
    _assert_bitwise(ours, flat, skip=("n_events",))


def test_seg_frontier_is_automatic_from_seg_auto_min():
    """``frontier_seg=None`` at n = SEG_AUTO_MIN segments on both sides
    (G = 128, 16 segments): JAX's automatic run, n_events included."""
    n, s = jaxsim.SEG_AUTO_MIN, 3
    assert jaxsim._static_of(jaxsim.JaxSimSpec("static", n, s), 1,
                             0.1).seg == J._static_of(
        J.JaxSimSpec("static", n, s), 1, 0.1).seg == 128
    lat = np.full(n, 0.1, np.float32)
    ours = _seg_sweep(jaxsim, (5,), n, s, "multitasc++", None, lat)
    ref = _seg_sweep(J, (5,), n, s, "multitasc++", None, lat)
    assert_port_matches(ref, ours)
    assert ours["completed"][0] == n * s


@pytest.mark.parametrize("n_pad,frontier_seg", [
    (1024, None), (2048, None), (10112, None), (256, True), (10112, True),
    (256, 128), (256, 256), (384, 256), (640, False), (640, 0),
    (4096, False)])
def test_seg_layout_equals_the_reference(n_pad, frontier_seg):
    got = jaxsim._seg_layout(n_pad, frontier_seg)
    assert got == J._seg_layout(n_pad, frontier_seg)
    seg, padded = got
    assert padded >= n_pad and (seg == 0 or padded % seg == 0)


@pytest.mark.parametrize("shards", [2, 4, 3])
@pytest.mark.parametrize("n_pad,frontier_seg", [
    (384, None), (1024, None), (10112, None), (256, True), (384, 128),
    (10112, 256)])
def test_seg_layout_with_device_shards_equals_the_reference(n_pad,
                                                            frontier_seg,
                                                            shards):
    """Sharded, the frontier is segmented even below SEG_AUTO_MIN, and
    n_pad rounds up to whole segments on every shard."""
    got = jaxsim._seg_layout(n_pad, frontier_seg, shards)
    assert got == J._seg_layout(n_pad, frontier_seg, shards)
    seg, padded = got
    assert seg and padded >= n_pad and padded % (seg * shards) == 0


@pytest.mark.parametrize("frontier_seg", [100, 129, -128, 64])
def test_seg_layout_rejects_widths_off_the_bucket(frontier_seg):
    with pytest.raises(ValueError, match="multiple of 128"):
        jaxsim._seg_layout(256, frontier_seg)
    with pytest.raises(ValueError, match="multiple of 128"):
        J._seg_layout(256, frontier_seg)


def _state_np(state):
    out = {k: np.asarray(v) for k, v in state.items() if k != "traces"}
    out["traces"] = {k: np.asarray(v) for k, v in state["traces"].items()}
    return out


def _assert_state_matches(ours, ref):
    assert ours.keys() == ref.keys()
    for k in ref:
        if k == "traces":
            for t, v in ref[k].items():
                if t in EXACT_TRACES:
                    np.testing.assert_array_equal(ours[k][t], v, err_msg=t)
                else:
                    np.testing.assert_allclose(ours[k][t], v, rtol=AGG_RTOL,
                                               atol=0, equal_nan=True,
                                               err_msg=t)
        else:
            assert ours[k].shape == ref[k].shape, k
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


@pytest.mark.parametrize("n,s,steps", [(9, 30, 120), (jaxsim.SEG_AUTO_MIN, 2,
                                                      60)],
                         ids=["flat", "segmented"])
def test_lane_stepper_equals_the_reference(n, s, steps):
    """Two lanes (MultiTASC++ and Static) from their initial carry through
    ``steps`` single trips of each package's stepper, held after every
    tenth; the port's ``step`` leaves its argument as it was."""
    rng = np.random.default_rng(3)
    lat = rng.uniform(0.05, 0.12, (2, n)).astype(np.float32)
    streams = jsynthetic.batched_device_streams(
        (0, 1), n, s, 0.72, [p.accuracy for p in SEG_SERVERS])
    sides = []
    for mod in (J, jaxsim):
        servers = SEG_SERVERS if mod is J else tuple(
            ServerProfile(**dataclasses.asdict(p)) for p in SEG_SERVERS)
        specs = [mod.JaxSimSpec(x, n, s, model_switching=True)
                 for x in ("multitasc++", "static")]
        call = dict(device="cpu") if mod is jaxsim else {}
        sides.append(mod.lane_stepper(specs, streams, lat, lat * 2.0,
                                      servers, **call))
    (jst, jstep, jstatic), (st, step, static) = sides
    assert dataclasses.asdict(static) == dataclasses.asdict(jstatic)
    assert ("seg_min" in st) == (n >= jaxsim.SEG_AUTO_MIN)
    _assert_state_matches(_state_np(st), _state_np(jst))
    for i in range(1, steps + 1):
        before = st["dev_next"].clone()
        nxt = step(st)
        assert torch.equal(st["dev_next"], before)
        st, jst = nxt, jstep(jst)
        if i % 10 == 0:
            _assert_state_matches(_state_np(st), _state_np(jst))
    assert int(st["n_events"].min()) > 0
