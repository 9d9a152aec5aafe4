"""Sim-vs-serving differential: replay synthetic streams through the live
serving engine and compare against ``repro_torch.sim.jaxsim``.

The port of the JAX package's ``serving/replay.py``. A calibrated
synthetic scenario (the ``streams`` dict ``jaxsim.run`` takes, plus an
optional churn schedule and arrival tensor from ``configs/scenarios.py``)
is replayed through the real ``run_cascade`` (or ``run_transport``) and
``ServerEngine``: queue, ladder buckets, in-flight slots, scheduler loop
and switching. Only the model forwards are replaced: device confidences
come from the stream through ``StreamClient``, server predictions from a
``ServedModel.oracle``. So the live half runs on the host; the simulator
half runs where ``device`` says, the card unless the caller asks for the
CPU.

``SERVING_TOL`` holds the JAX package's numbers. The live loop keeps
float64 event times where the simulator keeps float32, so a knife-edge
confidence can flip once and an adaptive scheduler then follows a
slightly different trajectory (``static``, decision-identical, is held
tight); and jaxsim credits a server batch to the window of its launch,
the live loop to the window of its finish. Conservation is exact: both
sides complete the same sample set.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.cascade_tiers import DeviceProfile, ServerProfile
from repro_torch.core.slo import WindowedSLOTracker
from repro_torch.serving.cascade import CascadeResult, run_cascade
from repro_torch.serving.engine import ServedModel, ServerEngine
from repro_torch.serving.queue import RequestQueue
from repro_torch.serving.transport import run_transport
from repro_torch.sim import events, jaxsim

# transport name -> cascade driver: "event" is the one-thread
# virtual-clock loop, "async" the threaded wall-clock transport (same
# results, overlapped execution)
TRANSPORTS = {"event": run_cascade, "async": run_transport}

# the JAX package's sim-vs-serving tolerances, per scheduler
SERVING_TOL = {
    "static": dict(sr=1.0, thr_rel=0.02, fwd=0.01),
    "multitasc": dict(sr=3.0, thr_rel=0.05, fwd=0.05),
    "multitasc++": dict(sr=3.0, thr_rel=0.05, fwd=0.05),
}


class StreamClient:
    """Duck-typed ``DeviceClient`` whose samples are indices into a
    pre-generated calibrated stream: ``run_local(j)`` returns the stream's
    confidence and correctness (as a prediction against label 1) instead
    of running a light model. Latency, SLO and threshold semantics are the
    live client's."""

    def __init__(self, device_id: int, confidence, correct_light,
                 latency: float, slo: float, window: float,
                 threshold: float):
        self.device_id = device_id
        self.profile = DeviceProfile(f"replay{device_id}", "synthetic",
                                     "low", 0.72, float(latency))
        self.slo = float(slo)
        self.window = float(window)
        self.threshold = float(threshold)
        self.tracker = WindowedSLOTracker(self.slo, self.window)
        self._conf = np.asarray(confidence, np.float32)
        self._cl = np.asarray(correct_light)

    def run_local(self, j) -> tuple:
        j = int(j)
        conf = float(self._conf[j])
        # a prediction against the constant label 1: correct iff the
        # stream says the light model is right on this sample
        return conf, int(self._cl[j]), conf < self.threshold

    def record_completion(self, latency: float) -> None:
        self.tracker.record(latency)

    def maybe_report(self, now: float):
        return self.tracker.maybe_report(now)


def _oracle(correct_heavy: np.ndarray, sidx: int):
    """Server-side oracle for served model ``sidx``: the prediction for
    request (device i, sample j) is ``correct_heavy[i, j, sidx]``."""

    def oracle(reqs):
        pred = np.array([correct_heavy[r.device_id, int(r.sample), sidx]
                         for r in reqs], np.int32)
        return np.ones(len(reqs), np.float32), pred

    return oracle


def replay_cascade(scheduler_name: str, streams: Dict, latencies, slos,
                   servers: Sequence[ServerProfile], *,
                   window: float = 1.5, init_threshold: float = 0.5,
                   static_threshold: float = 0.35,
                   model_switching: bool = False, tier_ids=None,
                   c_upper=None, join_t=None, leave_t=None,
                   max_in_flight: int = 1,
                   queue: Optional[RequestQueue] = None,
                   transport: str = "event") -> CascadeResult:
    """Replay a synthetic scenario through the live serving path.

    ``streams``: the ``jaxsim.run`` dict (``confidence`` /
    ``correct_light`` (N, S), ``correct_heavy`` (N, S, P), optional
    ``arrive`` (N, S)), with per-device ``latencies`` / ``slos`` (N,) and
    the server ladder. ``transport`` picks the driver (``TRANSPORTS``).
    Returns the live ``CascadeResult``.
    """
    conf = np.asarray(streams["confidence"], np.float32)
    cl = np.asarray(streams["correct_light"])
    ch = np.asarray(streams["correct_heavy"])
    if ch.ndim == 2:
        ch = ch[..., None]
    n, s = conf.shape
    latencies = np.broadcast_to(np.asarray(latencies, np.float64), (n,))
    slos = np.broadcast_to(np.asarray(slos, np.float64), (n,))
    init = static_threshold if scheduler_name == "static" else init_threshold
    clients = [StreamClient(i, conf[i], cl[i], latencies[i], slos[i],
                            window, init) for i in range(n)]
    engine = ServerEngine(
        [ServedModel(p.name, None, p, oracle=_oracle(ch, k))
         for k, p in enumerate(servers)],
        max_in_flight=max_in_flight, queue=queue)
    sched = events.make_scheduler(
        scheduler_name, n, server_profile=servers[0],
        slo=float(slos.min()), init_threshold=init_threshold,
        static_threshold=static_threshold)
    datasets = [np.arange(s)] * n
    labels = [np.ones(s, np.int64)] * n
    return TRANSPORTS[transport](
        clients, engine, sched, datasets, labels, window=window,
        model_switching=model_switching, tier_ids=tier_ids,
        c_upper=c_upper, join_t=join_t, leave_t=leave_t,
        arrive=streams.get("arrive"))


def serving_vs_sim(scheduler_name: str, streams: Dict, latencies, slos,
                   servers: Sequence[ServerProfile], *,
                   window: float = 1.5, init_threshold: float = 0.5,
                   static_threshold: float = 0.35,
                   model_switching: bool = False, tier_ids=None,
                   c_upper=None, join_t=None, leave_t=None,
                   transport: str = "event", device="cuda") \
        -> Tuple[CascadeResult, Dict, Dict]:
    """One scenario through both the live serving path (on the host) and
    the simulator (on ``device``); returns ``(live, sim, deltas)``.

    ``deltas``: ``d_sr`` (SR points), ``d_thr_rel`` (relative
    throughput), ``d_fwd`` (forwarded fraction), ``d_acc`` (accuracy) and
    ``d_completed`` (completions, 0 expected always). Compare against
    ``SERVING_TOL[scheduler]``.
    """
    n, s = np.asarray(streams["confidence"]).shape
    live = replay_cascade(
        scheduler_name, streams, latencies, slos, servers, window=window,
        init_threshold=init_threshold, static_threshold=static_threshold,
        model_switching=model_switching, tier_ids=tier_ids,
        c_upper=c_upper, join_t=join_t, leave_t=leave_t,
        transport=transport)
    spec = jaxsim.JaxSimSpec(
        scheduler=scheduler_name, n_devices=n, samples_per_device=s,
        window=window, init_threshold=init_threshold,
        static_threshold=static_threshold,
        model_switching=model_switching)
    sim = jaxsim.run(spec, streams, np.asarray(latencies, np.float32),
                     np.asarray(slos, np.float32), tuple(servers),
                     tier_ids=tier_ids, c_upper=c_upper,
                     join_t=join_t, leave_t=leave_t, device=device)
    thr = float(sim["throughput"])
    deltas = {
        "d_sr": abs(live.sr - float(sim["sr"])),
        "d_thr_rel": abs(live.throughput - thr) / max(thr, 1e-9),
        "d_fwd": abs(live.forwarded_frac - float(sim["forwarded_frac"])),
        "d_acc": abs(live.accuracy - float(sim["accuracy"])),
        "d_completed": abs(live.completed - int(sim["completed"])),
    }
    return live, sim, deltas
