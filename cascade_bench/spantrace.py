"""The slice's program spans joined to its device trace, on one clock.

``SpanTrace`` is ``devtrace.DeviceTrace`` with the program's span recorder
(``repro_torch.serving.spans``) on for exactly the profiled slice: it
turns the recorder on right before the profiler starts and drains it right
after the profiler stops. Its summary is ``DeviceTrace``'s, every key as
it was, plus ``"spans"``: the drained spans, the trace's device ops and
CUDA runtime calls with their ``correlation`` ids, its
``baseTimeNanoseconds``, and the counters' deltas over the slice.

One clock. Kineto writes every event in microseconds after the trace's
``baseTimeNanoseconds``, Unix time; the spans are in ``perf_counter_ns``.
``clock_map`` maps the first onto the second through the recorder's two
clock pairs ``(perf_counter_ns, time_ns)``, one from each end of the
slice. ``Joined.misfit_ns`` checks the map against two things that
cannot happen: a kernel starting before its own launch call, and a copy
to the host ending after the read that waited for it returned. A kernel
is joined to its launching call by ``correlation``, and a call to the
thread that made it by its ``tid``: the native id where Kineto has the
thread on record, else the low 32 bits of its pthread id, which the
recorder's thread table maps. Neither matched in some runs on the H100,
so ``thread_map`` also learns a tid from the spans its calls fall in
(where no tid maps at all, calls are joined by time alone:
``Joined.by_time``).

``Joined`` answers the per-layer readers (``metrics/idle_launch_pct.py``,
``idle_loop_pct.py``, ``launches_per_batch.py``, ``head_pct.py``,
``queue_wait_ms_p90.py``) and the breakdown's ``idle_by_span``,
``counters`` and ``clock_misfit_us`` (``breakdown``). Every idle instant
of the slice window ``[t1 - slice_s, t1]`` (``t1`` the last slice
batch's end; the window ``idle_pct`` reads) falls in exactly one class:
``launch`` where some thread is inside ``engine.forward``, else ``copy``
where one is inside ``engine.stack``, ``engine.copy_in`` or
``engine.copy_out``, else ``loop``, which is split by the first of
``LOOP_SPANS`` open on any thread, or ``none``.
"""
from __future__ import annotations

import bisect
import json
import os
import statistics
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

from .devtrace import DEVICE_CATS, DeviceTrace, summarize

RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
LAUNCH_SPANS = ("engine.forward",)
COPY_SPANS = ("engine.stack", "engine.copy_in", "engine.copy_out")
LOOP_SPANS = ("transport.barrier", "transport.wait_result",
              "transport.pool_wait", "transport.cluster")
WAIT_SPANS = ("transport.barrier", "transport.wait_result",
              "transport.pool_wait", "queue.wait")

Intervals = List[Tuple[float, float]]


def _counters(queue) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.serving import executables
    return {"classify_misses": executables.cache_stats()["misses"],
            "launches": ops.launch_counts(),
            "queue_peak": queue.peak if queue is not None else 0}


def _delta(a: dict, b: dict) -> dict:
    return {"classify_misses": b["classify_misses"] - a["classify_misses"],
            "launches": {k: b["launches"][k] - a["launches"].get(k, 0)
                         for k in b["launches"]},
            "queue_peak": b["queue_peak"] - a["queue_peak"]}


def trace_parts(doc: dict) -> dict:
    """From an exported Chrome trace: its time base, its device ops
    (name, ts us, dur us, correlation, category) and its CUDA runtime and
    driver calls (name, ts us, dur us, tid, correlation)."""
    dev, rt = [], []
    for e in doc.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        corr = e.get("args", {}).get("correlation")
        if cat in DEVICE_CATS:
            dev.append((e["name"], float(e["ts"]), float(e.get("dur", 0.0)),
                        corr, cat))
        elif cat in RUNTIME_CATS:
            tid = e.get("tid")     # a pthread id's low 32 bits, signed
            rt.append((e["name"], float(e["ts"]), float(e.get("dur", 0.0)),
                       tid & 0xFFFFFFFF if isinstance(tid, int) else None,
                       corr))
    return {"base_ns": int(doc.get("baseTimeNanoseconds", 0)),
            "device": dev, "runtime": rt}


class SpanTrace(DeviceTrace):
    """``DeviceTrace`` with the span recorder on over the slice, and the
    counters read at both ends. ``queue``: the engine's ``RequestQueue``
    (its ``peak``), or None."""

    def __init__(self, queue=None):
        super().__init__()
        self.queue = queue
        self._before: Optional[dict] = None
        self.summary: Optional[Dict] = None   # the last stop()'s

    def start(self) -> None:
        # the recorder is imported here, so that this module loads beside
        # a program that has none
        from repro_torch.serving import spans
        self._before = _counters(self.queue)
        spans.enable()
        super().start()

    def stop(self) -> Optional[Dict]:
        if self._prof is None:
            return None
        from repro_torch.serving import spans
        self._prof.stop()
        drained = spans.drain()
        after = _counters(self.queue)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
        finally:
            os.unlink(path)
        self._prof = None
        summary = summarize(doc.get("traceEvents", []))
        summary["spans"] = dict(trace_parts(doc), drained=drained,
                                counters=_delta(self._before, after))
        self.summary = summary
        return summary


def clock_map(pairs, base_ns: int) -> Callable[[float], float]:
    """Kineto's ``ts`` (us after ``base_ns``, Unix time) -> perf_counter ns,
    linear through the two (perf_counter_ns, time_ns) pairs."""
    (p0, u0), (p1, u1) = pairs
    scale = (p1 - p0) / (u1 - u0) if u1 != u0 else 1.0
    off = base_ns - u0
    return lambda ts: p0 + (off + ts * 1e3) * scale


def union(iv: Intervals) -> Intervals:
    out: Intervals = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _overlap(a: Intervals, b: Intervals, keep: bool) -> Intervals:
    """a & b (keep) or a - b (not keep), both sorted and disjoint."""
    out: Intervals = []
    j = 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        cur, k = s, j
        while k < len(b) and b[k][0] < e:
            lo, hi = max(b[k][0], s), min(b[k][1], e)
            if keep:
                out.append((lo, hi))
            elif lo > cur:
                out.append((cur, lo))
            cur = max(cur, hi)
            k += 1
        if not keep and cur < e:
            out.append((cur, e))
    return out


def measure(iv: Intervals) -> float:
    return sum(b - a for a, b in iv)


def _count_inside(ts: List[float], iv: Intervals) -> int:
    """How many of the sorted times ``ts`` fall in the sorted disjoint
    intervals ``iv``."""
    n, j = 0, 0
    for t in ts:
        while j < len(iv) and iv[j][1] < t:
            j += 1
        n += j < len(iv) and iv[j][0] <= t
    return n


def thread_map(calls: list, spans: list, threads: Dict[int, int]) -> dict:
    """Each runtime call's raw ``tid`` -> the native id of the recording
    thread. Kineto writes the native id where it has the thread on record,
    else a pthread id's low 32 bits; where neither names a recorded
    thread, the thread inside whose spans at least 95% of the tid's calls
    fall, and more than inside any other thread's (not counting
    ``WAIT_SPANS``: a thread waits there, it launches nothing). ``calls``:
    (start ns, raw tid)."""
    known = {n: n for n in threads}
    known.update({i & 0xFFFFFFFF: n for n, i in threads.items()})
    at: Dict = {}
    for t, tid in calls:
        if tid not in known:
            at.setdefault(tid, []).append(t)
    cover = {k: union([(s.start, s.end) for s in spans
                       if s.tid == k and s.name not in WAIT_SPANS])
             for k in {s.tid for s in spans}}
    for tid, ts in at.items():
        ts.sort()
        votes = sorted(((_count_inside(ts, iv), k)
                        for k, iv in cover.items()), reverse=True)
        if votes and votes[0][0] >= 0.95 * len(ts) and \
                (len(votes) == 1 or votes[0][0] > votes[1][0]):
            known[tid] = votes[0][1]
    return known


class Joined:
    """The slice's spans and trace on ``perf_counter_ns``; ``t0``/``t1``:
    the slice window in ns. ``misfit_ns`` checks the clock map against
    what cannot happen."""

    def __init__(self, parts: dict, t0: float, t1: float):
        drained = parts["drained"]
        to_perf = clock_map(drained.pairs, parts["base_ns"])
        self.t0, self.t1 = t0, t1
        self.spans = drained.spans
        self.counters = parts["counters"]
        calls = [(to_perf(ts), to_perf(ts + dur), tid, corr, name)
                 for name, ts, dur, tid, corr in parts["runtime"]]
        native = thread_map([(c[0], c[2]) for c in calls], self.spans,
                            drained.threads)
        self.runtime = [(a, b, native.get(tid), corr, name)
                        for a, b, tid, corr, name in calls]
        self.device = [(to_perf(ts), to_perf(ts + dur), corr, name, cat)
                       for name, ts, dur, corr, cat in parts["device"]]
        self.kernel_corr = {c for _, _, c, _, cat in self.device
                            if cat == "kernel"}
        # where no runtime call's thread is one the recorder saw, join by
        # time alone: a call falls in a span open on any thread
        self.by_time = bool(self.runtime) and \
            all(r[2] is None for r in self.runtime)
        self._tids = sorted({s.tid for s in self.spans})
        self._index: Dict[Tuple[str, int], Tuple[list, list]] = {}
        self._idle: Optional[Dict[str, float]] = None

    def named(self, *names) -> list:
        return [s for s in self.spans if s.name in names]

    def _spans_on(self, name: str, tid) -> Tuple[list, list]:
        key = (name, tid)
        if key not in self._index:
            on = sorted((s for s in self.spans
                         if s.name == name and s.tid == tid),
                        key=lambda s: s.start)
            self._index[key] = ([s.start for s in on], on)
        return self._index[key]

    def inside(self, name: str, tid, t: float):
        """The ``name`` span open on thread ``tid`` (on any thread where
        joining ``by_time``) at ``t``, or None (one thread's spans of one
        name do not overlap)."""
        for k in (self._tids if self.by_time else (tid,)):
            starts, on = self._spans_on(name, k)
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and on[i].end >= t:
                return on[i]
        return None

    def launches(self) -> list:
        """(start, tid, correlation) of each runtime call that launched a
        kernel of the trace."""
        return [(s, tid, c) for s, _, tid, c, _ in self.runtime
                if c in self.kernel_corr]

    # -- the readers -------------------------------------------------
    def idle_by_span(self) -> Dict[str, float]:
        """Idle ns of the window by class (``launch``, ``copy``,
        ``loop/<transport span>``, ``loop/none``)."""
        if self._idle is not None:
            return self._idle
        busy = union([(max(a, self.t0), min(b, self.t1))
                      for a, b, *_ in self.device
                      if b > self.t0 and a < self.t1])
        rest = _overlap([(self.t0, self.t1)], busy, keep=False)
        out = {}
        for label, names in ([("launch", LAUNCH_SPANS), ("copy", COPY_SPANS)]
                             + [(f"loop/{n}", (n,)) for n in LOOP_SPANS]):
            cover = union([(s.start, s.end) for s in self.named(*names)])
            out[label] = measure(_overlap(rest, cover, keep=True))
            rest = _overlap(rest, cover, keep=False)
        out["loop/none"] = measure(rest)
        self._idle = out
        return out

    def idle_pct(self, cls: str) -> float:
        parts = self.idle_by_span()
        ns = sum(v for k, v in parts.items()
                 if k == cls or k.startswith(cls + "/"))
        return 100.0 * ns / (self.t1 - self.t0)

    def launches_per_batch(self) -> Optional[float]:
        fwd = self.named("engine.forward")
        if not fwd:
            return None
        n = sum(self.inside("engine.forward", tid, s) is not None
                for s, tid, _ in self.launches())
        return n / len(fwd)

    def head_device_ns(self) -> float:
        """Device ns of the ops launched inside ``model.head`` spans within
        ``engine.forward``: the server's head, and not a device client's."""
        corr = {c for s, _, tid, c, _ in self.runtime
                if self.inside("model.head", tid, s) is not None
                and self.inside("engine.forward", tid, s) is not None}
        return sum(b - a for a, b, c, *_ in self.device if c in corr)

    def queue_waits_ms(self) -> List[float]:
        return [(s.end - s.start) * 1e-6 for s in self.named("queue.wait")]

    def copy_in_offsets_ns(self) -> Dict[int, float]:
        """For each ``engine.copy_in`` span the trace covers (by batch id):
        where its host-to-device copy started, joined by ``correlation``
        to its runtime call and by thread and time to the span: 0 inside
        the span, negative before it (a misfit of the clock map), positive
        after it. The copy blocks the host until it is staged, not until
        it ran: it runs after whatever the other worker queued ahead of
        it. inf where no copy was joined."""
        first = min((a for a, *_ in self.device), default=float("inf"))
        out = {s.key: float("inf") for s in self.named("engine.copy_in")
               if s.end >= first}
        rt = {c: (s, tid) for s, _, tid, c, _ in self.runtime}
        for a, _, c, name, cat in self.device:
            if cat != "gpu_memcpy" or "HtoD" not in name or c not in rt:
                continue
            s, tid = rt[c]
            sp = self.inside("engine.copy_in", tid, s)
            if sp is not None and sp.key in out:
                off = a - sp.start if a < sp.start else max(a - sp.end, 0.0)
                out[sp.key] = off if abs(off) < abs(out[sp.key]) \
                    else out[sp.key]
        return out


    @property
    def misfit_ns(self) -> Dict[str, float]:
        """How far the clock map puts device ops where they cannot be, the
        second worst case of each kind (one wrong join moves nothing), 0
        where none is: ``early``, a kernel before its own launch call;
        ``late``, a copy to the host past the end of the
        ``engine.copy_out`` span whose read waited for it. On an H100
        Kineto's device clock drifted against its runtime calls' by up to
        3% over a 5-10 s slice, up to 67 ms early or 106 ms late, so an
        idle instant near a span's edge can fall in the neighbouring
        class."""
        rt = {c: (s, tid) for s, _, tid, c, _ in self.runtime}
        early, late = [0.0, 0.0], [0.0, 0.0]
        for a, b, c, name, cat in self.device:
            if c not in rt:
                continue
            s, tid = rt[c]
            if cat == "kernel":
                early.append(s - a)
            elif cat == "gpu_memcpy" and "DtoH" in name:
                sp = self.inside("engine.copy_out", tid, s)
                if sp is not None:
                    late.append(b - sp.end)
        return {"early": sorted(early)[-2], "late": sorted(late)[-2]}


def joined(run) -> Optional[Joined]:
    """The slice's ``Joined`` (made once per run), or None where the slice
    was traced without spans."""
    tr = run.trace
    if not tr or "spans" not in tr or not run.slice_batches \
            or not run.slice_s:
        return None
    if "_joined" not in tr:
        t1 = max(b.t1 for b in run.slice_batches) * 1e9
        tr["_joined"] = Joined(tr["spans"], t1 - run.slice_s * 1e9, t1)
    return tr["_joined"]


def breakdown(run) -> Dict:
    """The breakdown's keys from spans: ``idle_by_span`` ([class,
    seconds], largest first), ``counters`` (deltas over the slice of the
    classify cache's misses, the kernels' launch counts and the queue's
    peak) and ``clock_misfit_us`` (``Joined.misfit_ns``). Empty where the
    slice has no spans."""
    j = joined(run)
    if j is None:
        return {}
    parts = j.idle_by_span()
    return {"idle_by_span": sorted(([k, v * 1e-9] for k, v in parts.items()),
                                   key=lambda kv: -kv[1]),
            "counters": j.counters,
            "clock_misfit_us": {k: v * 1e-3 for k, v in j.misfit_ns.items()}}


def quantile90(values: List[float]) -> Optional[float]:
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=10, method="inclusive")[8]
