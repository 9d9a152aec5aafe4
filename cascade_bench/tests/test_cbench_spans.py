"""The span readers (``spantrace.py`` and the five metrics that read it) on
a synthetic slice: two workers' batches, the dispatch thread's waits, and
a Chrome trace of their device ops and runtime calls written in Unix time
with a clock drift. On a card: the test cell traced with the recorder on,
its threads joined, its clock map checked, each traced batch's copy inside
its ``engine.copy_in`` span."""
import json

import numpy as np
import pytest

from cascade_bench import catalog, devtrace, harness, spantrace
from cascade_bench.fleet import Batch
from cascade_bench.harness import Run
from repro_torch.serving import spans

READERS = ("idle_launch_pct", "idle_loop_pct", "launches_per_batch",
           "head_pct", "queue_wait_ms_p90")
UNITS = {"idle_launch_pct": "%", "idle_loop_pct": "%",
         "launches_per_batch": "launches", "head_pct": "%",
         "queue_wait_ms_p90": "ms"}

P0, U0 = 5_000_000_000, 1_790_000_000_000_000_000   # the first clock pair
SCALE = 1.0 / (1.0 + 1e-5)        # perf ns per Unix ns: a 10 ppm drift
BASE = U0 - 7_000_000_000         # the trace's baseTimeNanoseconds
NATIVE = {"w1": 101, "w2": 102, "dispatch": 103, "ingest": 104}
IDENT = {k: 0x7F00_0000_0000 + 0x1000 * v for k, v in NATIVE.items()}


def ns(us):
    """A time given in us after P0, as perf_counter ns."""
    return P0 + us * 1000


def ts(us):
    """The same instant as Kineto writes it: us after BASE, Unix time."""
    return ((ns(us) - P0) / SCALE + (U0 - BASE)) / 1e3


def pairs(end_us):
    """The clock pairs at P0 and ``end_us`` (whole ns at 1,000 us)."""
    return ((P0, U0), (ns(end_us), U0 + round(end_us * 1000 / SCALE)))


def mk(name, thread, a, b, key=None, parent=None):
    s = spans.Span(name, key)
    s.start, s.end, s.tid = ns(a), ns(b), NATIVE[thread]
    s.parent = parent.id if parent is not None else 0
    return s


def batch_spans(thread, key, t):
    """One batch's execute and children; t: (stack, copy_in, forward,
    head start, head end, copy_out, end), us."""
    ex = mk("engine.execute", thread, t[0], t[6], key)
    fwd = mk("engine.forward", thread, t[2], t[5], key, ex)
    return [ex, mk("engine.stack", thread, t[0], t[1], key, ex),
            mk("engine.copy_in", thread, t[1], t[2], key, ex), fwd,
            mk("model.head", thread, t[3], t[4], None, fwd),
            mk("engine.copy_out", thread, t[5], t[6], key, ex)]


def slice_spans():
    return (batch_spans("w1", 0, (100, 120, 150, 260, 290, 300, 400))
            + batch_spans("w2", 1, (420, 430, 460, 580, 595, 600, 700))
            + [mk("transport.wait_result", "dispatch", 50, 410),
               mk("transport.pool_wait", "w2", 300, 420, 1),
               mk("transport.barrier", "dispatch", 710, 800),
               mk("transport.cluster", "ingest", 800, 900)]
            + [mk("queue.wait", "dispatch", 0, w, (0, i))
               for i, w in enumerate((10, 20, 30, 40, 50, 60, 70, 80, 90,
                                      100))])


# device ops: (name, cat, start us, end us, correlation) and the runtime
# calls that made them: (name, thread, at us, correlation)
DEVICE = [("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 125, 128, 1),
          ("gemm_kernel", "kernel", 155, 200, 2),
          ("moe_kernel", "kernel", 205, 250, 3),
          ("head_gemm_kernel", "kernel", 265, 285, 4),
          ("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 300, 302, 5),
          ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 440, 443, 6),
          ("gemm_kernel", "kernel", 470, 560, 7),
          ("head_gemm_kernel", "kernel", 585, 592, 8),
          ("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 600, 603, 9),
          ("stray_kernel", "kernel", 650, 651, 10),
          ("stray_kernel", "kernel", 720, 721, 11)]
RUNTIME = [("cudaMemcpyAsync", "w1", 121, 1),
           ("cudaLaunchKernel", "w1", 155, 2),
           ("cudaLaunchKernel", "w1", 205, 3),
           ("cuLaunchKernel", "w1", 265, 4),
           ("cudaMemcpyAsync", "w1", 300, 5),
           ("cudaMemcpyAsync", "w2", 432, 6),
           ("cudaLaunchKernel", "w2", 470, 7),
           ("cudaLaunchKernel", "w2", 585, 8),
           ("cudaMemcpyAsync", "w2", 600, 9),
           # during w1's forward, but from w2, which is not in one
           ("cudaLaunchKernel", "w2", 155, 10),
           # during w2's forward, from a thread the recorder never saw,
           # whose other call falls in no span
           ("cudaLaunchKernel", None, 470, 11),
           ("cudaDeviceSynchronize", None, 920, 13)]
WINDOW = (50, 950)


def chrome(device=DEVICE, runtime=RUNTIME):
    ev = [{"ph": "X", "cat": cat, "name": n, "ts": ts(a),
           "dur": ts(b) - ts(a), "pid": 0, "tid": 7,
           "args": {"correlation": c}} for n, cat, a, b, c in device]
    ev += [{"ph": "X", "cat": "cuda_runtime", "name": n, "ts": ts(at),
            "dur": 1.0, "pid": 1,
            "tid": (IDENT[th] & 0xFFFFFFFF) if th else 999,
            "args": {"correlation": c}} for n, th, at, c in runtime]
    return {"traceEvents": ev, "baseTimeNanoseconds": BASE}


def make_run(span_list=None, device=DEVICE, runtime=RUNTIME,
             counters=None):
    doc = chrome(device, runtime)
    summary = devtrace.summarize(doc["traceEvents"])
    if span_list is not None:
        drained = spans.Drained(span_list, pairs(1000),
                                {v: IDENT[k] for k, v in NATIVE.items()})
        summary["spans"] = dict(spantrace.trace_parts(doc), drained=drained,
                                counters=counters or {})
    t1 = ns(WINDOW[1]) * 1e-9
    last = Batch(t1 - 1e-3, t1, 2, [(0, 0)], np.zeros(1), np.zeros(1, int),
                 "slice")
    return Run({}, {}, 1.0, 0.0, 1.0, [], [], [last],
               (WINDOW[1] - WINDOW[0]) * 1e-6, summary)


def read(name, run):
    return catalog.reader(name)(run)


def test_clock_map_through_two_pairs():
    f = spantrace.clock_map(pairs(1000), BASE)
    for us in (0, 1, 123.456, 1000, 5000):
        assert f(ts(us)) == pytest.approx(ns(us), abs=0.5)
    # the drift is taken from the pairs: a map that ignored it would be
    # 10 ppm off, 50 ns at 5 ms
    assert abs(f(ts(5000)) - (P0 + (ts(5000) * 1e3 + BASE - U0))) > 40


def test_idle_classes_partition_idle_pct_exactly():
    run = make_run(slice_spans())
    parts = spantrace.joined(run).idle_by_span()
    want_us = {"launch": 83, "copy": 278, "loop/transport.wait_result": 60,
               "loop/transport.pool_wait": 10, "loop/transport.barrier": 89,
               "loop/transport.cluster": 100, "loop/none": 60}
    assert parts == pytest.approx({k: v * 1e3 for k, v in want_us.items()},
                                  abs=1e-3)
    span_us = WINDOW[1] - WINDOW[0]
    launch, loop = read("idle_launch_pct", run), read("idle_loop_pct", run)
    assert launch == pytest.approx(100 * 83 / span_us)
    assert loop == pytest.approx(100 * 319 / span_us)
    copy = 100 * parts["copy"] / (span_us * 1e3)
    # idle_pct takes the trace's busy time, 10 ppm of drift away
    assert launch + copy + loop == pytest.approx(read("idle_pct", run),
                                                 rel=1e-4)
    bd = spantrace.breakdown(run)
    assert dict(bd["idle_by_span"]) == pytest.approx(
        {k: v * 1e-6 for k, v in want_us.items()}, abs=1e-12)
    assert bd["idle_by_span"][0][0] == "copy"


def test_launches_joined_by_thread_and_time():
    run = make_run(slice_spans())
    # w1: correlations 2, 3, 4; w2: 7, 8. Not 10 (w2 outside its forward,
    # inside w1's), not 11 (a thread the recorder never saw), not the
    # copies.
    assert read("launches_per_batch", run) == pytest.approx(5 / 2)
    assert not spantrace.joined(run).by_time


def test_thread_map_learned_from_the_spans():
    spans_ = slice_spans()
    threads = {v: IDENT[k] for k, v in NATIVE.items()}
    w1 = [s for s in spans_ if s.tid == NATIVE["w1"]]
    inside = [(s.start + 1, 555) for s in w1]           # all in w1's spans
    half = [(ns(130), 777), (ns(915), 777)]             # one in, one out
    native = spantrace.thread_map(inside + half, spans_, threads)
    assert native[555] == NATIVE["w1"]
    assert 777 not in native
    assert native[IDENT["w2"] & 0xFFFFFFFF] == NATIVE["w2"]
    assert native[NATIVE["w2"]] == NATIVE["w2"]


def test_runtime_tids_are_read_as_unsigned_32_bits():
    doc = chrome()
    for e in doc["traceEvents"]:
        if e["cat"] == "cuda_runtime" and e["tid"] != 999:
            e["tid"] = e["tid"] - 2 ** 32        # as a signed int32
    tids = {r[3] for r in spantrace.trace_parts(doc)["runtime"]}
    assert tids == {IDENT["w1"] & 0xFFFFFFFF, IDENT["w2"] & 0xFFFFFFFF, 999}


def test_launches_by_time_alone_where_no_thread_maps():
    runtime = [(n, None, at, c) for n, _, at, c in RUNTIME]
    run = make_run(slice_spans(), runtime=runtime)
    assert spantrace.joined(run).by_time
    # by time, 10 (inside w1's forward) and 11 (inside w2's) count too
    assert read("launches_per_batch", run) == pytest.approx(7 / 2)


def test_head_share_follows_correlation_not_device_time():
    run = make_run(slice_spans())
    busy = run.trace["busy_s"]
    assert read("head_pct", run) == pytest.approx(
        100 * (20 + 7) * 1e-6 / busy, rel=1e-4)
    # the head's kernel launched inside model.head runs after the span;
    # another thread's kernel runs during it
    device = [d if d[4] != 4 else (d[0], d[1], 295, 299, 4) for d in DEVICE]
    device.append(("late_kernel", "kernel", 262, 264, 12))
    runtime = RUNTIME + [("cudaLaunchKernel", "w2", 150, 12)]
    run = make_run(slice_spans(), device, runtime)
    assert read("head_pct", run) == pytest.approx(
        100 * (4 + 7) * 1e-6 / run.trace["busy_s"], rel=1e-4)


def test_head_share_leaves_out_a_device_clients_head():
    """A light model's head, run on the ingestion thread inside
    ``transport.cluster`` and not inside ``engine.forward``, is not the
    server's head."""
    device = DEVICE + [("head_gemm_kernel", "kernel", 812, 820, 14)]
    runtime = RUNTIME + [("cudaLaunchKernel", "ingest", 812, 14)]
    run = make_run(slice_spans() + [mk("model.head", "ingest", 810, 830)],
                   device, runtime)
    assert read("head_pct", run) == pytest.approx(
        100 * (20 + 7) * 1e-6 / run.trace["busy_s"], rel=1e-4)


def test_queue_wait_p90():
    assert read("queue_wait_ms_p90", make_run(slice_spans())) == \
        pytest.approx(0.091)   # 10..100 us, inclusive: 91 us


def test_copy_in_offsets():
    j = spantrace.joined(make_run(slice_spans()))
    assert j.copy_in_offsets_ns() == {0: 0.0, 1: 0.0}
    # w2's copy queued behind w1's kernels: it runs 30 us after its span
    late = [d if d[4] != 6 else (d[0], d[1], 490, 493, 6) for d in DEVICE]
    j = spantrace.joined(make_run(slice_spans(), late))
    assert j.copy_in_offsets_ns() == pytest.approx({0: 0.0, 1: 30e3},
                                                   abs=1.0)
    # w1's copy mapped before its span (and its call): a clock misfit
    early = [d if d[4] != 1 else (d[0], d[1], 110, 113, 1) for d in DEVICE]
    j = spantrace.joined(make_run(slice_spans(), early))
    assert j.copy_in_offsets_ns()[0] == pytest.approx(-10e3, abs=1.0)
    # a batch whose copy the trace lacks
    gone = [d for d in DEVICE if d[4] != 6]
    j = spantrace.joined(make_run(slice_spans(), gone))
    assert j.copy_in_offsets_ns()[1] == float("inf")


def test_clock_misfits_early_kernels_and_late_copies_out():
    run = make_run(slice_spans())
    assert spantrace.joined(run).misfit_ns == {"early": 0.0, "late": 0.0}
    # two kernels mapped 7 and 9 us before their calls, one 1 s before
    # its call (a wrong join: the second worst case is read)
    early = {3: (196, 250), 7: (461, 560), 8: (-999415, 592)}
    device = [d if d[4] not in early else (d[0], d[1]) + early[d[4]] +
              (d[4],) for d in DEVICE]
    run = make_run(slice_spans(), device)
    assert spantrace.joined(run).misfit_ns == pytest.approx(
        {"early": 9e3, "late": 0.0}, abs=1.0)
    # w1's two copies out mapped to end 10 and 12 us after its read
    # (copy_out, 300-400 us) returned
    device = [d if d[4] != 5 else (d[0], d[1], 300, 412, 5) for d in device]
    device.append(("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 301,
                   410, 15))
    runtime = RUNTIME + [("cudaMemcpyAsync", "w1", 300.5, 15)]
    run = make_run(slice_spans(), device, runtime)
    assert spantrace.breakdown(run)["clock_misfit_us"] == pytest.approx(
        {"early": 9.0, "late": 10.0}, abs=1e-3)


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_without_spans(name):
    assert read(name, make_run(None)) is None
    no_trace = make_run(None)
    no_trace.trace = None
    assert read(name, no_trace) is None
    assert spantrace.breakdown(no_trace) == {}


class _FakeProfiler:
    def __init__(self, doc):
        self.doc, self.started, self.stopped = doc, False, False

    def start(self):
        assert spans.on(), "the recorder is on before the profiler starts"
        self.started = True

    def stop(self):
        assert spans.on(), "the recorder is still on as the profiler stops"
        self.stopped = True

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump(self.doc, f)


def test_span_trace_brackets_the_profiler(monkeypatch):
    from repro_torch.serving.queue import Request, RequestQueue
    prof = _FakeProfiler(chrome())
    monkeypatch.setattr(spantrace.SpanTrace, "_profile",
                        staticmethod(lambda: prof))
    q = RequestQueue()
    tracer = spantrace.SpanTrace(q)
    assert not spans.on()
    tracer.start()
    with spans.span("engine.forward", 3):
        pass
    for i in range(3):
        q.put(Request(i, None, 0.0, 0.0, payload=(i, None, 0)))
    summary = tracer.stop()
    assert prof.started and prof.stopped and not spans.on()
    assert summary is tracer.summary
    assert [s.name for s in summary["spans"]["drained"].spans] \
        == ["engine.forward"]
    assert summary["spans"]["counters"]["queue_peak"] == 3
    assert summary["spans"]["counters"]["classify_misses"] == 0
    assert summary["spans"]["base_ns"] == BASE
    assert len(summary["spans"]["device"]) == len(DEVICE)
    assert len(summary["spans"]["runtime"]) == len(RUNTIME)
    assert summary["busy_s"] == devtrace.summarize(
        chrome()["traceEvents"])["busy_s"]


@pytest.mark.cuda
def test_traced_tiny_run_maps_each_copy_into_its_span(tiny_cell, card,
                                                       monkeypatch):
    """The tiny cell traced with the recorder on: the runtime calls join
    their threads; every traced batch's copy to the card starts inside its
    ``engine.copy_in`` span, within 50 us; the five readers report; the
    three idle classes sum to ``idle_pct``; no classify function is built
    in the slice."""
    made = []

    def tracer():
        made.append(spantrace.SpanTrace())
        return made[-1]

    monkeypatch.setattr(harness, "DeviceTrace", tracer)
    tiny_cell.per_layer = tiny_cell.per_layer + [
        {"name": n, "unit": UNITS[n]} for n in READERS]
    out = harness.run_cell(tiny_cell, 2 ** 31 + 11, 2.0, True,
                           device=str(card))
    summary = made[0].summary
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(READERS) <= set(m)
    j = summary["_joined"]            # the readers' join of this run
    tids = {r[3] for r in summary["spans"]["runtime"]}
    assert not j.by_time, (sorted(tids, key=str)[:8],
                           summary["spans"]["drained"].threads)
    # the test cell's card never falls behind its host, so each copy runs
    # inside the span that issued it, once set on the host's clock
    off = j.copy_in_offsets_ns()
    assert len(off) >= harness.SLICE_BATCHES - 2
    assert all(abs(v) <= 50e3 for v in off.values()), off
    assert summary["spans"]["counters"]["classify_misses"] == 0
    parts = j.idle_by_span()
    assert 100 * sum(parts.values()) / (j.t1 - j.t0) == \
        pytest.approx(m["idle_pct"], abs=0.1)
