"""The readers' arithmetic on synthetic timings and a synthetic trace."""
import statistics

import numpy as np
import pytest

from cascade_bench import catalog, counts, devtrace
from cascade_bench.fleet import Batch
from cascade_bench.harness import Run

CFG = {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
       "head_dim": 16, "d_ff": 96, "moe_d_ff": 32, "vocab_size": 300,
       "num_experts": 4, "num_experts_per_tok": 2, "num_shared_experts": 1,
       "first_dense_layers": 1}
TRAFFIC = {"sample_tokens": 10, "server_profile": {"max_batch": 32}}


def batch(t0, t1, n, phase="window"):
    keys = [(0, j) for j in range(n)]
    return Batch(t0, t1, n, keys, np.zeros(n), np.zeros(n, int), phase)


def make_run(batches, executed=None, trace=None, slice_batches=(),
             slice_s=None, t_start=0.0, t_end=2.0):
    return Run(CFG, TRAFFIC, 5.0, t_start, t_end,
               list(executed if executed is not None else batches),
               list(batches), list(slice_batches), slice_s, trace)


def read(name, run):
    return catalog.reader(name)(run)


BATCHES = [batch(0.0, 0.3, 4), batch(0.2, 0.5, 8), batch(0.9, 1.0, 2),
           batch(1.1, 1.6, 16)]


def test_served_per_s():
    assert read("served_per_s", make_run(BATCHES)) == pytest.approx(30 / 2.0)


def test_batch_ms_p90_over_every_batch():
    times = [300.0, 300.0, 100.0, 500.0]
    want = statistics.quantiles(times, n=10, method="inclusive")[8]
    assert read("batch_ms_p90", make_run(BATCHES)) == pytest.approx(want)
    # inclusive quantiles of 4 values: 0.9 of the way, 3 gaps along
    assert want == pytest.approx(300 + 0.7 * 200)


def test_host_ms_per_batch_counts_overlap_once_and_clips():
    late = batch(1.8, 2.4, 8)           # runs past the window's close
    run = make_run(BATCHES, executed=BATCHES + [late])
    busy = 0.5 + 0.1 + 0.5 + 0.2        # [0, 0.5], [0.9, 1], [1.1, 1.6], [1.8, 2]
    assert read("host_ms_per_batch", run) == \
        pytest.approx((2.0 - busy) * 1e3 / 4)


def test_batch_fill_pct():
    assert read("batch_fill_pct", make_run(BATCHES)) == \
        pytest.approx(100 * 7.5 / 32)


def test_mfu():
    flops = sum(counts.classify_flops(CFG, b.bucket, 10) for b in BATCHES)
    assert read("mfu", make_run(BATCHES)) == \
        pytest.approx(100 * flops / (2.0 * 67e12))


def trace_events():
    """Two batches' worth of device ops, in microseconds."""
    ev = [("Memcpy HtoD (Pageable -> Device)", 0, 2, "gpu_memcpy"),
          ("void flash_tc_kernel<float, 16>(float const*)", 5, 10, "kernel"),
          ("sm90_xmma_gemm_f32f32", 12, 8, "kernel"),     # overlaps
          ("void bvsb_chunk_kernel<float>(float const*)", 30, 4, "kernel"),
          ("Memcpy DtoH (Device -> Pageable)", 40, 1, "gpu_memcpy"),
          ("Memcpy HtoD (Pageable -> Device)", 100, 2, "gpu_memcpy"),
          ("void flash_fma_kernel<float, 16>(float const*)", 103, 6,
           "kernel"),
          ("cudaLaunchKernel", 101, 1, "cuda_runtime")]
    return [{"ph": "X", "name": n, "ts": ts, "dur": d, "cat": c}
            for n, ts, d, c in ev]


def test_trace_busy_and_gaps():
    s = devtrace.summarize(trace_events())
    # union: [0,2] [5,20] [30,34] [40,41] [100,102] [103,109]
    assert s["busy_s"] == pytest.approx((2 + 15 + 4 + 1 + 2 + 6) * 1e-6)
    gaps = dict(s["idle_gaps"])
    assert gaps["Memcpy DtoH -> Memcpy HtoD"] == pytest.approx(59e-6)
    assert gaps["Memcpy HtoD -> flash_tc_kernel"] == pytest.approx(3e-6)
    assert gaps["sm90_xmma_gemm_f32f32 -> bvsb_chunk_kernel"] == \
        pytest.approx(10e-6)
    ops = dict(s["device_ops"])
    assert ops["flash_tc_kernel"] == pytest.approx(10e-6)
    assert "cudaLaunchKernel" not in ops


def test_device_readers():
    s = devtrace.summarize(trace_events())
    sl = [batch(0, 0, 4, "slice"), batch(0, 0, 2, "slice")]
    run = make_run(BATCHES, trace=s, slice_batches=sl, slice_s=200e-6)
    assert read("idle_pct", run) == pytest.approx(100 * (1 - 30e-6 / 200e-6))
    bound = sum(2 * counts.flash_work(n, 10, 10, 4, 2, 16).bound_s()
                for n in (4, 2))
    assert read("flash_roofline_pct", run) == pytest.approx(
        100 * bound / 16e-6)
    bound = sum(counts.bvsb_work(n, 300).bound_s() for n in (4, 2))
    assert read("bvsb_roofline_pct", run) == pytest.approx(100 * bound / 4e-6)


def test_device_readers_silent_without_a_trace():
    run = make_run(BATCHES)
    for name in ("idle_pct", "flash_roofline_pct", "bvsb_roofline_pct"):
        assert read(name, run) is None


def test_roofline_readers_silent_without_their_kernels():
    ev = [e for e in trace_events() if "flash" not in e["name"]]
    run = make_run(BATCHES, trace=devtrace.summarize(ev),
                   slice_batches=[batch(0, 0, 4, "slice")], slice_s=1e-3)
    assert read("flash_roofline_pct", run) is None
    assert read("bvsb_roofline_pct", run) is not None
