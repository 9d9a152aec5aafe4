#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each printing its own lines; any failure raises, and the script
then exits non-zero without the final result line:

1. card: name and power limit, as nvidia-smi prints them;
2. build: the CUDA kernels from src/repro_torch/kernels/csrc (set-up);
3. kernels: each CUDA kernel against its plain PyTorch version on the
   card, at the serving shapes and edge cases, with the stated
   tolerances; kernel, plain, library and bound times at the main path's
   shapes (CUDA events, after warm-up);
4. main path: the live cascade — 16 device clients on tier-low, a server
   engine hosting tier-server-fast and tier-server-heavy with model
   switching, the MultiTASC++ scheduler — through ``run_cascade``, with
   the kernels' launch counters read around it. The run must keep some
   samples on the devices and forward the rest, move the thresholds
   until S(C) switches the server model, and serve batches on both
   server models. Then one 64-sample tier-server-heavy batch on the card
   against the same weights on the CPU (plain versions);
5. the kernels line: one JSON object describing every ported kernel;
6. the result line: {"ok": true, "device": {...}}.

``throughput`` of the cascade is a virtual-clock figure from the paper's
latency profiles, not a measurement of the card.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.cascade_tiers import (BATCH_LADDER,  # noqa: E402
                                               DEVICE_PROFILES,
                                               SERVER_PROFILES)
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.bvsb import bvsb_plain  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention_plain  # noqa: E402
from repro_torch.models.model import build_model, init_params  # noqa: E402
from repro_torch.serving.cascade import run_cascade  # noqa: E402
from repro_torch.serving.client import DeviceClient  # noqa: E402
from repro_torch.serving.engine import ServedModel, ServerEngine  # noqa: E402
from repro_torch.serving.executables import classify_fn  # noqa: E402
from repro_torch.sim.events import make_scheduler  # noqa: E402

N_DEVICES, SAMPLES, SEQ, VOCAB = 16, 128, 16, 2048
SLO, WINDOW, THRESHOLD = 0.15, 0.25, 0.5
# tier-low's random weights are drawn at this scale (the tiers' default
# is 0.02, which leaves every BvSB near 1e-3) so that its confidences
# spread over (0, 1) as a trained light model's do: some samples stay on
# the device, and the thresholds the scheduler moves steer the rest
LOW_INIT_SCALE = 0.5
BVSB_ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-3}
FLASH_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
CLASSIFY_CONF_ATOL, TOP2_GAP = 1e-5, 1e-4


def card_rates(name: str):
    """(HBM bytes/s, FP32 FLOP/s outside the tensor cores) from the data
    sheet of the H100 part nvidia-smi names."""
    if "PCIe" in name:
        return 2.0e12, 51e12
    return 3.35e12, 67e12       # H100 SXM


def time_ms(fn, iters=25, warmup=10):
    """(device ms per call, host ms per call) of ``fn``.

    Device time: a spin kernel holds the stream while the host enqueues
    ``iters`` calls, so the CUDA events around them time the calls' device
    work back to back, not the host's launch rate; the spin grows until
    it outlasts the enqueue. ``iters`` stays small because the CUDA driver
    queues only about a thousand pending launches before the host blocks,
    and a plain version makes some twenty per call. Host time: wall clock
    per call, synchronised, which is what a caller of ``fn`` waits for.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin = 20_000_000            # clock cycles: ~10 ms at the H100's ~2 GHz
    while True:
        torch.cuda._sleep(spin)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        enqueue = time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize()
        device_ms = start.elapsed_time(end) / iters
        if enqueue * 1e3 < spin / 4e6:
            break        # the enqueue took under half the spin
        if spin < 2e9:
            spin *= 4
        elif iters > 1:
            iters //= 2  # fewer launches pending behind the spin
        else:
            raise AssertionError("the timed function waits for the device "
                                 "on every call: no device time to read")
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return device_ms, (time.perf_counter() - t0) * 1e3 / iters


def max_err(a, b) -> float:
    a, b = a.float(), b.float().to(a.device)
    both_nan = torch.isnan(a) & torch.isnan(b)
    if (torch.isnan(a) != torch.isnan(b)).any():
        return float("inf")
    return float((a - b).abs()[~both_nan].max()) if (~both_nan).any() else 0.0


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def bvsb_cases(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for b, v in ((1, 2048), (64, 2048), (20, 1000), (3, 130)):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(b, v, generator=gen, device=dev) * 4
            cases.append((f"randn({b},{v})", x.to(dt)))
    # what the classify path hands the kernel at every ladder bucket: the
    # last position of (B, S, V) logits, a view with row stride S * V
    for b in BATCH_LADDER:
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(b, SEQ, VOCAB, generator=gen, device=dev) * 4
            cases.append((f"randn({b},{SEQ},{VOCAB})[:,-1,:]",
                          x.to(dt)[:, -1, :]))
    x = torch.full((5, 2048), -1.0, device=dev)
    x[0, [7, 1999]] = 3.0            # tied maxima in different warps
    x[1, [0, 1]] = 2.5               # tied maxima in neighbouring threads
    x[2] = -1e38
    x[2, 5] = 1e4
    x[3, :10] = float("-inf")
    x[3, 11] = 2.0
    x[4, 1000:] = torch.finfo(torch.float32).min
    cases.append(("ties/-inf/-1e38/padding(5,2048)", x))
    inf = torch.zeros(2, 64, device=dev)
    inf[0, 3] = float("inf")
    inf[1, [5, 9]] = float("inf")
    cases.append(("+inf(2,64)", inf))
    return cases


def check_bvsb(dev):
    for name, x in bvsb_cases(dev):
        conf, top1 = ops.bvsb(x)
        torch.cuda.synchronize()
        pconf, ptop1 = bvsb_plain(x)
        err, atol = max_err(conf, pconf), BVSB_ATOL[x.dtype]
        finite = ~torch.isnan(pconf)
        top1_ok = torch.equal(top1[finite], ptop1[finite])
        nan_ok = torch.equal(torch.isnan(conf), torch.isnan(pconf))
        print(f"bvsb {name} {str(x.dtype)[6:]}: max|err| {err:.3g} "
              f"(atol {atol:g}), top-1 {'equal' if top1_ok else 'DIFFERS'}, "
              f"NaN rows {int((~finite).sum())}")
        if not (err <= atol and top1_ok and nan_ok):
            raise AssertionError(f"bvsb kernel disagrees with its plain "
                                 f"version on {name} {x.dtype}")
        if name.startswith("+inf") and not torch.isnan(conf).all():
            raise AssertionError("bvsb: +inf logits must give NaN")


FLASH_CASES = [(1, 16, 4, 4, 32, None), (64, 16, 8, 8, 48, None),
               (64, 16, 8, 8, 64, None), (2, 200, 8, 2, 128, None),
               (2, 200, 8, 2, 128, 64)]


def serving_flash_cases():
    """Every attention shape the main path can give the kernel: tier-low
    at the clients' B = 1, each server tier at every ladder bucket."""
    cases = []
    for tier, buckets in (("tier-low", (1,)),
                          ("tier-server-fast", BATCH_LADDER),
                          ("tier-server-heavy", BATCH_LADDER)):
        cfg = get_config(tier)
        cases += [(b, SEQ, cfg.num_heads, cfg.num_kv_heads,
                   cfg.resolved_head_dim, None) for b in buckets]
    return cases


def qkv(dev, b, s, h, kv, hd, dtype=torch.float32, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(b, s, n, hd, generator=gen, device=dev)
                 .to(dtype) for n in (h, kv, kv))


def check_flash(dev):
    for b, s, h, kv, hd, window in FLASH_CASES + serving_flash_cases():
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = qkv(dev, b, s, h, kv, hd, dt)
            out = ops.flash_attention(q, k, v, causal=True, window=window)
            torch.cuda.synchronize()
            ref = flash_attention_plain(q, k, v, causal=True, window=window)
            err, atol = max_err(out, ref), FLASH_ATOL[dt]
            print(f"flash_attention (B,S,H,KV,hd)=({b},{s},{h},{kv},{hd}) "
                  f"window={window} {str(dt)[6:]}: max|err| {err:.3g} "
                  f"(atol {atol:g})")
            if not (err <= atol and out.dtype == dt):
                raise AssertionError("flash_attention kernel disagrees with "
                                     f"its plain version at {(b, s, h, kv, hd)}"
                                     f" window={window} {dt}")


def bvsb_bound_ms(b, v, elt, bw, flops):
    moved = b * v * elt + b * 8              # logits in, conf + top1 out
    ops_ = 4 * b * v                         # compare, subtract, exp, add
    return max(moved / bw, ops_ / flops) * 1e3, \
        "bytes" if moved / bw >= ops_ / flops else "operations"


def flash_bound_ms(q, k, bw, flops):
    b, s, h, hd = q.shape
    pairs = s * (s + 1) // 2                 # (query, key) pairs causal keeps
    moved = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    ops_ = 4 * hd * pairs * b * h            # q.k and p.v, 2 FLOP per FMA
    return max(moved / bw, ops_ / flops) * 1e3, \
        "bytes" if moved / bw >= ops_ / flops else "operations"


class Timer:
    """Kernel / plain / library device times (``time_ms``) beside the bound,
    per shape, each shape timed once, on float32 inputs shaped as the main
    path gives them; the kernel's output on the timed inputs is held to
    its plain version's within the float32 tolerance."""

    def __init__(self, dev, bw, flops):
        self.dev, self.bw, self.flops = dev, bw, flops
        self.rows = {}

    def _row(self, key, kernel, plain, library, bound, err, atol, shape):
        if not err <= atol:
            raise AssertionError(f"{key[0]} {key[1]}: max|err| {err:.3g} "
                                 f"above atol {atol:g}")
        ms, by = bound
        (k_ms, call_ms), (p_ms, _), (l_ms, _) = map(time_ms, (kernel, plain,
                                                             library))
        r = self.rows[key] = dict(
            ms=k_ms, call_ms=call_ms, plain_ms=p_ms, library_ms=l_ms,
            bound_ms=ms, bound_by=by, max_abs_err=err, shape=list(shape))
        print(f"time {key[0]} {key[1]} {tuple(shape)} f32: kernel "
              f"{k_ms * 1e3:.2f} us on the device ({call_ms * 1e3:.2f} us "
              f"per call on the host), plain {p_ms * 1e3:.2f} us, library "
              f"{l_ms * 1e3:.2f} us, bound {ms * 1e3:.4f} us ({by}), "
              f"max|err| {err:.3g}")
        return r

    def bvsb(self, b, v=2048):
        if ("bvsb", f"B={b}") in self.rows:
            return self.rows[("bvsb", f"B={b}")]
        x = (torch.randn(b, SEQ, v, device=self.dev) * 4)[:, -1, :]
        (conf, top1), (pconf, ptop1) = ops.bvsb(x), bvsb_plain(x)
        if not torch.equal(top1, ptop1):
            raise AssertionError(f"bvsb B={b}: top-1 differs")
        return self._row(
            ("bvsb", f"B={b}"), lambda: ops.bvsb(x), lambda: bvsb_plain(x),
            lambda: torch.topk(torch.softmax(x, dim=-1), 2, dim=-1),
            bvsb_bound_ms(b, v, 4, self.bw, self.flops),
            max_err(conf, pconf), BVSB_ATOL[torch.float32], (b, v))

    def flash(self, tier, b, s=16):
        if ("flash_attention", f"{tier} B={b}") in self.rows:
            return self.rows[("flash_attention", f"{tier} B={b}")]
        cfg = get_config(tier)
        h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        q, k, v = qkv(self.dev, b, s, h, kv, hd)
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        err = max_err(ops.flash_attention(q, k, v),
                      flash_attention_plain(q, k, v))
        return self._row(
            ("flash_attention", f"{tier} B={b}"),
            lambda: ops.flash_attention(q, k, v),
            lambda: flash_attention_plain(q, k, v),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
            flash_bound_ms(q, k, self.bw, self.flops), err,
            FLASH_ATOL[torch.float32], (b, s, h, kv, hd))


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------
class RecordingClient(DeviceClient):
    """A device client that keeps every confidence it computes."""

    def __post_init__(self):
        super().__post_init__()
        self.confs = []

    def run_local(self, tokens):
        out = super().run_local(tokens)
        self.confs.append(out[0])
        return out


class RecordingEngine(ServerEngine):
    """A server engine that keeps every batch record it executes."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.records = []

    def execute(self, record):
        record = super().execute(record)
        self.records.append(record)
        return record


def fleet(models):
    """A fresh cascade: clients, engine, scheduler and data, all seeded."""
    clients = [RecordingClient(i, models["tier-low"], DEVICE_PROFILES["low"],
                               SLO, WINDOW, THRESHOLD)
               for i in range(N_DEVICES)]
    engine = RecordingEngine([
        ServedModel("tier-server-fast", models["tier-server-fast"],
                    SERVER_PROFILES["inceptionv3"]),
        ServedModel("tier-server-heavy", models["tier-server-heavy"],
                    SERVER_PROFILES["efficientnetb3"])])
    sched = make_scheduler("multitasc++", N_DEVICES,
                           server_profile=SERVER_PROFILES["inceptionv3"],
                           slo=SLO, init_threshold=THRESHOLD)
    rng = np.random.default_rng(0)
    data = [[rng.integers(0, VOCAB, SEQ).astype(np.int32)
             for _ in range(SAMPLES)] for _ in range(N_DEVICES)]
    return clients, engine, sched, data


def cascade(models):
    clients, engine, sched, data = fleet(models)
    res = run_cascade(clients, engine, sched, data, window=WINDOW,
                      model_switching=True)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return clients, engine, res


def profile_main_path(models, wall):
    """Device time of a second, identical run under torch.profiler; the
    idle share compares it with the unprofiled run's wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cascade(models)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"main path device time (profiled rerun): {busy_us / 1e6:.4f} s "
          f"busy over {wall:.3f} s of unprofiled wall, idle share "
          f"{1 - busy_us / 1e6 / wall:.4f}; {sum(e.count for e in kernels)} "
          "kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")


def build_models(dev):
    g = torch.Generator().manual_seed(0)
    return {name: init_params(cfg, g, device=dev) for name, cfg in (
        ("tier-low", get_config("tier-low").with_(init_scale=LOW_INIT_SCALE)),
        ("tier-server-fast", get_config("tier-server-fast")),
        ("tier-server-heavy", get_config("tier-server-heavy")))}


def main_path(dev):
    models = build_models(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    clients, engine, res = cascade(models)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()

    n = N_DEVICES * SAMPLES
    answered = sum(len(r["requests"]) for r in engine.records)
    forwarded = round(res.forwarded_frac * n)
    layers = {name: get_config(name).num_layers for name in models}
    want_flash = n * layers["tier-low"] + sum(layers[r["model"]]
                                              for r in engine.records)
    confs = np.concatenate([np.asarray(c.confs) for c in clients]
                           + [r["conf"] for r in engine.records])
    served = sorted({r["model"] for r in engine.records})
    print(f"main path: completed {res.completed}/{n}, sr {res.sr:.4f}, "
          f"forwarded_frac {res.forwarded_frac:.4f}, switches {res.switches},"
          f" server batches {len(engine.records)} (models {served}, buckets "
          f"{sorted(set(engine.batch_history))}), windows "
          f"{len(res.timeline['t'])}, "
          f"wall {wall:.3f} s on the card; virtual-clock throughput "
          f"{res.throughput:.2f}/s (paper profiles, not a card number)")
    print(f"main path launches: {counts} (expected bvsb "
          f"{n + len(engine.records)}, flash_attention {want_flash})")
    checks = {
        "completed": res.completed == n,
        "every forwarded sample answered": answered == forwarded
        and len(engine.queue) == 0 and engine.in_flight == 0
        and all(r["conf"] is not None and len(r["conf"]) == len(r["requests"])
                for r in engine.records),
        "bvsb launches": counts["bvsb"] == n + len(engine.records),
        "flash_attention launches": counts["flash_attention"] == want_flash,
        "finite confidences": bool(np.isfinite(confs).all())
        and len(confs) == n + answered,
        "some samples kept local, some forwarded":
            0 < res.forwarded_frac < 1,
        "S(C) switched the server model": res.switches >= 1,
        "both server models served batches":
            served == ["tier-server-fast", "tier-server-heavy"],
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"main path checks failed: {failed}")

    profile_main_path(models, wall)

    # one 64-sample tier-server-heavy batch: card vs the same weights on CPU
    heavy = models["tier-server-heavy"]
    rng = np.random.default_rng(1)
    cpu = build_model(heavy.cfg, device="cpu")
    cpu.load_state_dict(heavy.state_dict())
    tokens = rng.integers(0, 2048, (64, SEQ)).astype(np.int32)
    fn = classify_fn(heavy, 64)
    conf, pred = fn(heavy, torch.as_tensor(tokens, device=dev))
    with torch.inference_mode():
        last = cpu(torch.as_tensor(tokens))[:, -1, :]
    cconf, cpred = ops.bvsb(last)
    top2 = torch.topk(last, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > TOP2_GAP
    err = max_err(conf.cpu(), cconf)
    same = torch.equal(pred.cpu()[clear], cpred[clear])
    print(f"tier-server-heavy classify, 64 samples, card vs CPU: max|conf "
          f"err| {err:.3g} (atol {CLASSIFY_CONF_ATOL:g}), top-1 equal on "
          f"{int(clear.sum())}/64 rows with top-2 gap > {TOP2_GAP:g}: {same}")
    if not (err <= CLASSIFY_CONF_ATOL and same):
        raise AssertionError("tier-server-heavy on the card disagrees with "
                             "the CPU")
    return counts, engine


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    bw, flops = card_rates(card)

    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s (set-up; "
          f"{len(_build.sources())} sources, key {_build.build_key()})")

    t1 = time.perf_counter()
    check_bvsb(dev)
    check_flash(dev)
    timer = Timer(dev, bw, flops)
    for b in (1, 16, 64):
        timer.bvsb(b)
    timer.flash("tier-low", 1)
    for tier in ("tier-server-fast", "tier-server-heavy"):
        for b in (16, 64):
            timer.flash(tier, b)

    t2 = time.perf_counter()
    counts, engine = main_path(dev)
    print(f"phase seconds: build {t1 - t0:.1f}, kernels {t2 - t1:.1f}, main "
          f"path with its profiled rerun {time.perf_counter() - t2:.1f}")

    # the kernels line times each kernel at the shape of the main path's
    # most frequent server batch (the clients' B = 1 calls are launch-bound)
    pairs = [(r["model"], r["bucket"]) for r in engine.records]
    tier, bucket = max(set(pairs), key=pairs.count)
    kernels = []
    for name, row, source, replaces in (
            ("bvsb", timer.bvsb(bucket),
             "src/repro_torch/kernels/csrc/bvsb.cu",
             "src/repro/kernels/bvsb.py:82"),
            ("flash_attention", timer.flash(tier, bucket),
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:81")):
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "call_ms": row["call_ms"], "shape": row["shape"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
