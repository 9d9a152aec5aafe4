#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each printing its own lines; any failure raises, and the script
then exits non-zero without the final result line:

1. card: name and power limit, as nvidia-smi prints them;
2. build: the CUDA kernels from src/repro_torch/kernels/csrc (set-up),
   with one line per kernel from ptxas (registers, spills);
3. kernels: each CUDA kernel against its plain PyTorch version on the
   card, at the serving shapes and edge cases, with the stated
   tolerances (flash on both sides of the tensor-core threshold, and
   both flash kernels forced at shapes around it; BvSB and decode
   attention called twice, bitwise equal, and decode with NaN in every
   slot past the length, in f32, bf16 and f32 q over a bf16 cache; the
   RG-LRU scan bit for bit, in f32 and bf16,
   on its ring and its per-element path); kernel, plain, library and
   bound times at the two paths' shapes and at B = 64 (CUDA events,
   after warm-up), the scan also in bf16 and at B = 1, flash's bound at
   the tensor-core rate beside its FP32 CUDA-core bound, the threshold
   sweep of the two flash kernels, and BvSB cut into chunks, decode
   attention into splits and the scan's ring into (steps, stages),
   forced, around the plans' choices;
4. cascade path: the live cascade — 16 device clients on tier-low, a
   server engine hosting tier-server-fast and tier-server-heavy with
   model switching, the MultiTASC++ scheduler — through ``run_cascade``,
   with the kernels' launch counters read around it. The run must keep
   some samples on the devices and forward the rest, move the thresholds
   until S(C) switches the server model, and serve batches on both
   server models. Then one 64-sample tier-server-heavy batch on the card
   against the same weights on the CPU (plain versions);
5. RecurrentGemma path: RecurrentGemma-9B at full width and depth (38
   layers, random weights drawn on the card) through the zoo's serving
   entry points — ``make_prefill_step`` on 4 prompts of 3,000 tokens,
   then 32 ``make_serve_step`` decode steps feeding back each top-1 —
   with the launch counters read around it and held to 12 flash, 26
   RG-LRU scan, 384 decode-attention and 33 BvSB launches; the ring
   caches must hold positions 952..2999 at slot pos % 2048. Then the
   card against the CPU at full width and one super-block of depth;
6. simulator path: calibration from light-model logits on the card (the
   BvSB kernel) against the CPU, then the paper's simulator through
   ``jaxsim.run_sweep`` on the card at the paper's scale: (a) the
   heterogeneous fleet of 100 devices x 5,000 samples, 3 schedulers x 3
   seeds; (b) the same fleet under churn and MMPP arrivals with model
   switching over three servers, one lane per scheduler. The first three
   lanes of each also run on the CPU in worker processes started at the
   phase's start, and must equal the card's lanes (counts, per-device
   fields, thresholds, the traces' server index and forwarded counts;
   the float sums over devices within 1e-5 relative). Then (a)'s fleet
   at 600 samples for B in {1, 9, 64, 256}, and a profiled rerun for the
   device's busy time. The launch counters around the path must read one
   BvSB launch (the calibration) and nothing else;
7. the kernels line: one JSON object describing every ported kernel;
8. the result line: {"ok": true, "device": {...}}.

``throughput`` of the cascade is a virtual-clock figure from the paper's
latency profiles, not a measurement of the card.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import io
import json
import multiprocessing
import pathlib
import re
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
from repro_torch.configs import scenarios  # noqa: E402
from repro_torch.configs.scenarios import (ArrivalSpec,  # noqa: E402
                                           ChurnSpec, ScenarioSpec)
from repro_torch.core import calibration  # noqa: E402
from repro_torch.core.switching import DEFAULT_C_UPPER  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import bvsb as _bvsb  # noqa: E402
from repro_torch.kernels import decode_attention as _decode  # noqa: E402
from repro_torch.kernels import flash_attention as _flash  # noqa: E402
from repro_torch.kernels import rglru_scan as _rglru  # noqa: E402
from repro_torch.kernels.bvsb import bvsb_plain  # noqa: E402
from repro_torch.kernels.decode_attention import \
    decode_attention_plain  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention_plain  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan_plain  # noqa: E402
from repro_torch.launch.distributed import (head_bvsb,  # noqa: E402
                                            make_prefill_step,
                                            make_serve_step)
from repro_torch.models import attention, common  # noqa: E402
from repro_torch.models.model import build_model, init_params  # noqa: E402
from repro_torch.serving.cascade import run_cascade  # noqa: E402
from repro_torch.serving.client import DeviceClient  # noqa: E402
from repro_torch.serving.engine import ServedModel, ServerEngine  # noqa: E402
from repro_torch.serving.executables import classify_fn  # noqa: E402
from repro_torch.sim import jaxsim, synthetic  # noqa: E402
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
DECODE_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
CLASSIFY_CONF_ATOL, TOP2_GAP = 1e-5, 1e-4

# the RecurrentGemma path: B prompts of S tokens, then STEPS decode steps
RG_ARCH, RG_B, RG_S, RG_STEPS = "recurrentgemma-9b", 4, 3000, 32
# and its card-vs-CPU check: one super-block, B prompts of S, STEPS steps
RG_CHECK_LAYERS, RG_CHECK_B, RG_CHECK_S, RG_CHECK_STEPS = 3, 2, 300, 4
RING_ATOL = 1e-4    # ring keys against a recomputation at another batch


def card_rates(name: str):
    """(HBM bytes/s, FP32 FLOP/s outside the tensor cores, dense
    tensor-core FLOP/s by input type: TF32 for float32, bf16) from the data
    sheet of the H100 part nvidia-smi names."""
    if "PCIe" in name:
        return 2.0e12, 51e12, {torch.float32: 378e12, torch.bfloat16: 756e12}
    return 3.35e12, 67e12, {torch.float32: 495e12,        # H100 SXM
                            torch.bfloat16: 989e12}


def time_ms(fn, iters=25, warmup=10, spin=True):
    """(device ms per call, host ms per call) of ``fn``.

    Device time: a spin kernel holds the stream while the host enqueues
    ``iters`` calls, so the CUDA events around them time the calls' device
    work back to back, not the host's launch rate; the spin grows until
    it outlasts the enqueue. ``iters`` stays small because the CUDA driver
    queues only about a thousand pending launches before the host blocks,
    and a plain version makes some twenty per call. Host time: wall clock
    per call, synchronised, which is what a caller of ``fn`` waits for.

    ``spin=False`` is for a function that launches more kernels per call
    than the launch queue holds (the plain RG-LRU loop: three per time
    step):
    the events then span back-to-back calls with no spin, so the device
    time includes the gaps in which the device waits for the host's
    launches. It is an upper bound, and the callers say so.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if not spin:
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / iters
        return start.elapsed_time(end) / iters, host
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


PTXAS_KERNELS = ("flash_tc", "flash_fma", "decode_partial", "decode_merge",
                 "bvsb_chunk", "bvsb_merge", "rglru_ring", "rglru_elem")


def print_ptxas(log: str):
    """One line per kernel from nvcc's -Xptxas -v report: registers, spill
    stores and loads, static shared memory."""
    for fn, body in re.findall(r"Compiling entry function '(\w+)' for "
                               r"'sm_90a'(.*?)(?=Compiling entry|\Z)", log,
                               re.S):
        name = re.search(rf"((?:{'|'.join(PTXAS_KERNELS)})_kernel)"
                         r"(?:I(\w+?)EEv)?", fn)
        if not name:
            continue
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", body)
        smem = re.search(r"(\d+) bytes smem", body)
        print(f"ptxas {name.group(1)} <{name.group(2) or ''}>: "
              f"{regs.group(1) if regs else '?'} registers, spill stores/loads "
              f"{spill.group(1) if spill else '?'}/"
              f"{spill.group(2) if spill else '?'} bytes, static smem "
              f"{smem.group(1) if smem else 0} bytes")


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
    # what the RecurrentGemma path hands the kernel: contiguous rows over
    # its vocab of 256,000, at the path's B = 4 and at 64, several chunks a
    # row; and the same rows starting 4 (2) bytes off 16-byte alignment
    for b in (RG_B, 64):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(b, 256_000, generator=gen, device=dev) * 4
            cases.append((f"randn({b},256000)", x.to(dt)))
            x = torch.randn(b, 256_001, generator=gen, device=dev) * 4
            cases.append((f"randn({b},256001)[:,1:]", x.to(dt)[:, 1:]))
        # edges across chunks: tied maxima in the first and the last chunk,
        # the second chunk all -inf, +inf in the last chunk
        _, per = _bvsb.chunks(b, 256_000, _build.sm_count(dev))
        x = torch.randn(b, 256_000, generator=gen, device=dev) * 4
        x[0, [7, 255_993]] = 30.0
        x[1, per:2 * per] = float("-inf")
        x[2, 255_990] = float("inf")
        cases.append((f"ties/-inf chunk/+inf last chunk({b},256000)", x))
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


def bits(t):
    """A float tensor's bit patterns (NaN equal to itself)."""
    return t.contiguous().view(torch.int32)


def check_bvsb(dev):
    for name, x in bvsb_cases(dev):
        conf, top1 = ops.bvsb(x)
        torch.cuda.synchronize()
        pconf, ptop1 = bvsb_plain(x)
        err, atol = max_err(conf, pconf), BVSB_ATOL[x.dtype]
        finite = ~torch.isnan(pconf)
        top1_ok = torch.equal(top1[finite], ptop1[finite])
        nan_ok = torch.equal(torch.isnan(conf), torch.isnan(pconf))
        conf2, top2 = ops.bvsb(x)
        same = torch.equal(bits(conf), bits(conf2)) and torch.equal(top1, top2)
        print(f"bvsb {name} {str(x.dtype)[6:]}: max|err| {err:.3g} "
              f"(atol {atol:g}), top-1 {'equal' if top1_ok else 'DIFFERS'}, "
              f"NaN rows {int((~finite).sum())}, second call "
              f"{'bitwise equal' if same else 'DIFFERS'}")
        if not (err <= atol and top1_ok and nan_ok and same):
            raise AssertionError(f"bvsb kernel disagrees with its plain "
                                 f"version on {name} {x.dtype}")
        if name.startswith("+inf") and not torch.isnan(conf).all():
            raise AssertionError("bvsb: +inf logits must give NaN")
        if name.startswith("ties/-inf chunk") and not (
                float(conf[0]) == 0.0 and int(top1[0]) == 7
                and bool(torch.isnan(conf[2]))):
            raise AssertionError(f"bvsb {name}: a tie across chunks must give "
                                 "margin 0 at the first index, +inf NaN")


FLASH_CASES = [(1, 16, 4, 4, 32, None), (64, 16, 8, 8, 48, None),
               (64, 16, 8, 8, 64, None), (2, 200, 8, 2, 128, None),
               (2, 200, 8, 2, 128, 64),
               # RecurrentGemma's prefill attention at B = 1: hd 256, one
               # KV head for 16, S = 3000 past the window of 2048
               (1, RG_S, 16, 1, 256, 2048),
               # both sides of the tensor-core threshold (S 48 at hd <=
               # 128, 80 above) at hd 64, 128 and 256: GQA 16:1 and 4:1,
               # windows under one 32-key tile (7, 20) and off its
               # multiples (100, 2000), S off the 32-key tile and (with 4
               # heads a group) off the 128-row tile
               (2, 40, 8, 2, 64, 20), (2, 48, 8, 2, 64, 20),
               (2, 1000, 8, 2, 64, 100), (1, 1000, 16, 1, 64, 7),
               (1, 47, 16, 1, 128, None), (1, 1000, 16, 1, 128, 20),
               (2, RG_S, 8, 2, 128, 2000), (2, 79, 16, 1, 256, 20),
               (2, 80, 16, 1, 256, 20), (1, 1000, 8, 2, 256, 100),
               (1, 999, 16, 1, 256, None)]


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


def flash_kernel(q, k, v, window, kernel, causal=True):
    """One flash kernel forced (1: CUDA-core FMAs, 2: tensor cores) through
    the library's measuring entry point; not counted as a launch."""
    return _flash.run_entry(_build.library().repro_flash_attention_kernel, q,
                            k, v, causal=causal, window=window,
                            extra=(kernel,))


def strided_qkv(dev, b, s, h, kv, hd, dt, offset):
    """q, k, v as views into one packed (B, S, 3, H, hd + 1) tensor: (B, S,
    H) strides that are not the contiguous ones; ``offset`` 1 also moves
    every row start off 16 bytes, which the tensor-core kernel loads
    without cp.async."""
    gen = torch.Generator(device=dev).manual_seed(s + hd)
    packed = torch.randn(b, s, 3, h, hd + 1, generator=gen,
                         device=dev).to(dt)
    q, k, v = (packed[:, :, i, :, offset:offset + hd] for i in range(3))
    return q, k[:, :, :kv], v[:, :, :kv]


def _check_flash_out(name, out, ref, dt):
    err, atol = max_err(out, ref), FLASH_ATOL[dt]
    print(f"flash_attention {name} {str(dt)[6:]}: max|err| {err:.3g} "
          f"(atol {atol:g})")
    if not (err <= atol and out.dtype == dt):
        raise AssertionError("flash_attention kernel disagrees with its "
                             f"plain version at {name} {dt}")


def check_flash(dev):
    for b, s, h, kv, hd, window in FLASH_CASES + serving_flash_cases():
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = qkv(dev, b, s, h, kv, hd, dt)
            out = ops.flash_attention(q, k, v, causal=True, window=window)
            torch.cuda.synchronize()
            ref = flash_attention_plain(q, k, v, causal=True, window=window)
            _check_flash_out(f"(B,S,H,KV,hd)=({b},{s},{h},{kv},{hd}) "
                             f"window={window}", out, ref, dt)
    # strided (B, S, H) views on both sides of the threshold, aligned and
    # not; non-causal on both kernels
    for s in (40, 1000):
        for offset in (0, 1):
            for dt in (torch.float32, torch.bfloat16):
                q, k, v = strided_qkv(dev, 2, s, 8, 2, 64, dt, offset)
                out = ops.flash_attention(q, k, v, window=100)
                torch.cuda.synchronize()
                _check_flash_out(
                    f"strided (2,{s},8,2,64) offset={offset} window=100", out,
                    flash_attention_plain(q, k, v, window=100), dt)
    for s in (24, 300):
        q, k, v = qkv(dev, 2, s, 8, 2, 64)
        _check_flash_out(f"non-causal (2,{s},8,2,64)",
                         ops.flash_attention(q, k, v, causal=False),
                         flash_attention_plain(q, k, v, causal=False),
                         torch.float32)
    # both kernels at the same shapes around the threshold
    for b, s, h, kv, hd, window in ((64, 16, 8, 8, 64, None),
                                    (2, 63, 16, 1, 256, 20),
                                    (2, 47, 8, 2, 128, None),
                                    (1, 200, 16, 1, 256, 7)):
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = qkv(dev, b, s, h, kv, hd, dt)
            ref = flash_attention_plain(q, k, v, window=window)
            for kernel in (1, 2):
                out = flash_kernel(q, k, v, window, kernel)
                torch.cuda.synchronize()
                _check_flash_out(f"kernel {kernel} (B,S,H,KV,hd)=({b},{s},"
                                 f"{h},{kv},{hd}) window={window}", out, ref,
                                 dt)


def decode_cases():
    """(B, W, KV, G, hd, lengths): RecurrentGemma's decode shape at B in
    {1, 4, 64} with lengths 1, 777, W and mixed; lengths on both sides of
    the 16-key tiles and of the splits; two KV heads (a split's K rows
    not contiguous) and groups of 8 and 4 at hd 256; small GQA rings."""
    cases = []
    for b in (1, RG_B, 64):
        for lengths in ([1] * b, [777] * b, [2048] * b,
                        [(1, 777, 2048, 1500)[i % 4] for i in range(b)]):
            cases.append((b, 2048, 1, 16, 256, lengths))
    edges = [1, 63, 65, 2047, 2048]
    cases += [(5, 2048, 1, 16, 256, edges), (5, 2048, 2, 16, 256, edges),
              (5, 2048, 1, 8, 256, edges), (5, 2048, 2, 4, 256, edges)]
    # a small GQA ring; hd 48 (under the tile row of 64) takes plain loads
    return cases + [(3, 100, 2, 4, 64, [1, 100, 37]),
                    (3, 100, 2, 4, 128, [100, 1, 63]),
                    (3, 100, 2, 4, 48, [1, 100, 37])]


# (query dtype, cache dtype) of decode attention: f32, bf16, and an f32
# model over a bf16 cache (the JAX package's default cache), which
# computes in f32 and is held to the f32 tolerance
DECODE_DTYPES = ((torch.float32, torch.float32),
                 (torch.bfloat16, torch.bfloat16),
                 (torch.float32, torch.bfloat16))


def dtype_name(qd, cd=None):
    names = {torch.float32: "f32", torch.bfloat16: "bf16"}
    cd = qd if cd is None else cd
    return names[qd] if cd == qd else f"{names[qd]} q over {names[cd]} cache"


def decode_inputs(dev, b, w, kv, g, hd, lengths, dtype=torch.float32,
                  cache_dtype=None):
    gen = torch.Generator(device=dev).manual_seed(b * w + hd)
    q = torch.randn(b, kv * g, hd, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(b, w, kv, hd, generator=gen, device=dev)
            .to(cache_dtype or dtype) for _ in range(2))
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=dev)


def check_decode(dev):
    """Each case against the plain version; then a second call, and a call
    with NaN in every slot at or past the length (slots the kernel must
    never read), each bitwise equal to the first."""
    for b, w, kv, g, hd, lengths in decode_cases():
        for dt, cdt in DECODE_DTYPES:
            q, k, v, lens = decode_inputs(dev, b, w, kv, g, hd, lengths, dt,
                                          cdt)
            out = ops.decode_attention(q, k, v, lens)
            torch.cuda.synchronize()
            ref = decode_attention_plain(q, k, v, lens)
            err, atol = max_err(out, ref), DECODE_ATOL[dt]
            again = ops.decode_attention(q, k, v, lens)
            past = torch.arange(w, device=dev)[None, :] >= lens[:, None]
            k[past], v[past] = float("nan"), float("nan")
            poisoned = ops.decode_attention(q, k, v, lens)
            same = torch.equal(again, out) and torch.equal(poisoned, out)
            print(f"decode_attention (B,W,KV,G,hd)=({b},{w},{kv},{g},{hd}) "
                  f"lengths {sorted(set(lengths))} {dtype_name(dt, cdt)}: "
                  f"max|err| {err:.3g} (atol {atol:g}); again and with NaN "
                  f"past the length: {'bitwise equal' if same else 'DIFFER'}")
            if not (err <= atol and out.dtype == dt and same):
                raise AssertionError("decode_attention kernel disagrees with "
                                     f"its plain version at {(b, w, kv, g, hd)}"
                                     f" lengths {sorted(set(lengths))} "
                                     f"{dtype_name(dt, cdt)}")
    q, k, v, lens = decode_inputs(dev, 2, 64, 1, 16, 64, [64, 5])
    for qd, cd in ((torch.bfloat16, torch.float32),
                   (torch.float16, torch.float16)):
        try:
            ops.decode_attention(q.to(qd), k.to(cd), v.to(cd), lens)
        except TypeError:
            continue
        raise AssertionError(f"decode_attention took {qd} q over a {cd} "
                             "cache")
    print("decode_attention refuses bf16 q over an f32 cache and f16")


def rglru_inputs(dev, b, s, d, with_h0, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    # a in (0.499, 0.999), the range the RG-LRU's gates give
    a = torch.rand(b, s, d, generator=gen, device=dev) * 0.5 + 0.499
    u = torch.randn(b, s, d, generator=gen, device=dev)
    h0 = torch.randn(b, d, generator=gen, device=dev) if with_h0 else None
    return a, u, h0


def rglru_cases(dev, dt, with_h0):
    """(name, a, u, h0, forced per-element path) in ``dt``: RecurrentGemma's
    shape (a ragged last tile: 3000 steps are no multiple of 32 or 64); S
    under one tile (1, 7); D off a strip (300, 4100; in bf16 off 16 bytes
    too, so per-element); a [:, :, 1:] view (base 4 or 2 bytes off 16, so
    per-element); a view strided in time (x[:, ::2], still on the ring);
    and RG's shape forced onto the per-element path. Views are cut after
    the cast."""
    def inputs(b, s, d, seed, view=lambda x: x):
        a, u, h0 = rglru_inputs(dev, b, s, d, with_h0, seed=seed)
        a, u = view(a.to(dt)), view(u.to(dt))
        return a, u, None if h0 is None else h0[:, :a.shape[2]].contiguous()

    cases = [(f"({b},{s},{d})", *inputs(b, s, d, s + d), False)
             for b, s, d in ((RG_B, RG_S, 4096), (1, 1, 256), (2, 7, 256),
                             (3, 129, 300), (2, RG_S, 4100))]
    cases.append(("(2,300,513)[:, :, 1:]",
                  *inputs(2, 300, 513, 3, lambda x: x[:, :, 1:]), False))
    cases.append(("(2,600,512)[:, ::2]",
                  *inputs(2, 600, 512, 4, lambda x: x[:, ::2]), False))
    cases.append((f"({RG_B},{RG_S},4096) forced per-element",
                  *inputs(RG_B, RG_S, 4096, 5), True))
    return cases


def check_rglru(dev):
    """Each case bit for bit against the plain loop (torch.equal): both
    round each step's product and sum alike."""
    for dt in (torch.float32, torch.bfloat16):
        for with_h0 in (False, True):
            for name, a, u, h0, elem in rglru_cases(dev, dt, with_h0):
                h = _rglru.run_entry(a, u, h0, aligned=False) if elem \
                    else ops.rglru_scan(a, u, h0)
                torch.cuda.synchronize()
                same = torch.equal(h, rglru_scan_plain(a, u, h0))
                path = "per-element" if elem or not _rglru.is_aligned(a, u) \
                    else "ring, plan (steps, stages) " + str(_rglru.tiles(
                        *a.shape, a.element_size(), _build.sm_count(dev)))
                print(f"rglru_scan {name} {str(dt)[6:]} h0={with_h0}: "
                      f"{path}: {'bitwise equal' if same else 'DIFFERS'}")
                if not (same and h.dtype == torch.float32):
                    raise AssertionError(f"rglru_scan kernel differs from its "
                                         f"plain version at {name} {dt} "
                                         f"h0={with_h0}")


def bvsb_bound_ms(b, v, elt, bw, flops):
    moved = b * v * elt + b * 8              # logits in, conf + top1 out
    ops_ = 4 * b * v                         # compare, subtract, exp, add
    return max(moved / bw, ops_ / flops) * 1e3, \
        "bytes" if moved / bw >= ops_ / flops else "operations"


def _bound(moved, ops_, bw, flops):
    return max(moved / bw, ops_ / flops) * 1e3, \
        "bytes" if moved / bw >= ops_ / flops else "operations"


def flash_bounds_ms(q, k, bw, flops, tc, window=None):
    """The bound at the rate of the kernel the shape picks (on tensor
    cores f32 is 3xTF32, three TF32 products per FMA pair, and bf16 one
    product) and, under its own key, the bound at the FP32 CUDA-core
    rate."""
    b, s, h, hd = q.shape
    # (query, key) pairs causal attention keeps: min(i + 1, window) keys
    # for query i
    w = window or s
    pairs = w * (w + 1) // 2 + (s - w) * w if s > w else s * (s + 1) // 2
    moved = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    ops_ = 4 * hd * pairs * b * h            # q.k and p.v, 2 FLOP per FMA
    fp32 = _bound(moved, ops_, bw, flops)
    if not _flash.uses_tensor_cores(s, hd):
        return fp32, fp32
    products = 3 if q.dtype == torch.float32 else 1
    return _bound(moved, products * ops_, bw, tc[q.dtype]), fp32


def decode_bound_ms(q, k, lengths, bw, flops):
    """Each valid cache slot read once (K and V, in the cache's type), q
    read and out written once (in q's type); a q.k and a p.v FMA per
    (query head, valid slot, head dim)."""
    b, h, hd = q.shape
    kv = k.shape[2]
    slots = int(lengths.clamp(max=k.shape[1]).sum())
    moved = (2 * q.numel() * q.element_size()
             + 2 * slots * kv * hd * k.element_size() + lengths.numel() * 4)
    ops_ = 4 * hd * slots * h
    return _bound(moved, ops_, bw, flops)


def rglru_bound_ms(a, bw, flops):
    """a and u read once, h written once (f32); a multiply and an add per
    element."""
    return _bound(a.numel() * (2 * a.element_size() + 4), 2 * a.numel(),
                  bw, flops)


class Timer:
    """Kernel / plain / library device times (``time_ms``) beside the bound,
    per shape, each shape timed once, on inputs shaped as the main path
    gives them (float32 unless a row says bf16); the kernel's output on
    the timed inputs is held to its plain version's within the float32
    tolerance (the RG-LRU scan: bit for bit)."""

    def __init__(self, dev, bw, flops, tc):
        self.dev, self.bw, self.flops, self.tc = dev, bw, flops, tc
        self.rows = {}

    def _row(self, key, kernel, plain, library, bound, err, atol, shape,
             plain_spin=True, bound_fp32=None, dt="f32"):
        """``library`` None: no single PyTorch call computes the function.
        ``plain_spin`` False: the plain version launches more kernels than
        the launch queue holds, so it is timed without the spin (an upper
        bound: it includes the device's waits for the host).
        ``bound_fp32``: the bound at the FP32 CUDA-core rate, beside a
        ``bound`` at the tensor-core rate."""
        if not err <= atol:
            raise AssertionError(f"{key[0]} {key[1]}: max|err| {err:.3g} "
                                 f"above atol {atol:g}")
        ms, by = bound
        k_ms, call_ms = time_ms(kernel)
        p_ms = time_ms(plain, spin=True)[0] if plain_spin else \
            time_ms(plain, iters=3, warmup=1, spin=False)[0]
        l_ms = None if library is None else time_ms(library)[0]
        r = self.rows[key] = dict(
            ms=k_ms, call_ms=call_ms, plain_ms=p_ms, library_ms=l_ms,
            bound_ms=ms, bound_by=by, max_abs_err=err, shape=list(shape))
        fp32 = ""
        if bound_fp32 is not None:
            r["bound_fp32_ms"], r["bound_fp32_by"] = bound_fp32
            fp32 = (f", FP32 CUDA-core bound {bound_fp32[0] * 1e3:.4f} us "
                    f"({bound_fp32[1]})")
        lib = "none" if l_ms is None else f"{l_ms * 1e3:.2f} us"
        print(f"time {key[0]} {key[1]} {tuple(shape)} {dt}: kernel "
              f"{k_ms * 1e3:.2f} us on the device ({call_ms * 1e3:.2f} us "
              f"per call on the host), plain {p_ms * 1e3:.2f} us"
              f"{'' if plain_spin else ' (host-bound, no spin)'}, library "
              f"{lib}, bound {ms * 1e3:.4f} us ({by}){fp32}, max|err| "
              f"{err:.3g}")
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

    def bvsb_rows(self, b, v):
        """Contiguous (B, V) rows, as the serving head hands them over."""
        key = ("bvsb", f"{RG_ARCH} B={b}")
        x = torch.randn(b, v, device=self.dev) * 4
        (conf, top1), (pconf, ptop1) = ops.bvsb(x), bvsb_plain(x)
        if not torch.equal(top1, ptop1):
            raise AssertionError(f"bvsb {key[1]}: top-1 differs")
        return self._row(
            key, lambda: ops.bvsb(x), lambda: bvsb_plain(x),
            lambda: torch.topk(torch.softmax(x, dim=-1), 2, dim=-1),
            bvsb_bound_ms(b, v, 4, self.bw, self.flops),
            max_err(conf, pconf), BVSB_ATOL[torch.float32], (b, v))

    def bvsb_chunks(self, shapes=((8, 2048), (8, 8192), (8, 12288),
                                  (8, 16384), (1, 16384), (64, 16384),
                                  (8, 65536), (RG_B, 256_000),
                                  (64, 256_000))):
        """Device us of the BvSB kernel forced to about n chunks a row
        (``bvsb.run_entry``, not counted), each held to the plain version:
        where cutting a row (and the merge launch) starts to pay sets the
        row length from which the plan cuts (MIN_CHUNKS * MIN_CHUNK)."""
        sms = _build.sm_count(self.dev)
        for b, v in shapes:
            x = torch.randn(b, v, device=self.dev) * 4
            pconf, ptop1 = bvsb_plain(x)
            planned = _bvsb.chunks(b, v, sms)[0]
            cells = []
            for n in sorted({1, 2, 4, 8, 16, 32, 64, planned}):
                if n > v // _bvsb.VEC or b * n > 8 * sms:
                    continue
                conf, top1 = _bvsb.run_entry(x, n)
                if not (max_err(conf, pconf) <= BVSB_ATOL[torch.float32]
                        and torch.equal(top1, ptop1)):
                    raise AssertionError(f"bvsb ({b},{v}) cut into {n} chunks "
                                         "disagrees with its plain version")
                ms = time_ms(lambda: _bvsb.run_entry(x, n))[0]
                cells.append(f"n={n} {ms * 1e3:.2f}")
            print(f"bvsb chunks (B,V)=({b},{v}) f32, planned "
                  f"n={planned}, device us: {'; '.join(cells)}")

    def decode_splits(self, batches=(RG_B, 64), w=2048):
        """Device us of the decode kernel at RecurrentGemma's shape, rings
        full, forced to about n splits (``decode_attention.run_entry``,
        not counted), each held to the plain version: how the blocks per
        SM that the plan picks compare with more and fewer."""
        sms = _build.sm_count(self.dev)
        for b in batches:
            q, k, v, lens = decode_inputs(self.dev, b, w, 1, 16, 256, [w] * b)
            ref = decode_attention_plain(q, k, v, lens)
            planned = _decode.splits(b, 1, w, sms)[0]
            cells = []
            for n in sorted({1, 2, 4, 8, 16, 32, 64, 128, planned}):
                if n > w // _decode.TILE or b * n > 8 * sms:
                    continue
                err = max_err(_decode.run_entry(q, k, v, lens, n), ref)
                if not err <= DECODE_ATOL[torch.float32]:
                    raise AssertionError(f"decode B={b} in {n} splits "
                                         "disagrees with its plain version")
                ms = time_ms(lambda: _decode.run_entry(q, k, v, lens, n))[0]
                cells.append(f"n={n} {ms * 1e3:.2f}")
            # the card's read rate on the same bytes: one library reduction
            # over the K and V caches
            kv = torch.stack((k, v))
            sum_ms = time_ms(lambda: kv.sum())[0]
            print(f"decode splits (B,W,KV,G,hd)=({b},{w},1,16,256) f32, "
                  f"planned n={planned}, device us: {'; '.join(cells)}; "
                  f"torch.sum over the caches {sum_ms * 1e3:.2f} us "
                  f"({kv.numel() * 4 / sum_ms / 1e9:.3f} TB/s)")

    def flash_rg(self, b=RG_B, s=RG_S, window=2048):
        key = ("flash_attention", f"{RG_ARCH} B={b}")
        q, k, v = qkv(self.dev, b, s, 16, 1, 256)
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        i = torch.arange(s, device=self.dev)
        mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
        err = max_err(ops.flash_attention(q, k, v, window=window),
                      flash_attention_plain(q, k, v, window=window))
        bound, fp32 = flash_bounds_ms(q, k, self.bw, self.flops, self.tc,
                                      window)
        row = self._row(
            key, lambda: ops.flash_attention(q, k, v, window=window),
            lambda: flash_attention_plain(q, k, v, window=window),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                   enable_gqa=True),
            bound, err, FLASH_ATOL[torch.float32], (b, s, 16, 1, 256, window),
            bound_fp32=fp32)
        # the same call with the GQA group's heads not packed into the
        # tile's rows: K and V expanded to 16 heads (stride 0), so each
        # block takes 128 positions of one head
        ku, vu = k.expand(-1, -1, 16, -1), v.expand(-1, -1, 16, -1)
        unpacked = max_err(ops.flash_attention(q, ku, vu, window=window),
                           ops.flash_attention(q, k, v, window=window))
        u_ms = time_ms(
            lambda: ops.flash_attention(q, ku, vu, window=window))[0]
        print(f"time flash_attention {key[1]} heads not packed: "
              f"{u_ms * 1e3:.2f} us on the device against "
              f"{row['ms'] * 1e3:.2f} packed, max|diff| {unpacked:.3g}")
        row["unpacked_ms"] = u_ms
        # the CUDA-core kernel, forced at the same shape
        f_ms = time_ms(lambda: flash_kernel(q, k, v, window, 1), iters=5,
                       warmup=2)[0]
        print(f"time flash_attention {key[1]} CUDA-core kernel forced: "
              f"{f_ms * 1e3:.2f} us on the device")
        row["fma_ms"] = f_ms
        return row

    def decode_rg(self, b=RG_B, w=2048, dt=torch.float32, cache_dt=None):
        """Every ring full (length W), as on every decode step of the
        path: its prompts of 3,000 tokens fill the 2048-slot rings. The
        SDPA yardstick takes the cache in q's type (SDPA takes one type
        for all three)."""
        cache_dt = cache_dt or dt
        tag = "" if (dt, cache_dt) == (torch.float32,) * 2 else \
            " " + dtype_name(dt, cache_dt)
        key = ("decode_attention", f"{RG_ARCH} B={b}{tag}")
        q, k, v, lens = decode_inputs(self.dev, b, w, 1, 16, 256, [w] * b,
                                      dt, cache_dt)
        qt = q[:, :, None, :]
        kt, vt = (c.transpose(1, 2).to(dt) for c in (k, v))
        mask = (torch.arange(w, device=self.dev)[None, :]
                < lens[:, None])[:, None, None, :]
        err = max_err(ops.decode_attention(q, k, v, lens),
                      decode_attention_plain(q, k, v, lens))
        return self._row(
            key, lambda: ops.decode_attention(q, k, v, lens),
            lambda: decode_attention_plain(q, k, v, lens),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                   enable_gqa=True),
            decode_bound_ms(q, k, lens, self.bw, self.flops), err,
            DECODE_ATOL[dt], (b, w, 1, 16, 256), dt=dtype_name(dt, cache_dt))

    def rglru_rg(self, b=RG_B, s=RG_S, d=4096, dt=torch.float32):
        name = "f32" if dt == torch.float32 else "bf16"
        key = ("rglru_scan", f"{RG_ARCH} B={b}" + (" bf16" if name == "bf16"
                                                   else ""))
        a, u, _ = rglru_inputs(self.dev, b, s, d, False, seed=1)
        a, u = a.to(dt), u.to(dt)
        if not torch.equal(ops.rglru_scan(a, u), rglru_scan_plain(a, u)):
            raise AssertionError(f"rglru_scan {key[1]}: differs from its "
                                 "plain version")
        return self._row(
            key, lambda: ops.rglru_scan(a, u), lambda: rglru_scan_plain(a, u),
            None, rglru_bound_ms(a, self.bw, self.flops), 0.0, 0.0,
            (b, s, d), plain_spin=False, dt=name)

    def rglru_tiles(self, shapes=((RG_B, torch.float32), (1, torch.float32),
                                  (RG_B, torch.bfloat16)), s=RG_S, d=4096):
        """Device us of the scan's ring forced to (steps, stages)
        (``rglru_scan.run_entry``, not counted) around the plan at
        RecurrentGemma's shape, each bitwise equal to the plain loop;
        beside them the card's rate over the same bytes, one
        ``torch.add(a, u, out=h)``: a and u read, h written in f32, as
        the scan moves them. A yardstick of bytes: no PyTorch call
        computes the scan."""
        sms = _build.sm_count(self.dev)
        for b, dt in shapes:
            a, u, _ = rglru_inputs(self.dev, b, s, d, False, seed=2)
            a, u = a.to(dt), u.to(dt)
            ref = rglru_scan_plain(a, u)
            elt = a.element_size()
            plan = _rglru.tiles(b, s, d, elt, sms)
            row = 2 * _rglru.STRIP * elt
            base = _rglru.MIN_TILE // row
            times = {}
            for steps, stages in sorted(
                    {(base << k, n) for k in range(4)
                     for n in range(2, _rglru.MAX_STAGES + 1)} | {plan}):
                if not torch.equal(_rglru.run_entry(a, u, None, steps, stages),
                                   ref):
                    raise AssertionError(f"rglru_scan ({b},{s},{d}) {dt} at "
                                         f"steps={steps} stages={stages} "
                                         "differs from its plain version")
                times[steps, stages] = time_ms(
                    lambda: _rglru.run_entry(a, u, None, steps, stages))[0]
            elem_ms = time_ms(lambda: _rglru.run_entry(a, u, aligned=False))[0]
            h = torch.empty(b, s, d, device=self.dev)
            add_ms = time_ms(lambda: torch.add(a, u, out=h))[0]
            moved = a.numel() * (2 * elt + 4)
            cells = "; ".join(
                f"{st}x{n} ({st * n * row // 1024} KB) {ms * 1e3:.2f}"
                for (st, n), ms in times.items())
            print(f"rglru tiles (B,S,D)=({b},{s},{d}) {str(dt)[6:]}, planned "
                  f"steps x stages {plan[0]}x{plan[1]} "
                  f"({moved / times[plan] / 1e9:.3f} TB/s), device us: "
                  f"{cells}; per-element path {elem_ms * 1e3:.2f}; "
                  f"torch.add(a, u, out=h) over the same bytes "
                  f"{add_ms * 1e3:.2f} us ({moved / add_ms / 1e9:.3f} TB/s)")

    def flash(self, tier, b, s=16):
        if ("flash_attention", f"{tier} B={b}") in self.rows:
            return self.rows[("flash_attention", f"{tier} B={b}")]
        cfg = get_config(tier)
        h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        q, k, v = qkv(self.dev, b, s, h, kv, hd)
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        err = max_err(ops.flash_attention(q, k, v),
                      flash_attention_plain(q, k, v))
        bound, fp32 = flash_bounds_ms(q, k, self.bw, self.flops, self.tc)
        return self._row(
            ("flash_attention", f"{tier} B={b}"),
            lambda: ops.flash_attention(q, k, v),
            lambda: flash_attention_plain(q, k, v),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
            bound, err, FLASH_ATOL[torch.float32], (b, s, h, kv, hd),
            bound_fp32=fp32)

    def flash_threshold(self, seqs=(16, 32, 40, 48, 64, 80, 96, 128, 256)):
        """Device us of both flash kernels, forced, over S at the tiers'
        shapes and RecurrentGemma's heads (f32): where the tensor-core
        kernel starts to win sets the entry point's threshold."""
        shapes = [(name, b, cfg.num_heads, cfg.num_kv_heads,
                   cfg.resolved_head_dim)
                  for name, b in (("tier-low", 1), ("tier-server-fast", 8),
                                  ("tier-server-heavy", 64), (RG_ARCH, 1))
                  for cfg in (get_config(name),)]
        for name, b, h, kv, hd in shapes:
            cells = []
            for s in seqs:
                q, k, v = qkv(self.dev, b, s, h, kv, hd)
                fma_ms, tc_ms = (time_ms(lambda: flash_kernel(q, k, v, None,
                                                              kernel))[0]
                                 for kernel in (1, 2))
                pick = "tc" if _flash.uses_tensor_cores(s, hd) else "fma"
                cells.append(f"S={s} {fma_ms * 1e3:.2f}/{tc_ms * 1e3:.2f}"
                             f"({pick})")
            print(f"flash threshold {name} (B,H,KV,hd)=({b},{h},{kv},{hd}) "
                  f"f32, device us fma/tc (picked): {'; '.join(cells)}")


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


def _top_kernels(prof, n=6):
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:n]
    return busy, sum(e.count for e in kernels), top


def profile_main_path(models, wall):
    """Device time of a second, identical run under torch.profiler; the
    idle share compares it with the unprofiled run's wall time. Only CUDA
    activity is traced: the host-side operator records cost most of the
    profiler's time over the run's ~356,000 launches and are not read."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cascade(models)
    busy, launches, top = _top_kernels(prof, 8)
    if busy <= 0:
        raise AssertionError("the profiled rerun traced no device time")
    print(f"main path device time (profiled rerun, "
          f"{time.perf_counter() - t0:.1f} s with the profiler): "
          f"{busy:.4f} s busy over {wall:.3f} s of unprofiled wall, "
          f"idle share {1 - busy / wall:.4f}; {launches} kernel launches")
    for e in top:
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
        "no decode or scan launches":
            counts["decode_attention"] == counts["rglru_scan"] == 0,
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
        last = cpu(torch.as_tensor(tokens))[0][:, -1, :]
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


# ---------------------------------------------------------------------------
# phase 5: RecurrentGemma-9B prefill + decode
# ---------------------------------------------------------------------------
def rg_expected_launches(cfg, steps):
    kinds = cfg.pattern
    return {"bvsb": 1 + steps, "flash_attention": kinds.count("lattn"),
            "rglru_scan": kinds.count("rglru"),
            "decode_attention": kinds.count("lattn") * steps}


def ring_keys(model, tokens, layer):
    """The rotated keys (S, KV, hd) of ``layer`` (an lattn layer) for the
    first prompt, recomputed at batch 1 from the layers below it."""
    cfg = model.cfg
    with torch.inference_mode():
        x = common.embed_apply(model.embed.table, tokens[:1])
        positions = torch.arange(tokens.shape[1], device=x.device)[None]
        for below in model.layers[:layer]:
            x, _ = below(x, positions, cfg)
        lyr = model.layers[layer]
        _, k, _ = attention._qkv(lyr.attn, lyr.norm1(x, cfg.norm_eps), cfg)
        return common.apply_rope(k, positions, cfg.rope_theta)[0]


def recurrentgemma_path(dev):
    cfg = get_config(RG_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    weights_gb = sum(p.numel() * p.element_size()
                     for p in model.parameters()) / 1e9
    print(f"{RG_ARCH}: {cfg.num_layers} layers {cfg.pattern.count('rglru')} "
          f"rglru / {cfg.pattern.count('lattn')} lattn, {n_params} "
          f"parameters, {weights_gb:.3f} GB float32, drawn on the card in "
          f"{init_s:.3f} s")

    rng = np.random.default_rng(2)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (RG_B, RG_S)),
                             device=dev)
    prefill, serve = make_prefill_step(model), make_serve_step(model)
    lattn = cfg.pattern.index("lattn")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    conf, top1, cache = prefill(tokens)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    ring = cache[lattn]["k"][0].clone()     # before decode overwrites it
    confs, tops = [conf], [top1]
    pos = torch.full((RG_B,), RG_S, device=dev)
    t0 = time.perf_counter()
    for i in range(RG_STEPS):
        conf, top1, cache = serve(top1[:, None], cache, pos + i)
        confs.append(conf)
        tops.append(top1)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    want = rg_expected_launches(cfg, RG_STEPS)
    confs, tops = torch.stack(confs), torch.stack(tops)
    w = ring.shape[0]
    keys = ring_keys(model, tokens, lattn)
    kept = torch.arange(RG_S - w, RG_S, device=dev)
    ring_err = max_err(ring[kept % w], keys[kept])
    shifted_err = max_err(ring[(kept + 1) % w], keys[kept])
    print(f"{RG_ARCH} prefill of {RG_B} x {RG_S} tokens: wall {prefill_s:.3f} "
          "s on the card")
    print(f"{RG_ARCH} decode of {RG_STEPS} steps at B={RG_B}: wall "
          f"{decode_s:.3f} s on the card ({decode_s / RG_STEPS * 1e3:.2f} ms "
          "per step)")
    print(f"{RG_ARCH} path: peak device memory {peak_gb:.3f} GB; launches "
          f"{counts} (expected {want}); conf range [{float(confs.min()):.3g},"
          f" {float(confs.max()):.3g}]; ring of layer {lattn}: positions "
          f"{RG_S - w}..{RG_S - 1} at slot pos % {w}, max|err| "
          f"{ring_err:.3g} (atol {RING_ATOL:g}; one slot off: "
          f"{shifted_err:.3g})")
    checks = {
        "launches": counts == want,
        "finite confidences": bool(torch.isfinite(confs).all()),
        "top-1 in the vocab": bool(((tops >= 0)
                                    & (tops < cfg.vocab_size)).all()),
        "shapes": confs.shape == tops.shape == (RG_STEPS + 1, RG_B),
        "ring holds the last W positions at pos % W":
            ring_err <= RING_ATOL < shifted_err,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{RG_ARCH} path checks failed: {failed}")
    del cache, keys, ring
    profile_rg(prefill, serve, tokens, top1, prefill_s, decode_s)
    rg_check_cpu(model, dev)
    return counts, dict(init_s=init_s, prefill_s=prefill_s,
                        decode_s=decode_s, peak_gb=peak_gb)


def profile_rg(prefill, serve, tokens, top1, prefill_s, decode_s, steps=4):
    """Device time by kernel of a second prefill and ``steps`` decode
    steps under torch.profiler (CUDA activity only); busy time against the
    unprofiled run's wall time gives the idle share."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, cache = prefill(tokens)
        torch.cuda.synchronize()
    busy, launches, top = _top_kernels(prof)
    print(f"{RG_ARCH} prefill device time (profiled rerun): {busy:.4f} s busy"
          f" over {prefill_s:.3f} s of unprofiled wall, idle share "
          f"{1 - busy / prefill_s:.4f}; {launches} kernel launches")
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")
    pos = torch.full((RG_B,), RG_S, device=tokens.device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            _, top1, cache = serve(top1[:, None], cache, pos + i)
        torch.cuda.synchronize()
    busy, launches, top = _top_kernels(prof)
    wall = decode_s / RG_STEPS * steps
    print(f"{RG_ARCH} decode device time (profiled rerun of {steps} steps): "
          f"{busy:.4f} s busy over {wall:.3f} s of unprofiled wall, idle "
          f"share {1 - busy / wall:.4f}; {launches} kernel launches")
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")


def rg_check_cpu(model, dev):
    """One super-block of the same weights at full width, card against
    CPU: prefill of (2, 300) and 4 decode steps, each fed the card's
    top-1. BvSB within CLASSIFY_CONF_ATOL; top-1 equal wherever the CPU's
    top-2 logit gap exceeds TOP2_GAP."""
    cfg = model.cfg.with_(num_layers=RG_CHECK_LAYERS)
    card = build_model(cfg, device=dev)
    card.load_state_dict(model.state_dict(), strict=False)
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    table = cpu.head_table
    rng = np.random.default_rng(3)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (RG_CHECK_B, RG_CHECK_S)))
    t0 = time.perf_counter()
    prefill, serve = make_prefill_step(card), make_serve_step(card)
    conf, top1, cache = prefill(tokens.to(dev))
    with torch.inference_mode():
        hidden, ccache = cpu(tokens, collect_cache=True, return_hidden=True)
    errs, same, clear_rows = [], True, 0
    for i in range(RG_CHECK_STEPS + 1):
        with torch.inference_mode():
            cconf, ctop1 = head_bvsb(hidden[:, -1:], table, cfg.vocab_size)
            top2 = torch.topk(hidden[:, -1] @ table.T, 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > TOP2_GAP
        errs.append(max_err(conf.cpu(), cconf))
        same &= torch.equal(top1.cpu()[clear], ctop1[clear])
        clear_rows += int(clear.sum())
        if i == RG_CHECK_STEPS:
            break
        pos = torch.full((RG_CHECK_B,), RG_CHECK_S + i)
        tok = top1.cpu()[:, None]
        conf, top1, cache = serve(tok.to(dev), cache, pos.to(dev))
        with torch.inference_mode():
            hidden, ccache = cpu.decode_step(tok, ccache, pos,
                                             return_hidden=True)
    n = RG_CHECK_B * (RG_CHECK_STEPS + 1)
    print(f"{RG_ARCH} {RG_CHECK_LAYERS} layers at full width, prefill "
          f"{RG_CHECK_B} x {RG_CHECK_S} + {RG_CHECK_STEPS} decode steps, "
          f"card vs CPU: max|conf err| {max(errs):.3g} (atol "
          f"{CLASSIFY_CONF_ATOL:g}), top-1 equal on {clear_rows}/{n} rows "
          f"with top-2 gap > {TOP2_GAP:g}: {same} "
          f"({time.perf_counter() - t0:.1f} s)")
    if not (max(errs) <= CLASSIFY_CONF_ATOL and same):
        raise AssertionError(f"{RG_ARCH} on the card disagrees with the CPU")


# ---------------------------------------------------------------------------
# phase 6: the paper's simulator (calibration, then the lane-aligned sweep)
# ---------------------------------------------------------------------------
# (a) the heterogeneous fleet of benchmarks/fig11_heterogeneous.py at the
# paper's scale: 100 devices, tiers low/mid/high round-robin, SLO 0.15 s,
# server efficientnetb3, 5,000 samples a device, 3 schedulers x 3 seeds
SIM_N, SIM_S, SIM_SLO, SIM_SEEDS = 100, 5000, 0.15, (0, 1, 2)
SIM_SCHEDULERS = ("multitasc++", "multitasc", "static")
SIM_TIERS = ("low", "mid", "high")
SIM_SERVER = "efficientnetb3"
# (b) the changing environment: the same fleet under churn and MMPP
# arrivals, switching over three server models, one lane per scheduler
SIM_ENV = ScenarioSpec("churn+mmpp",
                       churn=ChurnSpec(join_frac=0.3, leave_frac=0.3),
                       arrivals=ArrivalSpec(kind="mmpp"))
SIM_ENV_SERVERS = ("inceptionv3", "efficientnetb3", "deit-base")
# cut from the paper's 5,000: under arrivals the devices' completions no
# longer coincide, so (b) takes about N events a sample (94 a sample at
# N = 100), and its CPU check runs one trip per event
SIM_ENV_S = 200
# the width sweep over (a)'s fleet, and the profiled rerun's size
# (the profiler's processing costs ~0.15 ms a kernel, hence the short rerun)
SIM_WIDTHS, SIM_WIDTH_S, SIM_PROFILE_S = (1, 9, 64, 256), 600, 30
SIM_CPU_LANES = 3        # lanes of (a) and of (b) also run on the CPU
# card against CPU: these equal, the float sums over devices within
# tests/test_torch_sim.py's AGG_RTOL
SIM_EXACT = ("completed", "forwarded_frac", "queue_left", "queue_peak",
             "n_events", "per_device_sr", "per_device_acc", "final_thresh")
SIM_EXACT_TRACES = ("server_idx", "fwd", "active")
SIM_AGG = ("sr", "accuracy", "throughput")
SIM_AGG_TRACES = ("thresh", "sr", "acc")
SIM_AGG_RTOL = 1e-5


def sim_fleet():
    profs = [DEVICE_PROFILES[SIM_TIERS[i % 3]] for i in range(SIM_N)]
    return (np.arange(SIM_N, dtype=np.int32) % 3,
            np.array([p.latency for p in profs], np.float32),
            np.array([p.accuracy for p in profs]))


@functools.lru_cache(maxsize=None)
def sim_static_threshold(server):
    """fig11's static threshold: the paper's calibration protocol on each
    tier's calibration split against the server, averaged over tiers."""
    return float(np.mean([calibration.calibrate_static_threshold(
        cal.confidence, cal.correct_light, cal.correct_heavy[:, 0])[0]
        for cal in (synthetic.calibration_set(DEVICE_PROFILES[t].accuracy,
                                              server.accuracy)
                    for t in SIM_TIERS)]))


@functools.lru_cache(maxsize=4)
def sim_inputs(kind, lanes, samples):
    """run_sweep's arguments for lanes ``lanes`` (a range) of fleet (a)
    "hetero" or (b) "env": lane i runs scheduler i % 3 on seed i // 3. A
    lane's inputs depend only on its index, so any subset of lanes is the
    same points. Cached: the width sweep and the profiled rerun call each
    twice or more (the streams are host set-up, not the card's work)."""
    tier, lat, accs = sim_fleet()
    seeds = [i // 3 for i in lanes]
    uniq = sorted(set(seeds))
    rows = [uniq.index(x) for x in seeds]
    if kind == "hetero":
        servers = (SERVER_PROFILES[SIM_SERVER],)
        kw = dict(tier_ids=tier)
        spec_kw = dict(static_threshold=sim_static_threshold(servers[0]))
    else:
        servers = tuple(SERVER_PROFILES[n] for n in SIM_ENV_SERVERS)
        r = scenarios.realize(SIM_ENV, uniq, SIM_N, samples, lat)
        kw = dict(tier_ids=tier, c_upper=[DEFAULT_C_UPPER[t]
                                          for t in SIM_TIERS],
                  join_t=r["join_t"][rows], leave_t=r["leave_t"][rows])
        spec_kw = dict(model_switching=True,
                       static_threshold=sim_static_threshold(servers[0]))
    streams = synthetic.batched_device_streams(
        uniq, SIM_N, samples, accs, [p.accuracy for p in servers])
    streams = {k: v[rows] for k, v in streams.items()}
    if kind == "env":
        streams["arrive"] = r["arrive"][rows]
    specs = [jaxsim.JaxSimSpec(SIM_SCHEDULERS[i % 3], SIM_N, samples,
                               **spec_kw) for i in lanes]
    return (specs, streams, lat, np.full(SIM_N, SIM_SLO, np.float32),
            servers), kw


def sim_cpu_lanes(kind, samples):
    """The first SIM_CPU_LANES lanes through the port on the CPU (run in a
    worker process beside the card's runs); returns (metrics, wall s)."""
    torch.set_num_threads(1)
    args, kw = sim_inputs(kind, range(SIM_CPU_LANES), samples)
    t0 = time.perf_counter()
    out = jaxsim.run_sweep(*args, device="cpu", **kw)
    return out, time.perf_counter() - t0


def sim_run(dev, kind, lanes, samples):
    """One card run: (metrics, wall s, loop trips)."""
    args, kw = sim_inputs(kind, lanes, samples)
    trips = jaxsim.stats.trips
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = jaxsim.run_sweep(*args, device=dev, **kw)
    wall = time.perf_counter() - t0
    return out, wall, jaxsim.stats.trips - trips


def sim_line(name, out, wall, trips, where="on the card"):
    events = int(out["n_events"].sum())
    return (f"{name}: B={len(out['sr'])}, wall {wall:.3f} s {where}, "
            f"{trips} loop trips ({wall / trips * 1e6:.2f} us a trip), "
            f"{events} lane-events ({events / wall:.0f} lane-events/s), "
            f"n_events per lane {out['n_events'].min()}-"
            f"{out['n_events'].max()}")


def sim_compare(name, card, cpu):
    """Lanes 0..k-1 of the card's run against the CPU's k lanes."""
    k = len(cpu["sr"])
    bad = [key for key in SIM_EXACT
           if not np.array_equal(card[key][:k], cpu[key])]
    bad += [f"traces.{key}" for key in SIM_EXACT_TRACES
            if not np.array_equal(card["traces"][key][:k],
                                  cpu["traces"][key], equal_nan=True)]
    worst = 0.0
    for key in SIM_AGG + tuple(f"traces.{t}" for t in SIM_AGG_TRACES):
        a = card["traces"][key[7:]] if key.startswith("traces.") else card[key]
        b = cpu["traces"][key[7:]] if key.startswith("traces.") else cpu[key]
        a, b = np.asarray(a[:k], np.float64), np.asarray(b, np.float64)
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            bad.append(key)
            continue
        m = ~np.isnan(a)
        rel = np.abs(a[m] - b[m]) / np.maximum(np.abs(b[m]), 1e-30)
        err = float(rel.max()) if rel.size else 0.0
        worst = max(worst, err)
        if err > SIM_AGG_RTOL:
            bad.append(f"{key} (rel {err:.3g})")
    print(f"{name}: card lanes 0-{k - 1} against the CPU: "
          f"{', '.join(SIM_EXACT + SIM_EXACT_TRACES)} "
          f"{'equal' if not bad else 'DIFFER'}; {', '.join(SIM_AGG)} and "
          f"the traces' {', '.join(SIM_AGG_TRACES)} within max rel "
          f"{worst:.3g} (rtol {SIM_AGG_RTOL:g})")
    if bad:
        raise AssertionError(f"{name}: the card's lanes differ from the "
                             f"CPU's in {bad}")


def sim_check_result(name, out, samples, lanes, churn=False):
    """Finite metrics in range and no sample counted twice; without churn
    the MultiTASC++ lanes (i % 3 == 0) must finish every sample and drain
    their queue, which the paper's point is that it keeps up with (a
    congested MultiTASC or Static lane can reach its window budget with
    samples still queued, as in the JAX package)."""
    n = SIM_N * samples
    pp = np.array([i % 3 == 0 for i in lanes])
    checks = {
        "finite metrics": all(np.isfinite(out[k]).all()
                              for k in ("sr", "accuracy", "throughput")),
        "completed + queued <= samples":
            ((out["completed"] + out["queue_left"] <= n)
             & (out["completed"] > 0)).all(),
        "sr in [0, 100]": ((out["sr"] >= 0) & (out["sr"] <= 100)).all(),
        "some forwarded, some local":
            ((out["forwarded_frac"] > 0) & (out["forwarded_frac"] < 1)).all(),
    }
    if not churn:
        checks["MultiTASC++ lanes complete every sample and drain"] = (
            (out["completed"][pp] == n) & (out["queue_left"][pp] == 0)).all()
    failed = [k for k, ok in checks.items() if not ok]
    print(f"{name}: sr {np.round(out['sr'], 3).tolist()}, accuracy "
          f"{np.round(out['accuracy'], 4).tolist()}, forwarded_frac "
          f"{np.round(out['forwarded_frac'], 4).tolist()}, completed "
          f"{out['completed'].tolist()}, queue_left "
          f"{out['queue_left'].tolist()}, queue_peak "
          f"{out['queue_peak'].tolist()}")
    if failed:
        raise AssertionError(f"{name} checks failed: {failed}")


def sim_calibration_inputs(dev):
    """Light-model logits on the card, and labels: the light model right
    more often where its BvSB is high (about 74% in all, near the paper's
    light models), the heavy model at 85%."""
    gen = torch.Generator(device=dev).manual_seed(4)
    logits = torch.randn(10_000, 1000, generator=gen, device=dev) * 10
    pconf, _ = calibration.score_logits(logits.cpu())
    rng = np.random.default_rng(4)
    correct_l = (rng.random(10_000) < 0.3 + 0.7 * pconf).astype(np.int8)
    correct_h = (rng.random(10_000) < 0.85).astype(np.int8)
    return logits, correct_l, correct_h


def sim_check_scoring(logits):
    """BvSB of the calibration logits, card against CPU (not counted)."""
    conf, _ = calibration.score_logits(logits)
    pconf, _ = calibration.score_logits(logits.cpu())
    err = float(np.abs(conf - pconf).max())
    print(f"calibration scoring of (10000, 1000) logits, card vs CPU: BvSB "
          f"max|err| {err:.3g} (atol {BVSB_ATOL[torch.float32]:g})")
    if not err <= BVSB_ATOL[torch.float32]:
        raise AssertionError("calibration scoring on the card disagrees "
                             "with the CPU")


def sim_calibration(logits, correct_l, correct_h):
    """The paper's calibration protocol over the logits scored on the card
    (one BvSB launch) against the same on the CPU: the same threshold."""
    t, info = calibration.calibrate_from_logits(logits, correct_l, correct_h)
    pt, pinfo = calibration.calibrate_from_logits(logits.cpu(), correct_l,
                                                  correct_h)
    print(f"calibration from (10000, 1000) logits: card threshold {t:.6f}, "
          f"CPU {pt:.6f}, forward fraction {info['forward_fraction']:.4f}")
    if not (t == pt and info == pinfo):
        raise AssertionError("calibration on the card disagrees with the CPU")


def simulator_path(dev):
    """Calibration and both fleets on the card, launch counters around
    them; the first lanes of each also on the CPU in worker processes
    started first, held to the card's; then the width sweep and a
    profiled rerun."""
    spawn = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(2, mp_context=spawn) as pool:
        cpu = {"hetero": pool.submit(sim_cpu_lanes, "hetero", SIM_S),
               "env": pool.submit(sim_cpu_lanes, "env", SIM_ENV_S)}
        cal = sim_calibration_inputs(dev)
        sim_check_scoring(cal[0])
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        sim_calibration(*cal)
        hetero, h_wall, h_trips = sim_run(dev, "hetero",
                                          range(3 * len(SIM_SEEDS)), SIM_S)
        env, e_wall, e_trips = sim_run(dev, "env", range(3), SIM_ENV_S)
        counts = ops.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        print(sim_line(f"simulator (a) hetero fleet N={SIM_N} S={SIM_S}",
                       hetero, h_wall, h_trips))
        sim_check_result("simulator (a)", hetero, SIM_S,
                         range(3 * len(SIM_SEEDS)))
        print(sim_line(f"simulator (b) churn + MMPP + switching N={SIM_N} "
                       f"S={SIM_ENV_S}", env, e_wall, e_trips))
        sim_check_result("simulator (b)", env, SIM_ENV_S, range(3),
                         churn=True)
        switched = np.nanmax(env["traces"]["server_idx"], axis=1)
        print(f"simulator (b): highest server index reached per lane "
              f"{switched.tolist()}; peak device memory {peak_gb:.3f} GB; "
              f"launches {counts}; {jaxsim.GRAPH_TRIPS} trips a graph")
        if counts != {"bvsb": 1, "flash_attention": 0,
                      "decode_attention": 0, "rglru_scan": 0}:
            raise AssertionError(f"simulator path launches {counts}")
        t0 = time.perf_counter()
        sim_widths(dev)
        t1 = time.perf_counter()
        sim_profile(dev)
        t2 = time.perf_counter()
        for name, card, kind, samples in (("simulator (a)", hetero, "hetero",
                                           SIM_S),
                                          ("simulator (b)", env, "env",
                                           SIM_ENV_S)):
            out, wall = cpu[kind].result()
            print(f"{name}: the port on the CPU, not the card ({SIM_CPU_LANES}"
                  f" lanes, one thread in a worker process): wall "
                  f"{wall:.3f} s for {int(out['n_events'].sum())} "
                  f"lane-events")
            sim_compare(name, card, out)
        print(f"simulator phase seconds: width sweep {t1 - t0:.1f}, profiled "
              f"rerun {t2 - t1:.1f}, waiting for the CPU lanes "
              f"{time.perf_counter() - t2:.1f}")
    return counts, dict(hetero_wall=h_wall, env_wall=e_wall, peak_gb=peak_gb)


def sim_widths(dev):
    """(a)'s fleet at SIM_WIDTH_S samples for each B, one call each: its
    wall includes building the buffers, the eager warm-up trips and the
    graph's capture, as a user's first call of a structure does."""
    for b in SIM_WIDTHS:
        out, wall, trips = sim_run(dev, "hetero", range(b), SIM_WIDTH_S)
        print(sim_line(f"simulator width B={b} S={SIM_WIDTH_S}", out, wall,
                       trips))


def sim_profile(dev):
    """Device busy time of a warm rerun of (a)'s B=9 at SIM_PROFILE_S under
    torch.profiler (CUDA activity), against its unprofiled wall."""
    from torch.profiler import ProfilerActivity, profile
    lanes = range(3 * len(SIM_SEEDS))
    sim_run(dev, "hetero", lanes, SIM_PROFILE_S)
    _, wall, trips = sim_run(dev, "hetero", lanes, SIM_PROFILE_S)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sim_run(dev, "hetero", lanes, SIM_PROFILE_S)
    busy, launches, top = _top_kernels(prof, 8)
    if busy <= 0:
        raise AssertionError("the profiled simulator rerun traced no device "
                             "time")
    print(f"simulator device time (profiled warm rerun of (a) B=9 "
          f"S={SIM_PROFILE_S}): {busy:.4f} s busy over {wall:.3f} s of "
          f"unprofiled wall, idle share {1 - busy / wall:.4f}; {launches} "
          f"kernel launches over {trips} trips ({launches / trips:.1f} a "
          f"trip, the loads and reads of the run included)")
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")


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
    bw, flops, tc = card_rates(card)

    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stderr(log):
        _build.build(verbose=True)
    sys.stderr.write(log.getvalue())
    print_ptxas(log.getvalue())
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s (set-up; "
          f"{len(_build.sources())} sources, key {_build.build_key()})")

    t1 = time.perf_counter()
    check_bvsb(dev)
    check_flash(dev)
    check_decode(dev)
    check_rglru(dev)
    timer = Timer(dev, bw, flops, tc)
    for b in (1, 16, 64):
        timer.bvsb(b)
    timer.flash("tier-low", 1)
    for tier in ("tier-server-fast", "tier-server-heavy"):
        for b in (16, 64):
            timer.flash(tier, b)
    timer.flash_threshold()
    rg_rows = {"bvsb": timer.bvsb_rows(RG_B, 256_000),
               "flash_attention": timer.flash_rg(),
               "decode_attention": timer.decode_rg(),
               "rglru_scan": timer.rglru_rg()}
    b64_rows = {"bvsb": timer.bvsb_rows(64, 256_000),
                "decode_attention": timer.decode_rg(b=64)}
    decode_rows = {"bf16": timer.decode_rg(dt=torch.bfloat16),
                   "f32_over_bf16_cache": timer.decode_rg(
                       cache_dt=torch.bfloat16)}
    scan_rows = {"bf16": timer.rglru_rg(dt=torch.bfloat16),
                 "b1": timer.rglru_rg(b=1)}
    timer.bvsb_chunks()
    timer.decode_splits()
    timer.rglru_tiles()
    torch.cuda.empty_cache()

    t2 = time.perf_counter()
    counts, engine = main_path(dev)
    t3 = time.perf_counter()
    rg_counts, rg = recurrentgemma_path(dev)
    t4 = time.perf_counter()
    sim_counts, sim = simulator_path(dev)
    print(f"phase seconds: build {t1 - t0:.1f}, kernels {t2 - t1:.1f}, "
          f"cascade path with its profiled rerun {t3 - t2:.1f}, "
          f"{RG_ARCH} path with its CPU check {t4 - t3:.1f}, simulator "
          f"with its CPU check, width sweep and profiled rerun "
          f"{time.perf_counter() - t4:.1f}")

    # the kernels line times each kernel at the RecurrentGemma path's shape;
    # BvSB and flash also at the cascade's most frequent server batch (the
    # clients' B = 1 calls are launch-bound)
    pairs = [(r["model"], r["bucket"]) for r in engine.records]
    tier, bucket = max(set(pairs), key=pairs.count)
    cascade_rows = {"bvsb": timer.bvsb(bucket),
                    "flash_attention": timer.flash(tier, bucket)}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "bound_fp32_ms", "library_ms", "call_ms", "shape")
    kernels = []
    for name, source, replaces in (
            ("bvsb", "bvsb.cu", "src/repro/kernels/bvsb.py:82"),
            ("flash_attention", "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:81"),
            ("decode_attention", "decode_attention.cu",
             "src/repro/kernels/decode_attention.py:59"),
            ("rglru_scan", "rglru_scan.cu",
             "src/repro/kernels/rglru_scan.py:44")):
        by_path = {"cascade": counts[name], RG_ARCH: rg_counts[name],
                   "simulator": sim_counts[name]}
        entry = {"name": name, "route": "cuda",
                 "source": f"src/repro_torch/kernels/csrc/{source}",
                 "replaces": replaces, "launches": sum(by_path.values()),
                 "launches_by_path": by_path, "path": RG_ARCH,
                 **{k: rg_rows[name][k] for k in keys if k in rg_rows[name]}}
        if name in cascade_rows:
            entry["cascade"] = {k: cascade_rows[name][k] for k in keys
                                if k in cascade_rows[name]}
        if name in b64_rows:
            entry["b64"] = {k: b64_rows[name][k] for k in keys
                            if k in b64_rows[name]}
        extra = {"rglru_scan": scan_rows,
                 "decode_attention": decode_rows}.get(name, {})
        entry.update({tag: {k: row[k] for k in keys if k in row}
                      for tag, row in extra.items()})
        kernels.append(entry)
    print(f"{RG_ARCH} path seconds: init {rg['init_s']:.3f}, prefill "
          f"{rg['prefill_s']:.3f}, decode {rg['decode_s']:.3f}; peak "
          f"{rg['peak_gb']:.3f} GB; simulator (a) {sim['hetero_wall']:.3f} "
          f"s, (b) {sim['env_wall']:.3f} s, peak {sim['peak_gb']:.3f} GB")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
