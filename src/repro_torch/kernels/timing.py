"""Timing for kernel rows: device time from CUDA events, host time from
blocked wall clock, each with a floor on the timed span.

Counterpart of the JAX package's ``kernels/timing.py``, whose rule holds
here: a timed span must cover at least ``MIN_RES_MULT`` ticks of its
clock, or the number is not published. ``time_blocked`` times a block of
N back-to-back calls with one ``time.perf_counter`` pair, growing N until
the block clears MIN_RES_MULT times the clock's measured resolution, and
reports wall / N. ``time_ms`` times a kernel's device work with CUDA
events behind a spin kernel (the calls queue while the spin holds the
stream, so the events span the calls back to back, not the host's launch
rate); a span under MIN_RES_MULT times the events' documented resolution
(``EVENT_RESOLUTION_MS``) grows the calls, or raises.
"""
from __future__ import annotations

import functools
import time

import torch

# every reported span must cover at least this many ticks of its clock
MIN_RES_MULT = 50
# the resolution of cudaEventElapsedTime, "around 0.5 microseconds" in the
# CUDA runtime's documentation: a fixed figure, so the floor on an events'
# span (MIN_RES_MULT times it, 25 us) is the same in every run
EVENT_RESOLUTION_MS = 0.5e-3


@functools.lru_cache(maxsize=1)
def timer_resolution() -> float:
    """Measured resolution of time.perf_counter, in seconds: the smallest
    positive delta over a burst of back-to-back reads (cached: a property
    of the clocksource, not of the workload)."""
    best = float("inf")
    for _ in range(200):
        a = time.perf_counter()
        b = time.perf_counter()
        while b == a:  # spin until the clock ticks
            b = time.perf_counter()
        best = min(best, b - a)
    return best


def time_blocked(fn, *args, min_block_mult: int = MIN_RES_MULT,
                 max_reps: int = 1 << 16):
    """Time ``fn(*args)`` with repeat-N blocked timing.

    ``fn`` must synchronize internally (a CUDA function ends with
    ``torch.cuda.synchronize()``). Grows the rep count until one timed
    block spans at least ``min_block_mult`` timer resolutions, then
    returns ``(seconds_per_call, block_wall_seconds, reps)``."""
    floor = min_block_mult * timer_resolution()
    reps = 1
    while True:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        wall = time.perf_counter() - t0
        if wall >= floor or reps >= max_reps:
            return wall / reps, wall, reps
        # jump straight to the projected rep count (with 2x headroom)
        # rather than doubling through many under-floor blocks
        projected = int(reps * max(2.0, 2.0 * floor / max(wall, 1e-12)))
        reps = min(max_reps, projected)


def _device_span(fn, iters, spin):
    """(the events' span over ``iters`` calls behind a spin of ``spin``
    clock cycles, the host's enqueue seconds)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), enqueue


def time_ms(fn, iters=25, warmup=10, spin=True, max_iters=1 << 12):
    """(device ms per call, host ms per call) of ``fn``.

    Device time: a spin kernel holds the stream while the host enqueues
    ``iters`` calls, so the CUDA events around them time the calls' device
    work back to back, not the host's launch rate; the spin grows until
    it outlasts the enqueue. ``iters`` stays small because the CUDA driver
    queues only about a thousand pending launches before the host blocks,
    and a plain version makes twenty to a hundred per call: an enqueue
    that lasts as long as the spin waited behind it with the queue full,
    and halves ``iters`` rather than grow a spin that cannot help. The
    events' span must cover MIN_RES_MULT times their resolution
    (``EVENT_RESOLUTION_MS``): a shorter one doubles ``iters`` (up to
    ``max_iters``), else raises. Host time: wall clock per call,
    synchronised, which is what a caller of ``fn`` waits for.

    ``spin=False`` is for a function that launches more kernels per call
    than the launch queue holds (the plain RG-LRU loop: three per time
    step): the events then span back-to-back calls with no spin, so the
    device time includes the gaps in which the device waits for the
    host's launches. It is an upper bound, and the callers say so.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    floor = MIN_RES_MULT * EVENT_RESOLUTION_MS
    if not spin:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / iters
        span = start.elapsed_time(end)
        if span < floor:
            raise AssertionError(f"a {span:.6f} ms span is under the floor "
                                 f"of {floor:.6f} ms")
        return span / iters, host
    cycles = 20_000_000          # clock cycles: ~10 ms at the H100's ~2 GHz
    while True:
        span, enqueue = _device_span(fn, iters, cycles)
        if enqueue * 1e3 >= cycles / 4e6:    # the enqueue outlasted half
            if enqueue * 1e3 >= 0.9 * cycles / 2e6 and iters > 1:
                iters //= 2  # the queue filled: the host waited out the spin
            elif cycles < 2e9:
                cycles *= 4
            elif iters > 1:
                iters //= 2  # fewer launches pending behind the spin
            else:
                raise AssertionError("the timed function waits for the "
                                     "device on every call: no device time "
                                     "to read")
        elif span < floor:
            if iters * 2 > max_iters:
                raise AssertionError(
                    f"{iters} calls span {span:.6f} ms, under the floor of "
                    f"{floor:.6f} ms ({MIN_RES_MULT} x the events' "
                    f"resolution)")
            iters *= 2
        else:
            break
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return span / iters, (time.perf_counter() - t0) * 1e3 / iters
