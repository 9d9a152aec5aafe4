"""Calibrated synthetic sample model.

Own copy of the JAX package's ``sim/synthetic.py`` (numpy only): the same
generators, draw order and fixture version, so every array equals the
reference's bit for bit (tests/test_torch_sim.py).

The paper's metrics (accuracy, SLO satisfaction, throughput) are
functionals of per-sample tuples (confidence_light, correct_light,
correct_heavy) plus latency profiles. We generate those tuples from a
latent-difficulty model calibrated to the paper's Table I accuracies:

    z_j ~ N(0, 1)                                (sample difficulty)
    P(correct_light)  = sigmoid(alpha_l - beta * z_j)
    P(correct_heavy)  = sigmoid(alpha_h - beta * z_j)   (same z -> the
                        heavy model is better *on the same samples*)
    confidence        = sigmoid(gamma * (alpha_l - beta * z_j) + eps)

alpha is fitted by bisection so the marginal accuracy matches the profile;
the shared z induces the positive light/heavy correlation that makes
cascades work (forwarded low-confidence samples are exactly the ones the
heavy model fixes). gamma/noise control confidence sharpness, chosen so
the BvSB distribution gives the paper-like operating point (~30 % of
samples below threshold ~0.35-0.5 for the low tier).

Vectorized sweep generation (fixture v2)
----------------------------------------
``device_streams`` / ``batched_device_streams`` generate a whole
``(n_seeds, n_devices, samples)`` block in one vectorized pass instead of
per-seed/per-device Python loops: one ``(N, M)`` draw per array per sweep
seed, and a *batched* bisection alpha-fit over the ``(S, N)`` (and
``(S, N)`` per server profile) accuracy grid — at sweep scale (1000s of
points x 5000 samples/device) host-side stream generation otherwise
becomes the bottleneck before the simulator does.

Seed derivation changed with the vectorization
(``STREAM_FIXTURE_VERSION = 2``): v1 derived per-device generators from
``seed * 1000 + i``, which collides across sweep seeds once
``n_devices >= 1000`` (seed 0's device 1000 replayed seed 1's device 0 —
exactly the fleet size the sharded sweep engine opens up). v2 keys one
generator per sweep seed from a spawned ``np.random.SeedSequence(seed)``
child and takes per-device streams as rows of its block draws, so
streams of distinct sweep seeds are independent at any fleet size.
Golden fixtures capturing concrete metric values (tests/golden) must be
regenerated when this version bumps.

Non-stationary arrival tensors (``piecewise_arrivals`` /
``mmpp_arrivals``, for the dynamic-environment scenarios) draw from an
independent SeedSequence child of the same sweep seed, so they compose
with any existing stream fixture without changing its values.
"""
from __future__ import annotations

import dataclasses

import numpy as np

BETA = 2.2
GAMMA = 2.5
CONF_NOISE = 0.6
STREAM_FIXTURE_VERSION = 2   # bump when stream derivation changes


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _fit_alpha(target_acc: float, z: np.ndarray, beta: float) -> float:
    lo, hi = -10.0, 10.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        acc = _sigmoid(mid - beta * z).mean()
        if acc < target_acc:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


@dataclasses.dataclass
class SampleStream:
    """Per-device pre-generated sample stream."""
    confidence: np.ndarray     # (n,) in [0, 1]
    correct_light: np.ndarray  # (n,) {0,1}
    correct_heavy: np.ndarray  # (n, n_server_profiles) {0,1}

    def __len__(self):
        return len(self.confidence)


def generate(n: int, light_acc: float, heavy_acc, seed: int,
             calib_z: np.ndarray | None = None) -> SampleStream:
    """heavy_acc may be a scalar or a list (one column per server model,
    generated with common random numbers so switching is consistent)."""
    heavy_accs = np.atleast_1d(np.asarray(heavy_acc, np.float64))
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(n)
    zfit = calib_z if calib_z is not None else z
    a_l = _fit_alpha(light_acc, zfit, BETA)
    p_l = _sigmoid(a_l - BETA * z)
    u = rng.random(n)
    correct_l = (u < p_l).astype(np.int8)
    cols = []
    for acc in heavy_accs:
        a_h = _fit_alpha(float(acc), zfit, BETA)
        cols.append((u < _sigmoid(a_h - BETA * z)).astype(np.int8))
    correct_h = np.stack(cols, axis=1)
    conf = _sigmoid(GAMMA * (a_l - BETA * z)
                    + CONF_NOISE * rng.standard_normal(n))
    return SampleStream(conf.astype(np.float32), correct_l, correct_h)


def calibration_set(light_acc: float, heavy_acc: float, n: int = 10_000,
                    seed: int = 123) -> SampleStream:
    """The paper's offline calibration split (first 10k val images)."""
    return generate(n, light_acc, heavy_acc, seed)


def _seed_rng(seed: int) -> np.random.Generator:
    """One generator per sweep seed, keyed by a spawned SeedSequence
    child — no arithmetic on raw seeds, so distinct sweep seeds can
    never replay each other's device streams (the v1 ``seed*1000 + i``
    derivation collided once n_devices >= 1000)."""
    return np.random.default_rng(np.random.SeedSequence(int(seed)).spawn(1)[0])


def _child_rng(seed: int, child: int) -> np.random.Generator:
    """Generator for an independent per-seed sub-stream.

    Child 0 is the sample-stream generator (``_seed_rng``); arrival
    processes use child 1 and churn schedules child 2 — spawned children
    of one ``SeedSequence`` are mutually independent, so adding a
    scenario to a sweep seed never disturbs its sample streams (fixture
    v2 values are unchanged)."""
    return np.random.default_rng(
        np.random.SeedSequence(int(seed)).spawn(child + 1)[child])


def _sigmoid_into(x: np.ndarray) -> np.ndarray:
    """In-place sigmoid: same op sequence as ``_sigmoid``, no temps."""
    np.negative(x, out=x)            # sigmoid(x) = 1 / (1 + exp(-x))
    np.exp(x, out=x)
    x += 1.0
    np.reciprocal(x, out=x)
    return x


def _fit_alpha_batched(target_acc, bz: np.ndarray, *,
                       buf: np.ndarray | None = None) -> np.ndarray:
    """``_fit_alpha`` vectorized over leading axes.

    target_acc: broadcastable to ``bz.shape[:-1]`` (e.g. an (S, N) grid);
    bz: (..., M) pre-scaled difficulty draws (``beta * z``, hoisted by
    the caller so multi-profile fits share it); buf: optional (..., M)
    work buffer reused across the 60 bisection rounds (the full-block
    temps dominate the cost otherwise). Returns alpha of shape
    ``bz.shape[:-1]``, elementwise identical to the scalar bisection.
    """
    target = np.broadcast_to(np.asarray(target_acc, np.float64),
                             bz.shape[:-1])
    lo = np.full(target.shape, -10.0)
    hi = np.full(target.shape, 10.0)
    if buf is None:
        buf = np.empty_like(bz)
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        np.subtract(mid[..., None], bz, out=buf)
        below = _sigmoid_into(buf).mean(axis=-1) < target
        lo = np.where(below, mid, lo)
        hi = np.where(below, hi, mid)
    return 0.5 * (lo + hi)


def _stream_blocks(seeds, n_devices: int, samples_per_device: int,
                   light_accs, heavy_acc):
    """The vectorized generation pass shared by ``device_streams`` and
    ``batched_device_streams``: per sweep seed one (N, M) block draw per
    array (z, u, eps — in that order, matching ``generate``), then a
    single batched alpha bisection over the (S, N) accuracy grid plus
    one per server profile. ``_reference_stream_blocks`` is the loop
    spec this must match bitwise."""
    n, m = n_devices, samples_per_device
    s = len(seeds)
    light = np.broadcast_to(np.asarray(light_accs, np.float64), (n,))
    heavy = np.atleast_1d(np.asarray(heavy_acc, np.float64))        # (P,)
    z = np.empty((s, n, m))
    u = np.empty((s, n, m))
    eps = np.empty((s, n, m))
    for i, seed in enumerate(seeds):
        rng = _seed_rng(seed)
        z[i] = rng.standard_normal((n, m))
        u[i] = rng.random((n, m))
        eps[i] = rng.standard_normal((n, m))
    bz = BETA * z                    # hoisted: shared by every alpha fit
    buf = np.empty_like(bz)          # one work buffer for fits + sigmoids
    a_l = _fit_alpha_batched(light[None, :], bz, buf=buf)           # (S, N)
    logits_l = a_l[..., None] - bz
    correct_l = (u < _sigmoid(logits_l)).astype(np.int8)
    cols = []
    for acc in heavy:
        a_h = _fit_alpha_batched(acc, bz, buf=buf)                  # (S, N)
        np.subtract(a_h[..., None], bz, out=buf)
        cols.append((u < _sigmoid_into(buf)).astype(np.int8))
    correct_h = np.stack(cols, axis=-1)                       # (S, N, M, P)
    conf = _sigmoid(GAMMA * logits_l + CONF_NOISE * eps)
    return {
        "confidence": conf.astype(np.float32),
        "correct_light": correct_l,
        "correct_heavy": correct_h,
    }


def _reference_stream_blocks(seeds, n_devices: int, samples_per_device: int,
                             light_accs, heavy_acc):
    """Per-seed/per-device loop spec of ``_stream_blocks`` (tests only):
    same generators, same draw order, scalar ``_fit_alpha`` per device —
    the vectorized pass must reproduce it bitwise."""
    n, m = n_devices, samples_per_device
    light = np.broadcast_to(np.asarray(light_accs, np.float64), (n,))
    heavy = np.atleast_1d(np.asarray(heavy_acc, np.float64))
    out = []
    for seed in seeds:
        rng = _seed_rng(seed)
        z = np.stack([rng.standard_normal(m) for _ in range(n)])
        u = np.stack([rng.random(m) for _ in range(n)])
        eps = np.stack([rng.standard_normal(m) for _ in range(n)])
        conf = np.empty((n, m), np.float32)
        correct_l = np.empty((n, m), np.int8)
        correct_h = np.empty((n, m, len(heavy)), np.int8)
        for i in range(n):
            a_l = _fit_alpha(float(light[i]), z[i], BETA)
            correct_l[i] = (u[i] < _sigmoid(a_l - BETA * z[i]))
            for p, acc in enumerate(heavy):
                a_h = _fit_alpha(float(acc), z[i], BETA)
                correct_h[i, :, p] = (u[i] < _sigmoid(a_h - BETA * z[i]))
            conf[i] = _sigmoid(GAMMA * (a_l - BETA * z[i])
                               + CONF_NOISE * eps[i])
        out.append({"confidence": conf, "correct_light": correct_l,
                    "correct_heavy": correct_h})
    return {k: np.stack([o[k] for o in out])
            for k in ("confidence", "correct_light", "correct_heavy")}


STREAM_CHUNK_DEVICES = 4096   # default device-axis chunk of the lazy API


class StreamChunks:
    """Lazy device-axis-chunked view of the fixture-v2 stream tensors.

    The dense ``_stream_blocks`` pass allocates ~6 float64 work arrays of
    the full ``(n_seeds, N, M)`` shape (z/u/eps draws, the scaled ``bz``,
    a bisection buffer, logits) — at fleet scale (N = 100k) the
    generation *temps* dwarf the float32/int8 tensors the simulator
    actually consumes. This object generates the SAME values (bitwise:
    fixture ``STREAM_FIXTURE_VERSION = 2`` is unchanged) one device-axis
    chunk at a time, so peak generation memory is O(chunk), independent
    of the fleet size.

    How chunking reproduces the block draw: a numpy ``Generator`` fills
    any output shape sequentially from its bit stream, so chunked draws
    from a generator at the right stream position equal the rows of one
    big block draw. v2 draws, per sweep seed, ``z`` (all N·M normals),
    then ``u`` (N·M uniforms), then ``eps`` (N·M normals) from one
    SeedSequence-keyed generator — three cursors into one stream. We
    keep three positioned generators per seed (``z`` at the start;
    ``u``'s start state reached by drawing-and-discarding the z pass
    chunk-wise; ``eps``'s by discarding the u pass) and advance them in
    lockstep as ``chunks()`` walks the device axis. Positioning costs
    one extra draw pass per array with O(chunk) scratch — time ~2x the
    dense pass, memory ~N/chunk times smaller.

    Iterate with ``chunks()`` (in order, restartable), or call
    ``materialize()`` for the dense dict (filled chunk-at-a-time: peak =
    the final float32/int8 tensors + one chunk of float64 temps).
    """

    def __init__(self, seeds, n_devices: int, samples_per_device: int,
                 light_accs, heavy_acc,
                 chunk_devices: int = STREAM_CHUNK_DEVICES):
        self.seeds = tuple(int(s) for s in seeds)
        self.n_devices = int(n_devices)
        self.samples_per_device = int(samples_per_device)
        self.light_accs = np.broadcast_to(
            np.asarray(light_accs, np.float64), (self.n_devices,)).copy()
        self.heavy_acc = np.atleast_1d(
            np.asarray(heavy_acc, np.float64)).copy()
        self.chunk_devices = max(1, int(chunk_devices))

    @property
    def shape(self):
        return (len(self.seeds), self.n_devices, self.samples_per_device)

    @property
    def n_profiles(self):
        return len(self.heavy_acc)

    def _positioned_rngs(self):
        """Per-seed (rng_z, rng_u, rng_eps) at their v2 stream positions."""
        n, m, g = self.n_devices, self.samples_per_device, self.chunk_devices
        out = []
        for seed in self.seeds:
            rng_z = _seed_rng(seed)
            rng_u = _seed_rng(seed)
            for lo in range(0, n, g):          # discard the z pass
                rng_u.standard_normal((min(g, n - lo), m))
            rng_eps = np.random.default_rng(0)
            rng_eps.bit_generator.state = rng_u.bit_generator.state
            for lo in range(0, n, g):          # discard the u pass
                rng_eps.random((min(g, n - lo), m))
            out.append((rng_z, rng_u, rng_eps))
        return out

    def chunks(self):
        """Yield ``(lo, hi, block)`` walking the device axis in order;
        ``block`` holds ``confidence`` (S, hi-lo, M) float32,
        ``correct_light`` (S, hi-lo, M) int8 and ``correct_heavy``
        (S, hi-lo, M, P) int8 — bitwise equal to the dense v2 tensors'
        ``[:, lo:hi]`` slices."""
        n, m = self.n_devices, self.samples_per_device
        s, g = len(self.seeds), self.chunk_devices
        rngs = self._positioned_rngs()
        for lo in range(0, n, g):
            hi = min(lo + g, n)
            w = hi - lo
            z = np.empty((s, w, m))
            u = np.empty((s, w, m))
            eps = np.empty((s, w, m))
            for i, (rng_z, rng_u, rng_eps) in enumerate(rngs):
                z[i] = rng_z.standard_normal((w, m))
                u[i] = rng_u.random((w, m))
                eps[i] = rng_eps.standard_normal((w, m))
            bz = BETA * z
            buf = np.empty_like(bz)
            a_l = _fit_alpha_batched(self.light_accs[None, lo:hi], bz,
                                     buf=buf)
            logits_l = a_l[..., None] - bz
            correct_l = (u < _sigmoid(logits_l)).astype(np.int8)
            cols = []
            for acc in self.heavy_acc:
                a_h = _fit_alpha_batched(acc, bz, buf=buf)
                np.subtract(a_h[..., None], bz, out=buf)
                cols.append((u < _sigmoid_into(buf)).astype(np.int8))
            conf = _sigmoid(GAMMA * logits_l + CONF_NOISE * eps)
            yield lo, hi, {
                "confidence": conf.astype(np.float32),
                "correct_light": correct_l,
                "correct_heavy": np.stack(cols, axis=-1),
            }

    def materialize(self):
        """Dense stream dict, filled chunk-at-a-time (peak extra memory =
        one chunk of float64 temps — vs the full-size temps of
        ``_stream_blocks``). Values are bitwise fixture-v2."""
        s, n, m = self.shape
        out = {
            "confidence": np.empty((s, n, m), np.float32),
            "correct_light": np.empty((s, n, m), np.int8),
            "correct_heavy": np.empty((s, n, m, self.n_profiles), np.int8),
        }
        for lo, hi, blk in self.chunks():
            for k, v in blk.items():
                out[k][:, lo:hi] = v
        return out


def chunked_device_streams(seeds, n_devices: int, samples_per_device: int,
                           light_accs, heavy_acc,
                           chunk_devices: int = STREAM_CHUNK_DEVICES):
    """Lazy chunked streams for fleet-scale sweeps.

    Args as ``batched_device_streams`` plus ``chunk_devices`` (device-
    axis chunk width). Returns a :class:`StreamChunks` — pass it
    directly to ``jaxsim.run``/``run_sweep`` (they materialize it
    chunk-at-a-time) or iterate ``chunks()`` yourself. Values are
    bitwise identical to ``batched_device_streams`` at any chunk size
    (fixture ``STREAM_FIXTURE_VERSION = 2``; pinned by
    tests/test_scale.py)."""
    return StreamChunks(seeds, n_devices, samples_per_device, light_accs,
                        heavy_acc, chunk_devices)


def device_streams(n_devices: int, samples_per_device: int, light_accs,
                   heavy_acc, seed: int):
    """Stacked sample streams for the vectorized simulator, one seed.

    Args:
      n_devices / samples_per_device: stream tensor shape (N, S).
      light_accs: scalar or (N,) per-device light-model marginal
        accuracy in [0, 1] (the alpha bisection hits it exactly on the
        calibration draw).
      heavy_acc: scalar or (P,) per-server-profile heavy-model accuracy
        — one ``correct_heavy`` column per profile, drawn with common
        random numbers so model switching is consistent.
      seed: sweep seed; derivation is SeedSequence-keyed (fixture
        ``STREAM_FIXTURE_VERSION = 2`` — bumping it invalidates golden
        fixtures, see the module docstring).

    Returns a dict: ``confidence`` (N, S) float32 in [0, 1],
    ``correct_light`` (N, S) int8 {0, 1}, ``correct_heavy`` (N, S, P)
    int8. Merge an ``arrive`` tensor from ``piecewise_arrivals`` /
    ``mmpp_arrivals`` into the same dict for non-stationary arrivals.
    """
    blocks = _stream_blocks((seed,), n_devices, samples_per_device,
                            light_accs, heavy_acc)
    return {k: v[0] for k, v in blocks.items()}


def batched_device_streams(seeds, n_devices: int, samples_per_device: int,
                           light_accs, heavy_acc):
    """Stacked streams for a whole sweep in one vectorized call.

    Args as ``device_streams`` with ``seeds`` a sequence of sweep seeds.
    Returns dict of ``(len(seeds), n_devices, samples_per_device[, P])``
    tensors whose per-seed slices are bitwise identical to
    ``device_streams(..., seed)`` (pinned by tests against the loop
    spec) — the batch axis feeds ``jaxsim.run_sweep`` directly.
    """
    return _stream_blocks(tuple(seeds), n_devices, samples_per_device,
                          light_accs, heavy_acc)


# ---------------------------------------------------------------------------
# non-stationary arrival processes (dynamic-environment scenarios)
#
# Both generators return CUMULATIVE arrival times, float32, shape
# (len(seeds), n_devices, samples_per_device): sample k of a device
# becomes available at arrive[..., k] seconds — feed the tensor to the
# simulators as streams["arrive"] (all-zeros = the saturated legacy
# model). Rates are in samples/second; pass rates around a device's
# service rate 1/latency to move between backlogged (arrivals faster
# than service: bitwise-saturated behaviour) and idle-gapped regimes.
# Draws come from SeedSequence child 1 of each sweep seed (_child_rng),
# independent of the sample-stream draws — attaching arrivals to an
# existing sweep seed never changes its confidence/correctness streams.
# ---------------------------------------------------------------------------
def piecewise_arrivals(seeds, n_devices: int, samples_per_device: int,
                       rates, seg_fracs=None):
    """Piecewise-constant-rate Poisson arrivals (rate drift).

    The sample axis is split into ``len(rates)`` segments (by
    ``seg_fracs`` fractions, equal by default) and gap ``k`` is drawn
    ``Exp(1 / rate_seg(k))`` — a workload whose rate steps through
    ``rates`` as the stream progresses. ``rates``: per-segment arrival
    rates, samples/s — scalars (shared) or (n_devices,) vectors.

    Returns cumulative arrival times (len(seeds), N, S) float32.
    """
    n, m = n_devices, samples_per_device
    rates = [np.broadcast_to(np.asarray(r, np.float64), (n,))
             for r in rates]
    k = len(rates)
    if seg_fracs is None:
        seg_fracs = (1.0 / k,) * k
    if len(seg_fracs) != k:
        raise ValueError(f"{len(seg_fracs)} seg_fracs for {k} rates")
    if abs(sum(seg_fracs) - 1.0) > 1e-6:
        raise ValueError(
            f"seg_fracs must sum to 1 (got {sum(seg_fracs)}): every "
            f"sample must belong to a rate segment")
    edges = np.minimum(np.round(np.cumsum(seg_fracs) * m), m).astype(int)
    edges[-1] = m                    # rounding must not orphan the tail
    seg_of = np.searchsorted(edges, np.arange(m), side="right")  # (M,)
    rate = np.stack(rates, axis=0)[seg_of]                   # (M, N)
    mean_gap = (1.0 / rate).T                                # (N, M)
    out = np.empty((len(seeds), n, m))
    for i, seed in enumerate(seeds):
        rng = _child_rng(seed, 1)
        out[i] = rng.standard_exponential((n, m)) * mean_gap
    return np.cumsum(out, axis=-1).astype(np.float32)


def mmpp_arrivals(seeds, n_devices: int, samples_per_device: int,
                  rate_hi, rate_lo, switch_prob: float = 0.05):
    """Bursty MMPP-style arrivals: a symmetric two-state modulating
    chain per device (state flips between draws with ``switch_prob``),
    gaps drawn ``Exp(1 / rate_state)`` — bursts at ``rate_hi``
    alternating with lulls at ``rate_lo``. Rates are samples/s, scalar
    or (n_devices,). The symmetric chain vectorizes exactly: the state
    sequence is the parity of the cumulative flip count.

    Returns cumulative arrival times (len(seeds), N, S) float32.
    """
    n, m = n_devices, samples_per_device
    hi = np.broadcast_to(np.asarray(rate_hi, np.float64), (n,))
    lo = np.broadcast_to(np.asarray(rate_lo, np.float64), (n,))
    out = np.empty((len(seeds), n, m))
    for i, seed in enumerate(seeds):
        rng = _child_rng(seed, 1)
        start_hi = rng.random((n, 1)) < 0.5
        flips = rng.random((n, m)) < switch_prob     # before each draw
        in_hi = start_hi ^ (np.cumsum(flips, axis=-1) % 2).astype(bool)
        mean_gap = np.where(in_hi, 1.0 / hi[:, None], 1.0 / lo[:, None])
        out[i] = rng.standard_exponential((n, m)) * mean_gap
    return np.cumsum(out, axis=-1).astype(np.float32)
