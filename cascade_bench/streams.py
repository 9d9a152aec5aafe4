"""The paper's calibrated device streams: a frozen copy of the generator.

Copied from ``repro_torch/sim/synthetic.py`` (fixture version 2: one
``np.random.SeedSequence(seed)`` child per seed, block draws of z, u and
eps in that order, the batched alpha bisection), cut to the one-seed
``device_streams`` the benchmark needs. It lives here so that a change to
the program's generator cannot move the yardstick. numpy only.

    z_j ~ N(0, 1)                                  (sample difficulty)
    P(correct_light) = sigmoid(alpha_l - BETA z_j)
    confidence       = sigmoid(GAMMA (alpha_l - BETA z_j) + CONF_NOISE eps)

alpha_l is fitted by bisection so that the light model's marginal
accuracy matches its profile.
"""
from __future__ import annotations

import numpy as np

BETA = 2.2
GAMMA = 2.5
CONF_NOISE = 0.6


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _sigmoid_into(x: np.ndarray) -> np.ndarray:
    np.negative(x, out=x)
    np.exp(x, out=x)
    x += 1.0
    np.reciprocal(x, out=x)
    return x


def _fit_alpha_batched(target_acc, bz: np.ndarray, buf: np.ndarray):
    """alpha over the leading axes of ``bz`` (..., M) = BETA z, by 60
    rounds of bisection in [-10, 10]."""
    target = np.broadcast_to(np.asarray(target_acc, np.float64),
                             bz.shape[:-1])
    lo = np.full(target.shape, -10.0)
    hi = np.full(target.shape, 10.0)
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        np.subtract(mid[..., None], bz, out=buf)
        below = _sigmoid_into(buf).mean(axis=-1) < target
        lo = np.where(below, mid, lo)
        hi = np.where(below, hi, mid)
    return 0.5 * (lo + hi)


def device_streams(n_devices: int, samples: int, light_acc: float,
                   heavy_acc: float, seed: int) -> dict:
    """``confidence`` (N, M) float32, ``correct_light`` (N, M) int8 and
    ``correct_heavy`` (N, M) int8 of one seed, equal bit for bit to the
    program's ``synthetic.device_streams(...)`` (its one server column)."""
    n, m = int(n_devices), int(samples)
    rng = np.random.default_rng(np.random.SeedSequence(int(seed)).spawn(1)[0])
    z = rng.standard_normal((n, m))
    u = rng.random((n, m))
    eps = rng.standard_normal((n, m))
    bz = BETA * z
    buf = np.empty_like(bz)
    a_l = _fit_alpha_batched(np.full(n, float(light_acc)), bz, buf)
    logits_l = a_l[:, None] - bz
    correct_l = (u < _sigmoid(logits_l)).astype(np.int8)
    a_h = _fit_alpha_batched(float(heavy_acc), bz, buf)
    np.subtract(a_h[:, None], bz, out=buf)
    correct_h = (u < _sigmoid_into(buf)).astype(np.int8)
    conf = _sigmoid(GAMMA * logits_l + CONF_NOISE * eps)
    return {"confidence": conf.astype(np.float32),
            "correct_light": correct_l, "correct_heavy": correct_h}
