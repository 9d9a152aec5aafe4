"""Offline threshold calibration (paper Sec. V-A baseline protocol).

Given a calibration set of per-sample (confidence_light, correct_light,
correct_heavy):

1. find the threshold that forwards ~30 % of samples (balanced trade-off);
2. if cascade accuracy at that threshold is more than 1 pp below the best
   achievable cascade accuracy, use instead the *lowest* threshold within
   1 pp of the best.

Counterpart of the JAX package's ``core/calibration.py``. Scoring goes
through the port's decision metrics, so BvSB on a CUDA tensor is the
BvSB kernel, as on the serving path; the threshold search is numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import decision


def score_logits(logits, *, metric: str = "bvsb"):
    """Score raw (N, V) logits (a tensor on any device the metric
    serves, or an array, taken as a CPU tensor) through
    ``decision.METRICS``, the dispatch the serving path uses. Returns host
    arrays (conf (N,) f32, pred (N,) i32)."""
    conf, pred = decision.METRICS[metric](torch.as_tensor(logits))
    return conf.cpu().numpy(), pred.cpu().numpy()


def calibrate_from_logits(logits, correct_l, correct_h, *,
                          metric: str = "bvsb", **kwargs):
    """Calibrate a static threshold directly from light-model logits,
    scored by ``score_logits``. Returns (threshold, info) like
    ``calibrate_static_threshold``."""
    conf, _ = score_logits(logits, metric=metric)
    return calibrate_static_threshold(conf, correct_l, correct_h, **kwargs)


def cascade_accuracy(conf, correct_l, correct_h, threshold):
    fwd = conf < threshold
    return float(np.mean(np.where(fwd, correct_h, correct_l)))


def forward_fraction(conf, threshold):
    return float(np.mean(conf < threshold))


def calibrate_static_threshold(conf, correct_l, correct_h, *,
                               target_forward=0.30, max_acc_loss=0.01,
                               grid=512):
    """Returns (threshold, info dict)."""
    conf = np.asarray(conf, np.float64)
    correct_l = np.asarray(correct_l)
    correct_h = np.asarray(correct_h)
    ts = np.linspace(0.0, 1.0, grid + 1)
    accs = np.array([cascade_accuracy(conf, correct_l, correct_h, t)
                     for t in ts])
    fracs = np.array([forward_fraction(conf, t) for t in ts])
    best_acc = accs.max()

    # step 1: ~30% forwarded
    t30 = ts[int(np.argmin(np.abs(fracs - target_forward)))]
    acc30 = cascade_accuracy(conf, correct_l, correct_h, t30)
    if best_acc - acc30 <= max_acc_loss:
        t = float(t30)
    else:
        # step 2: lowest threshold within 1 pp of best
        ok = np.nonzero(best_acc - accs <= max_acc_loss)[0]
        t = float(ts[ok[0]]) if len(ok) else float(t30)
    return t, {
        "best_cascade_acc": float(best_acc),
        "acc_at_threshold": cascade_accuracy(conf, correct_l, correct_h, t),
        "forward_fraction": forward_fraction(conf, t),
        "local_acc": float(np.mean(correct_l)),
        "server_acc": float(np.mean(correct_h)),
    }
