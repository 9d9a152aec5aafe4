"""The comparison that decides ``correct``.

Two things are judged. The model step and BvSB: for every forwarded sample
of the batches the check draws, the program's confidence and prediction
against the plain reference's on the same weights and tokens. The
cascade's bookkeeping: every forwarded sample is served exactly once.

Numbers compared (each beside its limit, from ``limits/<cell>.json``),
over a sample's error, the larger of |conf - conf_ref| / p1_ref (the gap
in BvSB as a share of the reference's top probability: BvSB is a
difference of two probabilities, each about 1 / vocabulary here) and the
gap by which the logit of the program's predicted class lies below the
reference's best (0 where the two agree); both read as relative errors of
the logits:

* ``sample_err_max``: the widest error of any checked sample, nothing left
  out. A sound float32 run reads up to a few 1e-2 here: a token whose k-th
  and (k+1)-th router logits lie within rounding goes to either expert,
  and because every expert's capacity binds at these batch sizes, the swap
  can move which assignments are dropped for every later sample of the
  batch. So the limit holds every sample to the size of such a swap; an
  answer of another class or another sample reads 1 or more;
* ``sample_err_p90``: the 90th percentile of the errors. Sound runs read
  a few 1e-6 to a few 1e-5, a matrix product one precision lower 1e-2:
  this is the number that holds the bulk of the samples to float32;
* ``served_twice``: forwarded samples in more than one executed batch, or
  twice in one; ``lost``: submitted samples neither served, queued, nor
  in a batch the cut stopped. Both exact: limit 0.
"""
from __future__ import annotations

import collections
from typing import Dict, Iterable, List, Tuple

import numpy as np

NUMBERS = ("sample_err_max", "sample_err_p90", "served_twice", "lost")


def sample_readings(conf, pred, ref_logits, ref_conf, ref_p1) -> Dict:
    """Per-sample gaps of the program's (conf, pred) against the
    reference's logits (numpy, float64 arithmetic)."""
    conf = np.asarray(conf, np.float64)
    ref_logits = np.asarray(ref_logits, np.float64)
    pred = np.asarray(pred, np.int64)
    err = np.abs(conf - np.asarray(ref_conf, np.float64)) \
        / np.asarray(ref_p1, np.float64)
    valid = (pred >= 0) & (pred < ref_logits.shape[1])
    picked = np.take_along_axis(ref_logits, np.where(valid, pred, 0)[:, None],
                                axis=1)[:, 0]
    gap = np.where(valid, ref_logits.max(axis=1) - picked, np.inf)
    return {"conf_err": err, "pred_gap": gap}


def bookkeeping(submitted: Iterable[tuple], served: Iterable[Iterable[tuple]],
                queued: Iterable[tuple], cut: Iterable[tuple]) -> Dict:
    """``served_twice`` and ``lost`` (counts)."""
    counts = collections.Counter()
    for keys in served:
        counts.update(keys)
    twice = sum(c - 1 for c in counts.values() if c > 1)
    accounted = set(counts) | set(queued) | set(cut)
    lost = sum(1 for k in set(submitted) if k not in accounted)
    return {"served_twice": twice, "lost": lost}


def sample_errors(samples: List[Dict]) -> np.ndarray:
    """The error of each checked sample."""
    err = [np.maximum(s["conf_err"], s["pred_gap"]) for s in samples]
    return np.concatenate(err) if err else np.zeros(0)


def numbers(samples: List[Dict], books: Dict) -> Dict[str, float]:
    err = sample_errors(samples)
    return {"sample_err_max": float(err.max()) if err.size else np.inf,
            "sample_err_p90": (float(np.percentile(err, 90)) if err.size
                               else np.inf),
            "served_twice": float(books["served_twice"]),
            "lost": float(books["lost"])}


def tails(samples: List[Dict], k: int = 5) -> Dict:
    """The spread of the errors, for ``control.py``'s readings: count,
    median, the ``k`` widest, and the widest logit gap of a prediction."""
    err = sample_errors(samples)
    gap = np.concatenate([s["pred_gap"] for s in samples])
    return {"n": int(err.size), "p50": float(np.median(err)),
            "top": np.sort(err)[::-1][:k].tolist(),
            "pred_gap_max": float(gap.max())}


def verdict(values: Dict[str, float], limits: Dict[str, float]) \
        -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, {name: {"value", "limit"}}). A number is within its limit
    when value <= limit (NaN is not)."""
    checks = {name: {"value": values[name], "limit": float(limits[name])}
              for name in NUMBERS}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
