"""The port's offline calibration and confidence metrics held to the JAX
package on the CPU.

The same seeded numpy inputs go through ``repro.core.calibration`` /
``repro.core.decision`` and their ``repro_torch`` counterparts.
Tolerances:

* thresholds, forward fractions and cascade accuracies: equal (the search
  is numpy on both sides, over confidences that agree to the bit or
  within the metric's tolerance far from any grid point);
* BvSB confidences: 1e-6 (the gate of ``tests/test_torch_kernels.py``
  against the Pallas kernel), top-1 exact;
* top-1 and entropy metrics: 1e-6 (float32 softmax and log-softmax taken
  in another order), top-1 exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import calibration as jcal
from repro.core import decision as jdecision
from repro.sim import synthetic as jsynthetic
from repro_torch.core import calibration
from repro_torch.core import decision
from repro_torch.sim import synthetic

torch.set_num_threads(2)

CONF_ATOL = 1e-6


def _logits(b, v, scale, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, v)) * scale).astype(np.float32)


@pytest.mark.parametrize("metric", ["top1", "entropy"])
@pytest.mark.parametrize("scale", [0.1, 1.0, 4.0, 16.0])
def test_confidence_metrics_match_jax(metric, scale):
    """Random (256, 2048) logits at four scales, from nearly flat to
    nearly one-hot: confidences within 1e-6, top-1 exact."""
    x = _logits(256, 2048, scale, int(scale * 10))
    conf, top1 = decision.METRICS[metric](torch.from_numpy(x))
    jconf, jtop1 = jdecision.METRICS[metric](jnp.asarray(x))
    assert conf.dtype == torch.float32 and top1.dtype == torch.int32
    np.testing.assert_allclose(conf.numpy(), np.asarray(jconf),
                               atol=CONF_ATOL, rtol=0)
    np.testing.assert_array_equal(top1.numpy(), np.asarray(jtop1))


def test_decide_matches_jax():
    rng = np.random.default_rng(3)
    conf = rng.uniform(0, 1, 500).astype(np.float32)
    th = rng.uniform(0, 1, 500).astype(np.float32)
    np.testing.assert_array_equal(
        decision.decide(torch.from_numpy(conf), torch.from_numpy(th)).numpy(),
        np.asarray(jdecision.decide(jnp.asarray(conf), jnp.asarray(th))))


@pytest.mark.parametrize("metric", ["bvsb", "top1", "entropy"])
def test_score_logits_matches_jax(metric):
    x = _logits(300, 1000, 3.0, 7)
    conf, pred = calibration.score_logits(x, metric=metric)
    jconf, jpred = jcal.score_logits(jnp.asarray(x), metric=metric)
    assert isinstance(conf, np.ndarray) and conf.shape == (300,)
    np.testing.assert_allclose(conf, jconf, atol=CONF_ATOL, rtol=0)
    np.testing.assert_array_equal(pred, jpred)


@pytest.mark.parametrize("light,heavy", [(0.7185, 0.7829), (0.7502, 0.8149),
                                         (0.7704, 0.8341)])
def test_calibrate_static_threshold_matches_jax(light, heavy):
    """The paper's protocol on the calibration split of each device tier
    against each server: the same threshold and info dict."""
    cal = synthetic.calibration_set(light, heavy)
    jc = jsynthetic.calibration_set(light, heavy)
    assert np.array_equal(cal.confidence, jc.confidence)
    t, info = calibration.calibrate_static_threshold(
        cal.confidence, cal.correct_light, cal.correct_heavy[:, 0])
    jt, jinfo = jcal.calibrate_static_threshold(
        jc.confidence, jc.correct_light, jc.correct_heavy[:, 0])
    assert t == jt and info == jinfo


def test_calibrate_static_threshold_takes_step_two():
    """Where ~30% forwarded costs more than 1 pp of accuracy, the lowest
    threshold within 1 pp of the best (step 2) in both packages."""
    rng = np.random.default_rng(11)
    conf = rng.uniform(0, 1, 4000)
    correct_l = (rng.uniform(0, 1, 4000) < conf ** 3).astype(np.int8)
    correct_h = np.ones(4000, np.int8)
    t, info = calibration.calibrate_static_threshold(conf, correct_l,
                                                     correct_h)
    jt, jinfo = jcal.calibrate_static_threshold(conf, correct_l, correct_h)
    assert t == jt and info == jinfo
    assert info["forward_fraction"] > 0.30


@pytest.mark.parametrize("threshold", [0.0, 0.35, 0.5, 1.0])
def test_cascade_accuracy_and_forward_fraction_match_jax(threshold):
    cal = synthetic.calibration_set(0.75, 0.81, n=2000, seed=5)
    args = (cal.confidence, cal.correct_light, cal.correct_heavy[:, 0],
            threshold)
    assert calibration.cascade_accuracy(*args) == jcal.cascade_accuracy(*args)
    assert (calibration.forward_fraction(cal.confidence, threshold)
            == jcal.forward_fraction(cal.confidence, threshold))


def test_calibrate_from_logits_matches_jax():
    """Light-model logits scored by BvSB, then the protocol: the same
    threshold, from confidences within 1e-6 of each other."""
    x = _logits(2000, 512, 2.5, 13)
    rng = np.random.default_rng(14)
    correct_l = rng.integers(0, 2, 2000).astype(np.int8)
    correct_h = rng.integers(0, 2, 2000).astype(np.int8)
    t, info = calibration.calibrate_from_logits(x, correct_l, correct_h)
    jt, jinfo = jcal.calibrate_from_logits(jnp.asarray(x), correct_l,
                                           correct_h)
    assert t == jt and info == jinfo
