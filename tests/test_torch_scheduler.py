"""The port's schedulers held bitwise to the JAX package.

Identical SR / batch sequences go through ``repro.core`` and
``repro_torch.core``; thresholds, multipliers and S(C) must be equal bit
for bit (float32 control updates in the same operation order). The cases
are those of tests/test_scheduler.py. The JAX side runs MultiTASC++'s
update jitted, as its host wrapper and simulators run it: XLA fuses one
multiply-add there (see ``repro_torch.core.multitascpp.update``), so the
eager JAX op-by-op result differs in the last bits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.cascade_tiers import SERVER_PROFILES as J_SERVER_PROFILES
from repro.core import multitasc as jmt
from repro.core import multitascpp as jmtpp
from repro.core import static as jstatic
from repro.core import switching as jswitching
from repro_torch.configs.cascade_tiers import SERVER_PROFILES
from repro_torch.core import multitasc as mt
from repro_torch.core import multitascpp as mtpp
from repro_torch.core import static
from repro_torch.core import switching

torch.set_num_threads(2)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _assert_bitwise(a, b):
    assert np.array_equal(_bits(a), _bits(b)), (np.asarray(a), np.asarray(b))


def _pair_update(thresh, mult, sr, **kw):
    """One MultiTASC++ update through both packages from the same state."""
    cfg = kw.pop("cfg", mtpp.MultiTASCPPConfig())
    jcfg = jmtpp.MultiTASCPPConfig(**vars(cfg))
    thresh, mult, sr = (np.asarray(a, np.float32) for a in (thresh, mult, sr))
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    jnew = jmtpp._update_jit({"thresh": jnp.asarray(thresh),
                              "mult": jnp.asarray(mult)}, jnp.asarray(sr),
                             jcfg, **jkw)
    tnew = mtpp.update({"thresh": torch.from_numpy(thresh),
                        "mult": torch.from_numpy(mult)},
                       torch.from_numpy(sr), cfg, **tkw)
    for key in ("thresh", "mult"):
        _assert_bitwise(tnew[key].numpy(), jnew[key])
    return tnew


UPDATE_CASES = [
    dict(thresh=[0.5] * 3, mult=[1.0] * 3, sr=[80.0, 95.0, 100.0]),
    dict(thresh=[0.5], mult=[1.0], sr=[85.0]),
    dict(thresh=[0.5], mult=[1.0], sr=[100.0], n_active=1),
    dict(thresh=[0.5], mult=[1.1], sr=[100.0], n_active=1),
    dict(thresh=[0.5], mult=[1.21], sr=[50.0], n_active=1),
    dict(thresh=[0.5], mult=[1.0], sr=[100.0], n_active=100),
    dict(thresh=[0.5, 0.5], mult=[1.0, 1.0], sr=[90.0, 90.0],
         sr_target=np.array([95.0, 85.0], np.float32)),
    dict(thresh=[0.5, 0.5], mult=[1.0, 1.0], sr=[50.0, 50.0],
         active=np.array([True, False])),
    dict(thresh=[0.999, 0.001], mult=[3.0, 1.0], sr=[100.0, 0.0],
         sr_target=np.array([50.0, 100.0], np.float32), n_active=7),
]


@pytest.mark.parametrize("case", UPDATE_CASES)
def test_multitascpp_update_bitwise(case):
    _pair_update(**dict(case))


def test_multitascpp_update_random_sweep_bitwise():
    """The property-test ranges of tests/test_scheduler.py, drawn once."""
    rng = np.random.default_rng(0)
    n = 257
    thresh = rng.uniform(0.0, 1.0, n)
    mult = rng.uniform(1.0, 3.0, n)
    sr = rng.uniform(0.0, 100.0, n)
    target = rng.uniform(50.0, 100.0, n).astype(np.float32)
    active = rng.random(n) < 0.7
    new = _pair_update(thresh, mult, sr, sr_target=target, n_active=n)
    assert float(new["thresh"].min()) >= 0.0 and float(new["thresh"].max()) <= 1.0
    _pair_update(thresh, mult, sr, sr_target=target, active=active)


def test_multitascpp_wrapper_trajectory_bitwise():
    """The host wrappers over a report sequence, with device churn."""
    n = 5
    j = jmtpp.MultiTASCPP(n, init_threshold=0.5)
    t = mtpp.MultiTASCPP(n, init_threshold=0.5)
    rng = np.random.default_rng(1)
    for step in range(60):
        if step % 20 == 10:
            active = rng.random(n) < 0.6
            j.set_active(active)
            t.set_active(active)
        i = int(rng.integers(n))
        sr = float(rng.choice([100.0, rng.uniform(0, 100)]))
        assert np.float32(j.report(i, sr)) == np.float32(t.report(i, sr))
        _assert_bitwise(t.thresholds(), j.thresholds())
        _assert_bitwise(t.state["mult"].numpy(), j.state["mult"])


@pytest.mark.parametrize("observed", [64, 2, 16, 17, 15])
def test_multitasc_update_bitwise(observed):
    cfg, jcfg = mt.MultiTASCConfig(step=0.05), jmt.MultiTASCConfig(step=0.05)
    thresh = np.array([0.5, 0.02, 0.99], np.float32)
    active = np.array([True, True, False])
    for act in (None, active):
        jnew = jmt.update({"thresh": jnp.asarray(thresh)}, observed, 16, jcfg,
                          active=None if act is None else jnp.asarray(act))
        tnew = mt.update({"thresh": torch.from_numpy(thresh)}, observed, 16,
                         cfg, active=act)
        _assert_bitwise(tnew["thresh"].numpy(), jnew["thresh"])


@pytest.mark.parametrize("name", sorted(SERVER_PROFILES))
@pytest.mark.parametrize("slo", [0.05, 0.1, 0.15, 0.3, 1.0])
def test_optimal_batch_matches(name, slo):
    assert mt.optimal_batch(SERVER_PROFILES[name], slo) == \
        jmt.optimal_batch(J_SERVER_PROFILES[name], slo)


def test_multitasc_wrapper_steps_bitwise():
    prof, jprof = SERVER_PROFILES["inceptionv3"], J_SERVER_PROFILES["inceptionv3"]
    t, j = mt.MultiTASC(4, prof, 0.15), jmt.MultiTASC(4, jprof, 0.15)
    assert t.b_opt == j.b_opt
    for batch in (64, 64, 1, 2, 8, 32, 0, 64):
        for s in (t, j):
            s.on_server_batch(batch)
            s.on_window(active=np.array([True, True, True, False]))
        _assert_bitwise(t.thresholds(), j.thresholds())
        assert t.report(1, 50.0) == j.report(1, 50.0)


def test_static_matches():
    t, j = static.Static(3, 0.35), jstatic.Static(3, 0.35)
    _assert_bitwise(t.thresholds(), j.thresholds())
    assert t.report(2, 10.0) == j.report(2, 10.0)


SWITCH_CASES = [
    ([0.01, 0.02, 0.5, 0.6], [0, 0, 1, 1], [0.8, 0.75], None),
    ([0.9, 0.95, 0.9, 0.9], [0, 0, 1, 1], [0.8, 0.75], None),
    ([0.5, 0.9, 0.2, 0.9], [0, 0, 1, 1], [0.8, 0.75], None),
    ([0.01, 0.9, 0.02, 0.9], [0, 1, 0, 1], [0.8, 0.75],
     [True, True, False, True]),
    ([0.9, 0.01], [0, 0], [0.8], [True, False]),
    ([0.9, 0.01], [0, 0], [0.8], [False, False]),
    ([0.05, 0.8, 0.75], [0, 0, 1], [0.8, 0.75], None),
]


@pytest.mark.parametrize("th,tiers,up,active", SWITCH_CASES)
def test_switching_decide_matches(th, tiers, up, active):
    th = np.asarray(th, np.float32)
    tiers = np.asarray(tiers, np.int32)
    up = np.asarray(up, np.float32)
    n_tiers = len(up)
    act = None if active is None else np.asarray(active)
    want = int(jswitching.decide(jnp.asarray(th), jnp.asarray(tiers), n_tiers,
                                 0.05, jnp.asarray(up),
                                 active=None if act is None else jnp.asarray(act)))
    got = switching.decide(th, tiers, n_tiers, np.float32(0.05), up,
                           active=act)
    assert got.dtype == torch.int32 and int(got) == want


def test_switching_decide_random_fleets_match():
    rng = np.random.default_rng(2)
    for _ in range(200):
        n = int(rng.integers(2, 17))
        n_tiers = int(rng.integers(1, 4))
        # mix thresholds near both switching limits with uniform ones
        th = np.choose(rng.integers(0, 3, n),
                       [rng.uniform(0, 1, n), rng.uniform(0, 0.06, n),
                        rng.uniform(0.79, 1.0, n)]).astype(np.float32)
        tiers = rng.integers(0, n_tiers, n).astype(np.int32)
        up = rng.uniform(0.7, 0.9, n_tiers).astype(np.float32)
        act = rng.random(n) < 0.8
        want = int(jswitching.decide_jit(th, tiers, n_tiers, np.float32(0.05),
                                         up, active=act))
        assert int(switching.decide(th, tiers, n_tiers, np.float32(0.05), up,
                                    active=act)) == want
