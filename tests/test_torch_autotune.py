"""Kernel timing and the plan autotuner (``repro_torch.kernels.timing``,
``repro_torch.kernels.autotune``) on the CPU.

* ``time_blocked`` grows its block until it spans MIN_RES_MULT times
  perf_counter's resolution.
* With no tuned file the planners' constants are the modules' own, and
  ``ops.cache_token`` is what it was.
* ``autotune.persist`` writes winners under a card's name into a file
  (keeping other cards' entries), ``ops.reload_plans`` sets the planners
  from the entry of the card asked for (and puts the defaults back for
  another card, or with no file), the plans change what the planners cut,
  and the CUDA cache token changes with them (so an executable built under
  other plans is never reused); the CPU's token does not.
* ``pick`` takes the fastest candidate that passed its checks, but keeps
  the value in force where the fastest beats it by no more than the
  spread of the in-force value's timings.
* ``failures`` names every (knob, value, shape) that disagreed with its
  plain version; float32 candidates are held to the kernel checks'
  float32 tolerances, other types to NUMERIC_ATOL.
"""
import json
import time

import pytest
import torch

from repro_torch.kernels import autotune, ops, timing
from repro_torch.kernels import bvsb as _bvsb
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import rglru_scan as _rglru

CARD = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def defaults():
    ops.reload_plans("/nonexistent/tuned.json")
    yield
    ops.reload_plans("/nonexistent/tuned.json")


def test_time_blocked_clears_its_floor():
    floor = timing.MIN_RES_MULT * timing.timer_resolution()
    calls = []
    per, wall, reps = timing.time_blocked(lambda: calls.append(1))
    assert wall >= floor and 1 <= reps <= len(calls)
    assert per == pytest.approx(wall / reps)
    per, wall, reps = timing.time_blocked(lambda: time.sleep(0.002))
    assert reps == 1 and wall >= 0.002
    assert timing.MIN_RES_MULT == 50


def test_no_tuned_file_keeps_the_constants(defaults):
    assert not ops.TUNED_PLANS_PATH.exists()
    assert ops.plans() == ops.DEFAULT_PLANS == {
        "bvsb": {"BLOCKS_PER_SM": 4, "MIN_CHUNK": 4096},
        "decode_attention": {"BLOCKS_PER_SM": 1, "SHARD_MIN_KEYS": 64},
        "rglru_scan": {"IN_FLIGHT": 32768, "STAGES": 3, "BWD_STEPS": 64}}
    assert ops.cache_token("cpu") == ("plain", "cpu")
    token = ops.cache_token("cuda")
    assert token[0] == "cuda-kernels" and ("bvsb", "MIN_CHUNK", 4096) in token


def test_persist_reload_changes_plans_and_cache_token(defaults, tmp_path):
    path = tmp_path / "tuned.json"
    cuda0, cpu0 = ops.cache_token("cuda"), ops.cache_token("cpu")
    chunks0 = _bvsb.chunks(64, 65536, 132)
    path.write_text(json.dumps({"Other Card": {"bvsb": {"MIN_CHUNK": 1024}}}))
    plans = autotune.persist({"bvsb": {"BLOCKS_PER_SM": 16},
                              "rglru_scan": {"BWD_STEPS": 32}}, CARD, path)
    assert plans["bvsb"]["BLOCKS_PER_SM"] == 16
    assert _bvsb.BLOCKS_PER_SM == 16 and _rglru.BWD_STEPS == 32
    assert _bvsb.chunks(64, 65536, 132) != chunks0
    assert _rglru.bwd_tiles(2, 3000, 4096, 4, 132)[0] == 32
    assert ops.cache_token("cuda") != cuda0
    assert ops.cache_token("cpu") == cpu0
    tuned = json.loads(path.read_text())
    assert tuned["Other Card"] == {"bvsb": {"MIN_CHUNK": 1024}}
    assert tuned[CARD] == {"bvsb": {"BLOCKS_PER_SM": 16},
                           "rglru_scan": {"BWD_STEPS": 32}}
    assert ops.reload_plans(path, "Other Card")["bvsb"] == {
        "BLOCKS_PER_SM": 4, "MIN_CHUNK": 1024}
    assert ops.reload_plans(path, "A Third Card") == ops.DEFAULT_PLANS
    assert ops.cache_token("cuda") == cuda0
    ops.reload_plans(path, CARD)
    assert ops.reload_plans(tmp_path / "none.json") == ops.DEFAULT_PLANS
    assert _decode.SHARD_MIN_KEYS == 64


def test_set_plans_refuses_unknown_constants(defaults):
    with pytest.raises(KeyError):
        ops.set_plans({"bvsb": {"VEC": 4}})
    with pytest.raises(KeyError):
        ops.set_plans({"flash_attention": {"BWD_KEYS": 32}})


def test_pick_takes_the_fastest_that_passed():
    rs = [dict(value=1, us=3.0, numerics_ok=True, current=False),
          dict(value=2, us=1.0, numerics_ok=False, current=False),
          dict(value=3, us=2.0, numerics_ok=True, current=False)]
    assert autotune.pick(rs)["value"] == 3
    assert autotune.pick([dict(value=1, us=1.0, numerics_ok=False,
                               current=True, spread_us=0.0)]) is None
    swept = {("bvsb", "MIN_CHUNK"): rs,
             ("decode_attention", "BLOCKS_PER_SM"): rs[1:2]}
    assert autotune.winners_of(swept) == {"bvsb": {"MIN_CHUNK": 3}}


def test_pick_keeps_the_value_in_force_within_its_spread():
    rs = [dict(value=32, us=35.47, numerics_ok=True, current=False),
          dict(value=64, us=35.74, numerics_ok=True, current=True,
               spread_us=0.4),
          dict(value=16, us=30.0, numerics_ok=False, current=False)]
    assert autotune.pick(rs)["value"] == 64
    rs[1]["spread_us"] = 0.2
    assert autotune.pick(rs)["value"] == 32
    rs[0]["numerics_ok"] = False
    assert autotune.pick(rs)["value"] == 64
    rs[1]["numerics_ok"] = False
    assert autotune.pick(rs) is None


def test_failures_name_every_disagreeing_cell():
    def cell(shape, err, atol, ok):
        return dict(shape=shape, plan=[2, 1], max_err=err, atol=atol, ok=ok)
    swept = {("bvsb", "MIN_CHUNK"): [
        dict(value=1024, cells=[cell("(8, 2048)", 0.0, 1e-5, True),
                                cell("(4, 256000)", 3e-5, 1e-5, False)]),
        dict(value=4096, cells=[cell("(8, 2048)", 0.0, 1e-5, False)])],
        ("rglru_scan", "STAGES"): [
        dict(value=3, cells=[cell("(4, 3000, 4096, float32)", 0.0, 0.0,
                                  True)])]}
    bad = autotune.failures(swept)
    assert len(bad) == 2
    assert bad[0].startswith("bvsb.MIN_CHUNK=1024 at (4, 256000) plan (2, 1)")
    assert "atol 1e-05)" in bad[0]
    assert bad[1].startswith("bvsb.MIN_CHUNK=4096 at (8, 2048)")
    assert "top-1 or bits differ" in bad[1]
    assert autotune.F32_ATOL == {"bvsb": 1e-5, "decode_attention": 1e-4}
    assert autotune.NUMERIC_ATOL == 2e-3


def test_every_knob_has_candidates_and_shapes():
    assert set(autotune.CANDIDATES) == set(autotune.SHAPES) == {
        (k, n) for k, (_, names) in ops.PLAN_KNOBS.items() for n in names}
    for knob, values in autotune.CANDIDATES.items():
        assert ops.DEFAULT_PLANS[knob[0]][knob[1]] in values, knob


def test_sweep_runs_on_the_card_only():
    with pytest.raises(ValueError):
        autotune.sweep(("bvsb", "MIN_CHUNK"), "cpu")
