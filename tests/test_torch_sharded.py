"""The port's sharded sweeps held to the JAX package, on four ``gloo``
ranks on the CPU.

A module-scoped fixture spawns the four ranks once (tests/sharded_ranks.py:
a ``file://`` rendezvous under the test's temporary directory, one torch
thread a rank, a group timeout) and they run every case; each test below
reads its case from every rank, checks that every rank returned the same
dict, and holds it to the references computed here:

* ``run_sweep_sharded`` against the port's own ``run_sweep`` over all B
  bit for bit, and against the JAX package's ``run_sweep`` under
  tests/test_torch_sim.py's rules (counts, per-device fields, thresholds
  and integer trace rows exact, float sums over devices within AGG_RTOL);
  the cases of tests/test_sharded.py: ``mesh=None``, a one-lane mesh, B
  divisible by the lanes, B = 3 padded over 4 lanes, a single point
  (local, not counted as sharded) and the ``sharded_points`` count;
* ``run_device_sharded`` against the JAX package's local segmented
  ``run`` with tests/test_scale.py's keys and tolerances (fleet dynamics
  and ``n_events`` exact; ``accuracy`` 1e-6 and the traces' float means
  1e-5 relative, the sums over ranks' partial sums), on that file's
  cases; and once against the JAX package's own ``run_device_sharded`` on
  a 4-device CPU mesh (a subprocess with XLA_FLAGS set).

``switching.decide_partials`` / ``decide_from_partials`` and the mesh
helpers that need no ranks are tested in this process.
"""
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import sharded_ranks as R
from repro.core import switching as jswitching
from repro.sim import jaxsim as J
from repro_torch.core import switching
from repro_torch.launch import mesh as mesh_mod
from repro_torch.sim import jaxsim
from test_torch_sim import assert_port_matches

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# a hang ends sooner, at the ranks' group timeout; this bounds ranks that
# a loaded machine runs slowly (~30 s alone, ~150 s beside a full suite)
JOIN_TIMEOUT_S = 900

# tests/test_scale.py's split of the device-sharded outputs
EXACT_KEYS = ("completed", "queue_left", "queue_peak", "sr", "throughput",
              "forwarded_frac", "per_device_sr", "per_device_acc",
              "final_thresh")
EXACT_TRACES = ("active", "server_idx", "fwd")
ULP_KEYS = ("accuracy",)
ULP_TRACES = ("thresh", "sr", "acc")


class _Ranks:
    """The four ranks' results, read once every rank has ended."""

    def __init__(self, tmp):
        self.tmp = tmp
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=R.rank_main,
                                  args=(r, str(tmp / "rendezvous"), str(tmp)))
                      for r in range(R.WORLD)]
        for p in self.procs:
            p.start()
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                               str(ROOT / "tests")]))
        self.jax_proc = subprocess.Popen(
            [sys.executable, "-c", "import sys, sharded_ranks; "
             "sharded_ranks.jax_device_sharded(sys.argv[1])",
             str(tmp / "jax.pkl")], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self._results = None

    def results(self):
        if self._results is None:
            for p in self.procs:
                p.join(JOIN_TIMEOUT_S)
            hung = [p.pid for p in self.procs if p.is_alive()]
            for p in self.procs:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
            self._results = []
            for r in range(R.WORLD):
                path = self.tmp / f"rank{r}.pkl"
                self._results.append(pickle.loads(path.read_bytes())
                                     if path.exists() else {})
            self.hung = hung
        return self._results

    def case(self, name):
        """The case's value, after checking that every rank returned one
        and that they are equal."""
        per_rank = [res.get(name) for res in self.results()]
        errors = [v["error"] for res in self._results for v in res.values()
                  if "error" in v]
        for r, got in enumerate(per_rank):
            assert got is not None, (f"rank {r} did not run {name!r} (ranks "
                                     f"killed at the join timeout: "
                                     f"{self.hung}); errors: {errors}")
            assert "error" not in got, f"rank {r}:\n{got['error']}"
        for r in range(1, R.WORLD):
            _assert_same(per_rank[r]["ok"], per_rank[0]["ok"])
        return per_rank[0]["ok"]

    def jax(self):
        out, _ = self.jax_proc.communicate(timeout=JOIN_TIMEOUT_S)
        assert self.jax_proc.returncode == 0, out
        return pickle.loads((self.tmp / "jax.pkl").read_bytes())

    def close(self):
        for p in self.procs:
            if p.is_alive():
                p.terminate()
            p.join(10)
        if self.jax_proc.poll() is None:
            self.jax_proc.kill()
            self.jax_proc.communicate(timeout=10)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = _Ranks(tmp_path_factory.mktemp("sharded"))
    yield r
    r.close()


def _assert_same(a, b, where="result"):
    """Equal bit for bit (NaN equal to NaN), through dicts and tuples."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, (str, type(None))):
        assert a == b, where
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, where
        np.testing.assert_array_equal(x, y, err_msg=where)


# ---------------------------------------------------------------------------
# S(C) from partial sums (no ranks)
# ---------------------------------------------------------------------------
def _fleet(seed, n, b=None):
    rng = np.random.default_rng(seed)
    shape = (n,) if b is None else (b, n)
    # thresholds around both limits, some saturating a tier, some inactive
    th = rng.choice([0.01, 0.04, 0.3, 0.6, 0.82, 0.9, 0.99], size=shape)
    th = (th + rng.uniform(-0.005, 0.005, shape)).astype(np.float32)
    tiers = rng.integers(0, 3, shape).astype(np.int32)
    active = rng.random(shape) < 0.8
    if seed % 3 == 1:            # one tier entirely below c_lower
        th = np.where(tiers == 1, np.float32(0.01), th)
    if seed % 3 == 2:            # every device above its tier's c_upper
        th = np.full(shape, 0.95, np.float32)
    c_upper = np.asarray([0.85, 0.8, 0.75], np.float32)
    return th, tiers, active, c_upper


@pytest.mark.parametrize("seed", range(6))
def test_decide_partials_bitwise_vs_jax(seed):
    th, tiers, active, c_upper = _fleet(seed, 37)
    for act in (None, active):
        ours = switching.decide_partials(
            torch.from_numpy(th), torch.from_numpy(tiers), 4,
            switching.DEFAULT_C_LOWER, torch.from_numpy(c_upper),
            active=None if act is None else torch.from_numpy(act))
        ref = jswitching.decide_partials(th, tiers, 4,
                                         jswitching.DEFAULT_C_LOWER, c_upper,
                                         active=act)
        assert ours.keys() == ref.keys()
        for k in ref:
            assert ours[k].dtype == torch.float32, k
            np.testing.assert_array_equal(ours[k].numpy(),
                                          np.asarray(ref[k]), err_msg=k)
        assert int(switching.decide_from_partials(ours)) == int(
            jswitching.decide_from_partials(ref))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("k", [2, 4, 7])
def test_partials_summed_over_shards_decide_as_the_fleet(seed, k):
    th, tiers, active, c_upper = _fleet(seed, 48)
    args = (4, switching.DEFAULT_C_LOWER, torch.from_numpy(c_upper))
    whole = switching.decide(torch.from_numpy(th), torch.from_numpy(tiers),
                             *args, active=torch.from_numpy(active))
    parts = [switching.decide_partials(
        torch.from_numpy(t), torch.from_numpy(ti), *args,
        active=torch.from_numpy(a))
        for t, ti, a in zip(np.array_split(th, k), np.array_split(tiers, k),
                            np.array_split(active, k))]
    summed = {key: sum(p[key] for p in parts) for key in parts[0]}
    assert int(switching.decide_from_partials(summed)) == int(whole)
    assert int(whole) == int(jswitching.decide(th, tiers, 4,
                                               jswitching.DEFAULT_C_LOWER,
                                               c_upper, active=active))


def test_partials_lane_form_is_each_lane():
    th, tiers, active, c_upper = _fleet(4, 20, b=5)
    c_lower = torch.tensor([0.05, 0.02, 0.05, 0.3, 0.05])
    lanes = switching.decide_partials(
        torch.from_numpy(th), torch.from_numpy(tiers), 4, c_lower,
        torch.from_numpy(c_upper), active=torch.from_numpy(active))
    dec = switching.decide_from_partials(lanes)
    assert dec.shape == (5,) and dec.dtype == torch.int32
    for i in range(5):
        one = switching.decide_partials(
            torch.from_numpy(th[i]), torch.from_numpy(tiers[i]), 4,
            float(c_lower[i]), torch.from_numpy(c_upper),
            active=torch.from_numpy(active[i]))
        for key in one:
            assert torch.equal(lanes[key][i], one[key]), key
        assert int(dec[i]) == int(jswitching.decide(
            th[i], tiers[i], 4, np.float32(c_lower[i]), c_upper,
            active=active[i]))


# ---------------------------------------------------------------------------
# run_device_sharded (tests/test_scale.py's cases)
# ---------------------------------------------------------------------------
def _assert_sharded_matches(shard, ref):
    for k in EXACT_KEYS:
        np.testing.assert_array_equal(np.asarray(shard[k]),
                                      np.asarray(ref[k]), err_msg=k)
    for k in ULP_KEYS:
        np.testing.assert_allclose(np.asarray(shard[k]), np.asarray(ref[k]),
                                   rtol=1e-6, err_msg=k)
    for tk in EXACT_TRACES:
        np.testing.assert_array_equal(shard["traces"][tk],
                                      np.asarray(ref["traces"][tk]),
                                      err_msg=f"traces[{tk}]")
    for tk in ULP_TRACES:
        np.testing.assert_allclose(shard["traces"][tk],
                                   np.asarray(ref["traces"][tk]),
                                   rtol=1e-5, atol=1e-5,
                                   err_msg=f"traces[{tk}]")
    assert int(shard["n_events"]) == int(ref["n_events"])


def _check_device(ranks, name):
    args, kw = R.device_inputs(R.package("repro"), **R.DEV_CASES[name])
    local = J.run(*args, frontier_seg=True, **kw)
    out, counted = ranks.case(name)
    assert counted == 1
    assert out["per_device_sr"].shape == (R.DEV_CASES[name]["n"],)
    _assert_sharded_matches(out, local)


@pytest.mark.parametrize("scheduler", ["multitasc++", "static"])
def test_device_sharded_matches_local_seg(ranks, scheduler):
    _check_device(ranks, f"dev_{scheduler}")


def test_device_sharded_with_tiers_and_churn(ranks):
    _check_device(ranks, "dev_tiers_churn")


def test_device_sharded_matches_jax_device_sharded(ranks):
    out, _ = ranks.case("dev_tiers_churn")
    _assert_sharded_matches(out, ranks.jax())


def test_device_sharded_meshless_fallback_is_local_run(ranks):
    """mesh=None runs the ordinary local path, segmented by default."""
    out = ranks.case("dev_meshless")
    args = R.meshless_inputs(R.package("repro_torch"))
    _assert_same(out, jaxsim.run(*args, frontier_seg=True, device="cpu"))
    assert_port_matches(
        J.run(*R.meshless_inputs(R.package("repro")), frontier_seg=True),
        out)


def test_device_sharded_flat_frontier_raises(ranks):
    assert "segmented frontier" in ranks.case("dev_flat_raises")


def test_device_sharded_runs_one_point(ranks):
    as_list, as_batch = ranks.case("dev_batch_raises")
    assert "single JaxSimSpec" in as_list
    assert "B=1" in as_batch


# ---------------------------------------------------------------------------
# run_sweep_sharded (tests/test_sharded.py's cases)
# ---------------------------------------------------------------------------
def _sweep_refs(seeds, schedulers=("multitasc++",)):
    ours = jaxsim.run_sweep(*R.sweep_inputs(R.package("repro_torch"), seeds,
                                            schedulers), device="cpu")
    ref = J.run_sweep(*R.sweep_inputs(R.package("repro"), seeds,
                                      schedulers))
    assert_port_matches(ref, ours)
    return ours


def _check_sweep(ranks, name, seeds, counted, schedulers=("multitasc++",)):
    local = _sweep_refs(seeds, schedulers)
    out, sharded = ranks.case(name)
    assert out["sr"].shape == (len(seeds),)
    _assert_same(out, local)
    assert sharded == counted


def test_multi_axis_mesh_sweep_is_run_sweep(ranks):
    local = _sweep_refs((0, 1, 2, 3, 4))
    np.testing.assert_array_equal(ranks.case("mesh_helpers")["m22_sweep"],
                                  local["sr"])


def test_mesh_none_is_run_sweep(ranks):
    _check_sweep(ranks, "sweep_mesh_none", (0, 1, 2), 0)


def test_one_device_mesh_is_bitwise_fallback(ranks):
    _check_sweep(ranks, "sweep_one_lane", (0, 1, 2), 0)


def test_multi_shard_bitwise_vs_unsharded(ranks):
    _check_sweep(ranks, "sweep_divisible", tuple(range(2 * R.WORLD)),
                 2 * R.WORLD)


def test_multi_shard_padding_indivisible_batch(ranks):
    """B = 3 over 4 lanes: the padded lane is dropped from every leaf,
    traces and n_events included."""
    _check_sweep(ranks, "sweep_padded", (0, 1, 2), 3)


def test_multi_shard_padding_mixed_schedulers(ranks):
    _check_sweep(ranks, "sweep_schedulers_padded", (0, 1, 2, 0, 1, 2), 6,
                 ("multitasc++", "multitasc", "static"))


def test_multi_shard_single_point_falls_back_local(ranks):
    _check_sweep(ranks, "sweep_single_point", (0,), 0)


def test_multi_shard_counts_sharded_points(ranks):
    _check_sweep(ranks, "sweep_counts", tuple(range(R.WORLD)), R.WORLD)


# ---------------------------------------------------------------------------
# the mesh helpers
# ---------------------------------------------------------------------------
def test_make_sweep_mesh_needs_a_process_group_and_a_card():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh_mod.make_sweep_mesh((4,), device_type="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh_mod.make_sweep_mesh((4,))


def test_n_lanes_helpers(ranks):
    got = ranks.case("mesh_helpers")
    assert got["lanes"] == (1, 1, R.WORLD, R.WORLD)
    assert got["axes"] == (("data",), ("batch0", "batch1"))
    assert got["device_axis"] == "data"
    assert got["chips"] == (R.WORLD, R.WORLD)


def test_lane_position_is_the_rank(ranks):
    assert ranks.case("mesh_helpers")["positions"] == tuple(range(R.WORLD))


def test_device_axis_of_rejects_multi_axis_mesh(ranks):
    assert "single batch-axis mesh" in ranks.case("mesh_helpers")[
        "multi_axis"]
