"""Rank side of tests/test_torch_sharded.py: the sharded sweeps of the
port run on four ``gloo`` ranks on the CPU.

``rank_main`` joins a process group through a ``file://`` rendezvous, runs
every case of ``_cases`` in order on this rank and pickles what each case
returned (or the exception it raised) to ``<out>/rank<r>.pkl``. A case
that fails unexpectedly ends the rank's run: the other ranks then fail in
their next collective at the group's timeout, and the test's join timeout
bounds the whole.

The input builders take the package to build for (``"repro"`` for the JAX
package, ``"repro_torch"`` for the port), so the test can run the JAX
reference on the same inputs; the ranks import only the port.
"""
import datetime
import importlib
import pickle
import traceback
import types

import numpy as np

WORLD = 4
GROUP_TIMEOUT_S = 300

# tests/test_sharded.py's sweep point
SWEEP_N, SWEEP_S = 8, 120
# tests/test_scale.py's device-sharded cases
DEV_CASES = {
    "dev_multitasc++": dict(n=300, s=12, scheduler="multitasc++", seed=2),
    "dev_static": dict(n=300, s=12, scheduler="static", seed=2),
    "dev_tiers_churn": dict(n=256, s=14, scheduler="multitasc++", seed=9,
                            churn=True),
}
MESHLESS = dict(n=96, s=10, seed=3)


def package(name):
    def mod(path):
        return importlib.import_module(f"{name}.{path}")
    return types.SimpleNamespace(jaxsim=mod("sim.jaxsim"),
                                 synthetic=mod("sim.synthetic"),
                                 tiers=mod("configs.cascade_tiers"))


def sweep_inputs(pkg, seeds, schedulers=("multitasc++",)):
    """``run_sweep``'s arguments for tests/test_sharded.py's ``_case``:
    point i runs scheduler ``schedulers[i % len]`` on ``seeds[i]``."""
    dp = pkg.tiers.DEVICE_PROFILES["low"]
    sp = pkg.tiers.SERVER_PROFILES["inceptionv3"]
    streams = pkg.synthetic.batched_device_streams(
        seeds, SWEEP_N, SWEEP_S, dp.accuracy, sp.accuracy)
    specs = [pkg.jaxsim.JaxSimSpec(scheduler=schedulers[i % len(schedulers)],
                                   n_devices=SWEEP_N,
                                   samples_per_device=SWEEP_S,
                                   static_threshold=0.6)
             for i in range(len(seeds))]
    return (specs, streams, np.full(SWEEP_N, dp.latency),
            np.full(SWEEP_N, 0.15), (sp,))


def servers(pkg):
    return (pkg.tiers.SERVER_PROFILES["inceptionv3"],
            pkg.tiers.SERVER_PROFILES["efficientnetb3"])


def device_inputs(pkg, n, s, scheduler, seed, churn=False):
    """tests/test_scale.py's ``_sharded_vs_local`` point: returns
    ``(spec, streams, lat, slo, servers), kw``."""
    srv = servers(pkg)
    rng = np.random.default_rng(seed)
    lat = rng.uniform(0.04, 0.2, n).astype(np.float32)
    slo = (lat * 2.0).astype(np.float32)
    streams = pkg.synthetic.device_streams(n, s, 0.72,
                                           [p.accuracy for p in srv], seed)
    spec = pkg.jaxsim.JaxSimSpec(scheduler=scheduler, n_devices=n,
                                 samples_per_device=s, model_switching=True)
    kw = {}
    if churn:   # test_device_sharded_with_tiers_and_churn's draws
        rng = np.random.default_rng(seed)
        total_t = 0.2 * s
        kw = dict(
            tier_ids=rng.integers(0, 3, n).astype(np.int32),
            c_upper=np.asarray([0.85, 0.8, 0.75], np.float32),
            join_t=np.where(rng.random(n) < 0.3,
                            rng.uniform(0.1, 0.4, n) * total_t,
                            0.0).astype(np.float32),
            leave_t=np.where(rng.random(n) < 0.3,
                             rng.uniform(0.5, 0.9, n) * total_t,
                             np.inf).astype(np.float32))
    return (spec, streams, lat, slo, srv), kw


def meshless_inputs(pkg):
    """test_device_sharded_meshless_fallback_is_local_run's point."""
    n, s, seed = MESHLESS["n"], MESHLESS["s"], MESHLESS["seed"]
    rng = np.random.default_rng(seed)
    lat = rng.uniform(0.05, 0.2, n).astype(np.float32)
    slo = (lat * 2.0).astype(np.float32)
    srv = servers(pkg)
    streams = pkg.synthetic.device_streams(n, s, 0.72,
                                           [p.accuracy for p in srv], seed)
    spec = pkg.jaxsim.JaxSimSpec(scheduler="multitasc++", n_devices=n,
                                 samples_per_device=s)
    return spec, streams, lat, slo, srv


# ---------------------------------------------------------------------------
# the cases, as each rank runs them
# ---------------------------------------------------------------------------
def _raises(fn, exc=ValueError):
    try:
        fn()
    except exc as e:
        return f"{type(e).__name__}: {e}"
    return None


def _cases(mesh_mod, pkg):
    js = pkg.jaxsim
    cpu = dict(device="cpu")
    mesh = mesh_mod.make_sweep_mesh(device_type="cpu")

    def sweep(seeds, m, schedulers=("multitasc++",)):
        before = js.stats_snapshot()["sharded_points"]
        out = js.run_sweep_sharded(*sweep_inputs(pkg, seeds, schedulers),
                                   mesh=m, **cpu)
        return out, js.stats_snapshot()["sharded_points"] - before

    def device(name):
        args, kw = device_inputs(pkg, **DEV_CASES[name])
        before = js.stats_snapshot()["device_sharded_points"]
        out = js.run_device_sharded(*args, mesh=mesh, **kw, **cpu)
        return out, js.stats_snapshot()["device_sharded_points"] - before

    def meshless():
        return js.run_device_sharded(*meshless_inputs(pkg), mesh=None, **cpu)

    def flat_raises():
        args, kw = device_inputs(pkg, **DEV_CASES["dev_static"])
        return _raises(lambda: js.run_device_sharded(
            *args, mesh=mesh, frontier_seg=False, **kw, **cpu))

    def batch_raises():
        args, kw = device_inputs(pkg, **DEV_CASES["dev_static"])
        spec, streams, *rest = args
        two = {k: np.stack([v, v]) for k, v in streams.items()}
        return (_raises(lambda: js.run_device_sharded([spec], streams, *rest,
                                                      mesh=mesh, **cpu)),
                _raises(lambda: js.run_device_sharded(spec, two, *rest,
                                                      mesh=mesh, **cpu)))

    def positions(mine):
        import torch.distributed as dist
        got = [None] * WORLD
        dist.all_gather_object(got, mine)
        return tuple(got)

    def mesh_helpers():
        m1 = mesh_mod.make_sweep_mesh((1,), device_type="cpu")
        m22 = mesh_mod.make_sweep_mesh((2, 2), device_type="cpu")
        return {
            "lanes": (mesh_mod.n_lanes(None), mesh_mod.n_lanes(m1),
                      mesh_mod.n_lanes(mesh), mesh_mod.n_lanes(m22)),
            "axes": (mesh_mod.mesh_axes(mesh), mesh_mod.batch_axes_of(m22)),
            "device_axis": mesh_mod.device_axis_of(mesh),
            "chips": (mesh_mod.n_chips(mesh), mesh_mod.n_chips(m22)),
            "multi_axis": _raises(lambda: mesh_mod.device_axis_of(m22)),
            "positions": positions(mesh_mod.lane_position(mesh)),
            "m22_sweep": js.run_sweep_sharded(
                *sweep_inputs(pkg, (0, 1, 2, 3, 4)), mesh=m22, **cpu)["sr"],
        }

    return {
        "mesh_helpers": mesh_helpers,
        "sweep_mesh_none": lambda: sweep((0, 1, 2), None),
        "sweep_one_lane": lambda: sweep(
            (0, 1, 2), mesh_mod.make_sweep_mesh((1,), device_type="cpu")),
        "sweep_divisible": lambda: sweep(tuple(range(2 * WORLD)), mesh),
        "sweep_padded": lambda: sweep((0, 1, 2), mesh),
        "sweep_schedulers_padded": lambda: sweep(
            (0, 1, 2, 0, 1, 2), mesh, ("multitasc++", "multitasc", "static")),
        "sweep_single_point": lambda: sweep((0,), mesh),
        "sweep_counts": lambda: sweep(tuple(range(WORLD)), mesh),
        "dev_flat_raises": flat_raises,
        "dev_batch_raises": batch_raises,
        "dev_meshless": meshless,
        **{name: (lambda name=name: device(name)) for name in DEV_CASES},
    }


def rank_main(rank, init_file, out_dir):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", world_size=WORLD,
        rank=rank, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    from repro_torch.launch import mesh as mesh_mod
    results = {}
    try:
        for name, fn in _cases(mesh_mod, package("repro_torch")).items():
            try:
                results[name] = {"ok": fn()}
            except Exception:
                results[name] = {"error": traceback.format_exc()}
                break
    finally:
        with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
            pickle.dump(results, f)
    dist.destroy_process_group()


def jax_device_sharded(out_file):
    """The JAX package's own run_device_sharded on the tiers + churn case,
    over a 4-device mesh of the CPU (run with XLA_FLAGS=--xla_force_host_
    platform_device_count=4 in a process of its own)."""
    import jax
    from repro.launch.mesh import make_sweep_mesh

    pkg = package("repro")
    args, kw = device_inputs(pkg, **DEV_CASES["dev_tiers_churn"])
    out = pkg.jaxsim.run_device_sharded(*args, mesh=make_sweep_mesh((4,)),
                                        **kw)
    out = jax.tree.map(np.asarray, out)
    with open(out_file, "wb") as f:
        pickle.dump(out, f)
