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
# the spawn, as the tests start and read it
# ---------------------------------------------------------------------------
# a hang ends sooner, at the ranks' group timeout; this bounds ranks that
# a loaded machine runs slowly (~30 s alone, ~150 s beside a full suite)
JOIN_TIMEOUT_S = 900


class Spawned:
    """WORLD ranks of ``target(rank, rendezvous, tmp, *args)``, each
    pickling {case: {"ok": value} or {"error": traceback}} to
    ``tmp/<prefix><rank>.pkl``, and beside them a subprocess running
    ``jax_code`` (which writes its pickle to its last argument) with the
    JAX package on a 4-device CPU mesh. Each is read once it has ended,
    within JOIN_TIMEOUT_S; a rank still running then is stopped."""

    def __init__(self, tmp, target, args, prefix, jax_code, jax_args):
        import os
        import pathlib
        import subprocess
        import sys

        import torch.multiprocessing as mp
        root = pathlib.Path(__file__).resolve().parents[1]
        self.tmp, self.prefix = tmp, prefix
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=target,
                                  args=(r, str(tmp / "rendezvous"), str(tmp),
                                        *args))
                      for r in range(WORLD)]
        for p in self.procs:
            p.start()
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PYTHONPATH=os.pathsep.join([str(root / "src"),
                                               str(root / "tests")]))
        self.jax_out = tmp / f"{prefix}jax.pkl"
        self.jax_proc = subprocess.Popen(
            [sys.executable, "-c", jax_code, *map(str, jax_args),
             str(self.jax_out)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self._results = self._jax = None

    def results(self):
        if self._results is None:
            for p in self.procs:
                p.join(JOIN_TIMEOUT_S)
            self.hung = [p.pid for p in self.procs if p.is_alive()]
            self.close_ranks()
            self._results = []
            for r in range(WORLD):
                path = self.tmp / f"{self.prefix}{r}.pkl"
                self._results.append(pickle.loads(path.read_bytes())
                                     if path.exists() else {})
        return self._results

    def per_rank(self, name):
        """Each rank's value of the case, after checking that every rank
        ran it without an error."""
        got = [res.get(name) for res in self.results()]
        errors = [v["error"] for res in self._results for v in res.values()
                  if "error" in v]
        for r, value in enumerate(got):
            assert value is not None, (f"rank {r} did not run {name!r} "
                                       f"(ranks killed at the join timeout: "
                                       f"{self.hung}); errors: {errors}")
            assert "error" not in value, f"rank {r}:\n{value['error']}"
        return [value["ok"] for value in got]

    def jax(self):
        if self._jax is None:
            out, _ = self.jax_proc.communicate(timeout=JOIN_TIMEOUT_S)
            assert self.jax_proc.returncode == 0, out
            self._jax = pickle.loads(self.jax_out.read_bytes())
        return self._jax

    def close_ranks(self):
        for p in self.procs:
            if p.is_alive():
                p.terminate()
            p.join(10)

    def close(self):
        self.close_ranks()
        if self.jax_proc.poll() is None:
            self.jax_proc.kill()
            self.jax_proc.communicate(timeout=10)


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
        with open(f"{out_dir}/sweep{rank}.pkl", "wb") as f:
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


# ---------------------------------------------------------------------------
# the step factories over a (data, model) mesh (tests/test_torch_mesh.py)
# ---------------------------------------------------------------------------
# the reduced configs and meshes the mesh tests run, and their sizes: B
# prompts of S tokens (seamless over its reduced 64 audio frames) into
# rings of MESH_CACHE slots (S + SERVE: cut on its slots at (2, 2), whole
# at (1, 4); RecurrentGemma's local window of 128, cut at both, the
# prompts filling one shard; xLSTM has no ring), SERVE decode steps of
# seeded tokens, one train step of B x S tokens. Training on a mesh with
# more than one data rank stores the parameters FSDP (``fsdp=True``), as
# the JAX reference places them; the serve steps keep them resident
MESH_ARCHS = ("granite-moe-1b-a400m", "deepseek-moe-16b",
              "seamless-m4t-medium", "recurrentgemma-9b", "xlstm-350m")
MESH_SHAPES = ((2, 2), (1, 4))
MESH_B, MESH_S, MESH_SERVE = 4, 8, 2
MESH_CACHE = {arch: MESH_S + MESH_SERVE for arch in MESH_ARCHS}
MESH_CACHE["recurrentgemma-9b"] = 128
MESH_ADAMW = dict(lr=1e-2, warmup_steps=2, total_steps=20)
# the tie across shards: a (2, 4) hidden over a (512, 4) head (four
# shards of 128 rows) whose largest logit is at rows 5 and 300
TIE_ROWS = (5, 300)


def mesh_inputs(cfg, seed):
    """(prefill batch, serve tokens (SERVE, B, 1), train batch), numpy."""
    rng = np.random.default_rng(seed)
    b, s = MESH_B, MESH_S
    prefill = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    train = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    labels = np.concatenate([train["tokens"][:, 1:],
                             np.full((b, 1), -100, np.int32)], axis=1)
    labels[0, :3] = -100
    train["labels"] = labels
    if cfg.is_encoder_decoder:
        for batch in (prefill, train):
            batch["audio_embeds"] = rng.standard_normal(
                (b, cfg.audio_frames, cfg.d_model)).astype(np.float32)
    serve = rng.integers(0, cfg.vocab_size, (MESH_SERVE, b, 1)).astype(
        np.int32)
    return prefill, serve, train


def tie_inputs():
    """(hidden (2, 1, 4), table (512, 4), vocab 500): row 0's two largest
    logits tie at TIE_ROWS, in shards 0 and 2 of four."""
    rng = np.random.default_rng(3)
    table = (rng.standard_normal((512, 4)) * 0.5).astype(np.float32)
    table[list(TIE_ROWS), 0] = 8.0
    table[list(TIE_ROWS), 1:] = 0.0
    hidden = np.zeros((2, 1, 4), np.float32)
    hidden[0, 0, 0] = 1.0
    hidden[1, 0] = rng.standard_normal(4)
    return hidden, table, 500


def _t(x):
    import torch
    return None if x is None else torch.from_numpy(np.asarray(x))


def _serve_run(prefill_fn, serve_fn, prefill, serve, cache_len):
    """conf / top-1 of the prefill and of each serve step, numpy; and the
    prefill's rings: (whole ring's slots, this rank's slots, its valid
    slots after the last step) a ring."""
    import torch
    out = []
    conf, top1, cache = prefill_fn(_t(prefill["tokens"]), cache_len,
                                   audio_embeds=_t(prefill.get(
                                       "audio_embeds")))
    out.append((conf.numpy(), top1.numpy()))
    for i, tok in enumerate(serve):
        pos = torch.full((MESH_B,), MESH_S + i, dtype=torch.long)
        conf, top1, cache = serve_fn(_t(tok), cache, pos)
        out.append((conf.numpy(), top1.numpy()))
    return out, _rings(cache)


def _rings(cache):
    """(W, this rank's slots, its slots written so far) of each ring of a
    cache after the serve steps (a cut ring's shard past the written
    slots holds zeros)."""
    from repro_torch.models.attention import ring_slots
    out = []
    for entry in cache:
        ring = entry.get("self", entry)
        if "k" in ring:
            written = int((ring["k"][0].abs().sum((1, 2)) != 0).sum())
            out.append((ring_slots(ring), ring["k"].shape[1], written))
    return out


def _gaps(model, cfg, prefill, serve, mctx, table, cache_len):
    """This data rank's rows of the batch and the top-2 logit gap at each
    served position of those rows (where a float-order difference may
    swap top-1), from the model's hidden states over the whole head
    ``table``."""
    import torch
    table = torch.from_numpy(np.asarray(table)).double()
    rows = mctx.data_rows(MESH_B)

    def gap(hidden):
        top2 = torch.topk(hidden[:, -1].double() @ table.T, 2).values
        return (top2[:, 0] - top2[:, 1]).numpy()
    inputs = {"audio_embeds": _t(prefill["audio_embeds"][rows])} \
        if cfg.is_encoder_decoder else {}
    with torch.inference_mode():
        hidden, cache = model(_t(prefill["tokens"][rows]), collect_cache=True,
                              cache_len=cache_len, return_hidden=True,
                              mctx=mctx, **inputs)
        gaps = [gap(hidden)]
        for i, tok in enumerate(serve):
            pos = torch.full((rows.stop - rows.start,), MESH_S + i,
                             dtype=torch.long)
            hidden, cache = model.decode_step(_t(tok[rows]), cache, pos,
                                              return_hidden=True, mctx=mctx)
            gaps.append(gap(hidden))
    return rows.start, rows.stop, gaps


def _train_run(model, mesh, mctx, train, accum=1):
    """The gradients of the train step's loss (summed over the data group;
    an FSDP leaf's by its gather) and one step of ``make_train_step``
    (over ``accum`` microbatches): numpy grads, updated parameters, the
    step's first moments (the gradient it applied, clipped, times 1 -
    beta1), metrics, of what the rank stores."""
    from repro_torch.launch import distributed as pdist
    from repro_torch.models.model import data_parts
    from repro_torch.training import optimizer as opt
    from repro_torch.training import trainer

    params = trainer.trainable(model)
    batch = trainer.to_device(train, model.device)
    loss_fn = pdist.make_loss_fn(model, remat=True, mctx=mctx)
    loss, metrics, grads = trainer.grads_of(
        loss_fn, params, trainer.data_rows(batch, mctx))
    trainer.all_reduce_grads(grads, mctx, set(data_parts(model)))
    step = pdist.make_train_step(model, mesh, remat=True, accum_steps=accum,
                                 adamw=opt.AdamWConfig(**MESH_ADAMW))
    state, met = step(opt.init(params), train)
    return {"grads": {k: g.numpy() for k, g in grads.items()},
            "params": {k: p.detach().numpy() for k, p in params.items()},
            "mu": {k: m.numpy() for k, m in state["mu"].items()},
            "metrics": {k: float(v) for k, v in met.items()},
            "grad_loss": float(loss)}


def head_table(tree, cfg):
    """The whole head's table of a JAX parameter tree."""
    return tree["embed" if cfg.tie_embeddings else "lm_head"]["table"]


def _layout(model):
    """(model parts, data parts, parameter bytes) of the rank's model:
    name -> (dim, index into the whole leaf, stored shape)."""
    from repro_torch.models.model import data_parts, model_parts

    def rec(parts):
        return {k: (dim, rows, tuple(model.get_parameter(k).shape))
                for k, (dim, rows) in parts.items()}
    return (rec(model_parts(model)), rec(data_parts(model)),
            sum(p.numel() * p.element_size() for p in model.parameters()))


def _mesh_cases(trees):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import distributed as pdist
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.common import mesh_context
    from repro_torch.models.model import params_from_jax

    meshes = {shape: mesh_mod.make_model_mesh(shape, device_type="cpu")
              for shape in MESH_SHAPES}

    def run(arch, shape):
        cfg = get_config(arch).reduced()
        mesh = meshes[shape]
        mctx = mesh_context(mesh)
        cache_len = MESH_CACHE[arch]
        prefill, serve, train = mesh_inputs(cfg, MESH_ARCHS.index(arch))
        model = params_from_jax(trees[arch], cfg, device="cpu", mesh=mesh)
        steps, rings = _serve_run(pdist.make_prefill_step(model, mesh),
                                  pdist.make_serve_step(model, mesh),
                                  prefill, serve, cache_len)
        parts, _, nbytes = _layout(model)
        out = {"steps": steps, "rings": rings, "parts": parts,
               "bytes": nbytes,
               "positions": (mctx.data_rank, mctx.model_rank),
               "gaps": _gaps(model, cfg, prefill, serve, mctx,
                             head_table(trees[arch], cfg), cache_len)}
        if cfg.pattern[0] == "mlstm":
            out["w_up"] = model.layers[0].mlstm.w_up.numpy().copy()
        fsdp = shape[0] > 1
        if fsdp:
            # the same steps on the resident weights, for the FSDP run's
            # comparison, then training on the FSDP model
            out["resident"] = _train_run(model, mesh, mctx, train)
            model = params_from_jax(trees[arch], cfg, device="cpu",
                                    mesh=mesh, fsdp=True)
            out["fsdp_steps"] = _serve_run(
                pdist.make_prefill_step(model, mesh),
                pdist.make_serve_step(model, mesh), prefill, serve,
                cache_len)[0]
            model = params_from_jax(trees[arch], cfg, device="cpu",
                                    mesh=mesh, fsdp=True)
        out["train_parts"], out["train_data_parts"], out["train_bytes"] = \
            _layout(model)
        out.update(_train_run(model, mesh, mctx, train))
        if shape[0] == 1:       # the port's one-rank run on the same inputs
            local = params_from_jax(trees[arch], cfg, device="cpu")
            out["local_steps"] = _serve_run(pdist.make_prefill_step(local),
                                            pdist.make_serve_step(local),
                                            prefill, serve, cache_len)[0]
            local = params_from_jax(trees[arch], cfg, device="cpu")
            out["local"] = _train_run(local, None, mesh_context(
                None), train)
        return out

    def tie():
        hidden, table, vocab = tie_inputs()
        mctx = mesh_context(meshes[(1, 4)])
        rows = table.shape[0] // mctx.model_size
        table = table[mctx.model_rank * rows:(mctx.model_rank + 1) * rows]
        with torch.inference_mode():
            conf, top1 = pdist.vocab_parallel_bvsb(_t(hidden), _t(table),
                                                   mctx, vocab)
        return conf.numpy(), top1.numpy()

    def helpers():
        m22 = meshes[(2, 2)]
        c22, c14 = mesh_context(m22), mesh_context(meshes[(1, 4)])
        return {"axes": mesh_mod.mesh_axes(m22),
                "batch_axes": mesh_mod.batch_axes_of(m22),
                "positions": (c22.data_rank, c22.model_rank),
                "sizes": (c22.data_size, c22.model_size,
                          c14.data_size, c14.model_size),
                "groups": (c14.data_group is None, c14.model_group is None),
                "bad_shape": _raises(lambda: mesh_mod.make_model_mesh(
                    (2, 3), device_type="cpu"))}

    def accum():
        """granite on (2, 2), stored FSDP, two microbatches: each rank's
        share of each global microbatch."""
        arch = MESH_ARCHS[0]
        cfg = get_config(arch).reduced()
        mesh = meshes[(2, 2)]
        model = params_from_jax(trees[arch], cfg, device="cpu", mesh=mesh,
                                fsdp=True)
        train = mesh_inputs(cfg, 0)[2]
        return _train_run(model, mesh, mesh_context(mesh), train,
                          accum=2)["metrics"]

    cases = {f"{arch} {shape}": (lambda a=arch, s=shape: run(a, s))
             for arch in MESH_ARCHS for shape in MESH_SHAPES}
    return {"helpers": helpers, "tie": tie, "accum": accum, **cases}


def mesh_rank_main(rank, init_file, out_dir, trees_file):
    """One rank of tests/test_torch_mesh.py: join the gloo group, run every
    mesh case on the JAX package's weights from ``trees_file`` (numpy,
    pickled by the test), pickle each case's result or traceback."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", world_size=WORLD,
        rank=rank, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    with open(trees_file, "rb") as f:
        trees = pickle.load(f)
    results = {}
    try:
        for name, fn in _mesh_cases(trees).items():
            try:
                results[name] = {"ok": fn()}
            except Exception:
                results[name] = {"error": traceback.format_exc()}
                break
    finally:
        with open(f"{out_dir}/mesh{rank}.pkl", "wb") as f:
            pickle.dump(results, f)
    dist.destroy_process_group()


def jax_mesh_reference(trees_file, out_file):
    """The JAX package's steps on 4-device CPU meshes (run with
    XLA_FLAGS=--xla_force_host_platform_device_count=4 in a process of its
    own, Auto axes), under the layout the port copies: the parameters
    placed by ``param_shardings`` (TP only, ``fsdp=False``, for the
    prefill and serve steps; ``fsdp=True`` for training), the cache by
    ``cache_shardings``. For each arch and mesh, conf / top-1 of the
    prefill (``make_prefill_step``'s body with the rings' ``cache_len``,
    which the factory does not take) and of the serve steps, the
    gradients of the train step's loss and one train step; and its
    vocab-parallel BvSB on the tie."""
    import jax
    from jax.sharding import AxisType

    from repro.configs import get_config
    from repro.launch import distributed as jdist
    from repro.launch import shardings as jshard
    from repro.launch.mesh import batch_axes_of
    from repro.models.common import MeshContext
    from repro.models.model import build_model
    from repro.training import optimizer as jopt

    with open(trees_file, "rb") as f:
        trees = pickle.load(f)
    out = {}
    for shape in MESH_SHAPES:
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        ba = batch_axes_of(mesh)
        mctx = MeshContext(batch_axes=ba, model_axis="model", mesh=mesh)
        for arch in MESH_ARCHS:
            cfg = get_config(arch).reduced()
            jm = build_model(cfg)
            prefill, serve, train = mesh_inputs(cfg, MESH_ARCHS.index(arch))
            tp = jax.device_put(trees[arch], jshard.param_shardings(
                mesh, trees[arch], fsdp=False))
            fsdp = jax.device_put(trees[arch], jshard.param_shardings(
                mesh, trees[arch], fsdp=True))

            def loss_fn(params, batch, jm=jm, cfg=cfg):
                hidden, _, aux = jm.forward(params, batch, mctx, remat=True,
                                            return_hidden=True)
                ce = jdist.vocab_parallel_ce(
                    hidden, head_table(params, cfg), batch["labels"],
                    mesh, ba, cfg.vocab_size)
                return ce + aux

            def prefill_fn(params, batch, jm=jm, cfg=cfg,
                           cache_len=MESH_CACHE[arch]):
                hidden, cache, _ = jm.forward(
                    params, batch, mctx, collect_cache=True,
                    cache_len=cache_len, return_hidden=True)
                conf, top1 = jdist.vocab_parallel_bvsb(
                    hidden[:, -1:, :], head_table(params, cfg), mesh, ba,
                    cfg.vocab_size)
                return conf, top1, cache
            jserve = jax.jit(jdist.make_serve_step(jm, mesh, MESH_B))
            jstep = jax.jit(jdist.make_train_step(
                jm, mesh, remat=True, adamw=jopt.AdamWConfig(**MESH_ADAMW)))
            with mesh:
                steps = []
                conf, top1, cache = jax.jit(prefill_fn)(tp, prefill)
                cache = jax.device_put(cache, jshard.cache_shardings(
                    mesh, cache, MESH_B))
                steps.append((np.asarray(conf), np.asarray(top1)))
                for i, tok in enumerate(serve):
                    pos = np.full((MESH_B,), MESH_S + i, np.int32)
                    conf, top1, cache = jserve(tp, tok, cache, pos)
                    steps.append((np.asarray(conf), np.asarray(top1)))
                grads = jax.jit(jax.grad(loss_fn))(fsdp, train)
                params, state, met = jstep(fsdp, jopt.init(fsdp), train)
            out[f"{arch} {shape}"] = {
                "steps": steps,
                "grads": jax.tree.map(np.asarray, grads),
                "params": jax.tree.map(np.asarray, params),
                "mu": jax.tree.map(np.asarray, state["mu"]),
                "metrics": {k: float(v) for k, v in met.items()}}
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    cfg = get_config(MESH_ARCHS[0]).reduced()
    jstep = jax.jit(jdist.make_train_step(
        build_model(cfg), mesh, remat=True, accum_steps=2,
        adamw=jopt.AdamWConfig(**MESH_ADAMW)))
    fsdp = jax.device_put(trees[MESH_ARCHS[0]], jshard.param_shardings(
        mesh, trees[MESH_ARCHS[0]], fsdp=True))
    with mesh:
        _, _, met = jstep(fsdp, jopt.init(fsdp), mesh_inputs(cfg, 0)[2])
    out["accum"] = {k: float(v) for k, v in met.items()}
    mesh = jax.make_mesh((1, 4), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    hidden, table, vocab = tie_inputs()
    with mesh:
        conf, top1 = jax.jit(lambda h, t: jdist.vocab_parallel_bvsb(
            h, t, mesh, batch_axes_of(mesh), vocab))(hidden, table)
    out["tie"] = (np.asarray(conf), np.asarray(top1))
    with open(out_file, "wb") as f:
        pickle.dump(out, f)
