"""Multi-pod dry-run: every (architecture x input shape) on the production
meshes, counted on ``meta`` tensors, with no device.

Counterpart of the JAX package's ``launch/dryrun.py``. For every (arch x
``INPUT_SHAPES``) cell on the 16 x 16 mesh and the 2 x 16 x 16 one (its
"pod" and "data" axes one data group of 32, ``launch.mesh.
make_production_mesh``), the process plays rank 0 of a ``fake`` process
group of the mesh's size (256 or 512 ranks; its collectives return at
once), builds the rank's model on ``meta`` (``launch.inputs``: the
parameters in the dry-run's dtype, FSDP for training shapes) and runs one
step of the port's own step factories (``launch.distributed``
``make_train_step``, ``make_prefill_step``, ``make_serve_step``) on the
shape's stand-ins. Nothing is allocated and no kernel is launched.

Per cell and rank it records, under the JAX JSON's keys where one exists:

* ``n_params`` / ``n_active_params`` (the whole model's, the unrouted
  share of the MoE experts left out of the second);
* ``param_bytes_per_device``, ``opt_bytes_per_device``,
  ``cache_bytes_per_device``, ``batch_bytes_per_device`` and their sum
  ``memory_analysis.argument_bytes`` (the port's real storage a rank:
  ``models.layout`` ``model_dim`` / ``data_dim``); ``output_bytes``;
  ``peak_bytes``, an estimate (``peak_is_estimate``): the arguments plus
  the most bytes of ``meta`` storages alive at once during the step;
* the FLOPs a rank: ``torch.utils.flop_counter.FlopCounterMode``'s count
  of the aten products plus each hand-written kernel's booked work
  (``roofline.analysis.record``), listed by kernel, and the products' and
  kernels' bytes;
* the collectives, as the logical operations the ``MeshContext`` performs
  (``models.common.counting_collectives``: gathers, reduces,
  reduce-scatters), their group sizes, calls and bytes a rank on a ring;
* the ``roofline`` dict (``roofline.analysis.compute_roofline`` at the
  H100's data-sheet rates).

The FLOP counter and the kernels' booked work take the place of the JAX
driver's HLO parse (``roofline/hlo.py``): there is no ``hlo`` or
``while_trip_counts`` section. The JAX driver's A/B flags (head-sharded
attention, serving FSDP, remat policy, accumulation override) toggle
module globals the port does not have; the accumulation depth is the
port's ``default_accum_steps``.

One JSON per cell goes into ``--out`` (``results/dryrun_torch``, which
``.gitignore`` lists); a failing cell is written with ``"ok": false`` and
the run exits 1. A process group is global to its process, so a caller
that must not keep one runs this in a process of its own; ``--jobs N``
runs the cells in N worker processes, each cell in a fake group of its
own. The xLSTM's sLSTM runs its ops once a position on ``meta`` too
(32,768 times a layer at prefill_32k), and its cells take the longest.

    python -m repro_torch.launch.dryrun --all --both-meshes --jobs 6
    python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
    python -m repro_torch.roofline.report results/dryrun_torch
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import math
import multiprocessing
import os
import time
import traceback
import weakref
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import distributed, inputs
from repro_torch.launch.mesh import make_production_mesh, mesh_tag
from repro_torch.models.common import counting_collectives
from repro_torch.models.model import (_whole_shape, build_model, data_parts,
                                      init_params, model_parts)
from repro_torch.roofline import analysis as ra
from repro_torch.training import optimizer as opt
from repro_torch.training.trainer import trainable

OUT = "results/dryrun_torch"
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
# composite ops that run aten products, decomposed by the step counter
_COMPOSITE_PRODUCTS = {"matmul", "einsum", "linear", "bilinear",
                       "tensordot"}


@contextlib.contextmanager
def fake_world(size: int):
    """A ``fake`` process group of ``size`` ranks, this process rank 0,
    for the block: collectives return at once, nothing is sent."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


class _StepCounter(TorchDispatchMode):
    """One dispatch mode over the step: the FLOPs of the aten products by
    ``FlopCounterMode``'s own rules (its registry and ``_count_flops``;
    the composite products that reach the mode whole under
    ``inference_mode``, matmul and einsum, decomposed first, as it does),
    the products' operand and result bytes, and the bytes of every
    storage an op creates while it is alive (the peak of their sum: a
    step's temporaries). A product of operands of two dtypes raises, as
    the CPU's and the card's GEMMs do (``meta``'s lets it pass). Entering
    ``FlopCounterMode`` itself would try to decompose every op and track
    every module, which doubles the cost of the sLSTM's position loop."""

    def __init__(self, held=()):
        """``held``: the tensors alive before the step (its arguments),
        whose storages an op's view or in-place result does not add."""
        super().__init__()
        self.flops = FlopCounterMode(display=False)
        self.live = self.peak = 0
        self.product_bytes = 0
        self._seen = weakref.WeakKeyDictionary()
        for t in tree_leaves(held):
            if isinstance(t, torch.Tensor):
                self._seen[t.untyped_storage()] = 0

    def _free(self, n):
        self.live -= n

    def _track(self, t):
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.__name__.split(".")[0] in _COMPOSITE_PRODUCTS:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if isinstance(out, torch.Tensor):
            self._track(out)
            outs = (out,)
        else:
            outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
            for t in outs:
                self._track(t)
        if func._overloadpacket in self.flops.flop_registry:
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            if len({t.dtype for t in ins}) > 1:
                raise TypeError(f"{func.__name__} of mixed dtypes "
                                f"{sorted({str(t.dtype) for t in ins})}")
            self.flops._count_flops(func._overloadpacket, out, args, kwargs)
            self.product_bytes += sum(t.numel() * t.element_size()
                                      for t in (*ins, *outs))
        return out


def _nbytes(*trees) -> int:
    """Bytes of the distinct storages among the tensors of ``trees``."""
    seen, total = set(), 0
    for t in tree_leaves(trees):
        if isinstance(t, torch.Tensor):
            key = id(t.untyped_storage())
            if key not in seen:
                seen.add(key)
                total += t.untyped_storage().nbytes()
    return total


def param_counts(model):
    """(n_total, n_active) of the whole model from a rank's parts (the
    JAX driver's ``_param_counts``): every leaf's whole size; active
    leaves out the unrouted fraction of the MoE experts' weights."""
    parts, dparts = model_parts(model), data_parts(model)
    total = expert = 0
    for name, p in model.named_parameters():
        n = math.prod(_whole_shape(p, name, parts, dparts, model.mctx))
        total += n
        names = name.split(".")
        if "moe" in names and names[-1] in ("w_gate", "w_up", "w_down"):
            expert += n
    cfg = model.cfg
    if cfg.is_moe and cfg.num_experts:
        inactive = expert * (1.0 - cfg.num_experts_per_tok / cfg.num_experts)
    else:
        inactive = 0.0
    return total, total - inactive


def _filled(batch, cfg, gen):
    """The stand-ins of ``batch`` as CPU tensors of their shapes and
    dtypes: token ids (and labels) drawn below the vocabulary size, the
    embeddings normal."""
    return {k: torch.randint(0, cfg.vocab_size, v.shape, generator=gen,
                             dtype=v.dtype) if not v.is_floating_point()
            else torch.randn(v.shape, generator=gen, dtype=v.dtype)
            for k, v in batch.items()}


def _step(model, mesh, cfg, shape, *, cache_len, accum_steps, n_total,
          gen=None):
    """(the step as a thunk, its arguments beyond the parameters by name)
    of ``shape``'s kind on this rank's ``model``; the inputs are ``meta``
    stand-ins, or drawn from ``gen`` on the CPU."""
    def batch_of(batch):
        return batch if gen is None else _filled(batch, cfg, gen)
    dev = model.device
    if shape.kind == "train":
        state = opt.init(trainable(model))
        batch = batch_of(inputs.batch_specs(cfg, shape))
        if accum_steps is None:
            accum_steps = distributed.default_accum_steps(
                n_total, shape.global_batch, mesh.size() // mesh.shape[1])
        step = distributed.make_train_step(model, mesh,
                                           accum_steps=accum_steps)
        return (lambda: step(state, batch)), {"opt": state, "batch": batch}
    if shape.kind == "prefill":
        batch = batch_of(inputs.batch_specs(cfg, shape))
        step = distributed.make_prefill_step(model, mesh)
        extra = {k: batch[k] for k in ("vision_embeds", "audio_embeds")
                 if k in batch}
        return (lambda: step(batch["tokens"], cache_len, **extra)), \
            {"batch": batch}
    b = shape.global_batch
    rows = distributed._batch_context(model.mctx, b).data_rows(b)
    tokens1 = batch_of({"t": torch.empty(b, 1, dtype=torch.int32,
                                         device=inputs.META)})["t"]
    pos = torch.full((b,), shape.seq_len, dtype=torch.int32, device=dev)
    cache = model.init_cache(len(range(b)[rows]), cache_len or shape.seq_len)
    serve = distributed.make_serve_step(model, mesh)
    return (lambda: serve(tokens1, cache, pos)), \
        {"cache": cache, "batch": {"tokens1": tokens1, "pos": pos}}


def dry_run(cfg, shape: InputShape, mesh, *, dtype=torch.bfloat16,
            fsdp: Optional[bool] = None, cache_len: Optional[int] = None,
            accum_steps: Optional[int] = None, device="meta",
            seed: int = 0):
    """One step of ``shape`` (its kind, global batch and sequence) for
    ``cfg`` on this rank of ``mesh`` (a ("data", "model") mesh over the
    process group the caller initialised), on ``meta``: the cell's result
    dict (module docstring). ``fsdp`` defaults to training shapes;
    ``cache_len`` to the prefill's default and the decode's ``seq_len``;
    ``accum_steps`` to ``default_accum_steps``. ``device="cpu"`` runs the
    same step and the same counts on real tensors (weights and inputs
    drawn from ``seed``): the dry-run's counts against an executed run."""
    t0 = time.time()
    fsdp = shape.kind == "train" if fsdp is None else fsdp
    gen = None
    if torch.device(device).type == "meta":
        model = build_model(cfg, device=inputs.META, dtype=dtype, mesh=mesh,
                            fsdp=fsdp)
    else:
        gen = torch.Generator().manual_seed(seed)
        model = init_params(cfg, gen, device=device, dtype=dtype, mesh=mesh,
                            fsdp=fsdp)
    n_total, n_active = param_counts(model)
    run, args = _step(model, mesh, cfg, shape, cache_len=cache_len,
                      accum_steps=accum_steps, n_total=n_total, gen=gen)
    param_bytes = _nbytes(list(model.parameters()))
    arg_bytes = {k: _nbytes(v) for k, v in args.items()}
    argument_bytes = param_bytes + sum(arg_bytes.values())
    with ra.counting_work() as work, counting_collectives() as coll, \
            _StepCounter((list(model.parameters()), args)) as mem:
        out = run()
    aten_flops = mem.flops.get_total_flops()
    stats = ra.StepStats(
        dot_flops=aten_flops + work.flops,
        dot_bytes=mem.product_bytes + work.bytes,
        collective_bytes=coll.bytes,
        collectives={k: op["bytes"] for k, op in coll.as_dict().items()},
        kernel_flops=work.flops_by_rate)
    chips = mesh.size()
    roof = ra.compute_roofline(cfg, shape, stats, chips,
                               param_bytes_per_device=param_bytes,
                               n_active=n_active, dtype=dtype)
    return {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": mesh_tag(mesh),
        "chips": chips,
        "ok": True,
        "wall_s": round(time.time() - t0, 1),
        "dtype": str(dtype).removeprefix("torch."),
        "fsdp": fsdp,
        "memory_analysis": {
            "argument_bytes": argument_bytes,
            "output_bytes": _nbytes(out),
            "temp_bytes": mem.peak,
            "peak_bytes": argument_bytes + mem.peak,
            "peak_is_estimate": True,
        },
        "param_bytes_per_device": param_bytes,
        "opt_bytes_per_device": arg_bytes.get("opt", 0),
        "cache_bytes_per_device": arg_bytes.get("cache", 0),
        "batch_bytes_per_device": arg_bytes.get("batch", 0),
        "n_params": n_total,
        "n_active_params": n_active,
        "flops": {"aten_products": aten_flops, "kernels": work.flops,
                  "per_device": stats.dot_flops,
                  "product_bytes": mem.product_bytes,
                  "kernel_bytes": work.bytes},
        "kernels": work.kernels,
        "collective_bytes_per_device": coll.bytes,
        "collective_calls": coll.calls,
        "collectives": coll.as_dict(),
        "roofline": roof.as_dict(),
    }


def lower_one(arch: str, shape_name: str, mesh, *, dtype=torch.bfloat16,
              verbose=True):
    """The production cell (``arch``, ``shape_name``) on ``mesh``: the
    shape's config (``inputs.arch_for_shape``) through ``dry_run``."""
    shape = INPUT_SHAPES[shape_name]
    cfg = inputs.arch_for_shape(get_config(arch), shape)
    res = dry_run(cfg, shape, mesh, dtype=dtype)
    res["arch"] = arch
    if verbose:
        m, rf = res["memory_analysis"], res["roofline"]
        print(f"[{arch} x {shape_name} @ {res['mesh']}] ok "
              f"({res['wall_s']:.1f}s) args={m['argument_bytes'] / 2**30:.2f}"
              f"GiB peak~{m['peak_bytes'] / 2**30:.2f}GiB "
              f"compute={rf['compute_s'] * 1e3:.2f}ms "
              f"mem={rf['memory_s'] * 1e3:.2f}ms "
              f"coll={rf['collective_s'] * 1e3:.2f}ms "
              f"dominant={rf['dominant']} useful={rf['useful_ratio']:.2f} "
              f"collectives={res['collective_calls']}", flush=True)
    return res


def _cell(arch: str, shape_name: str, multi_pod: bool, dtype: str) -> dict:
    """One production cell in a fake group of its own (a worker process's
    unit): its result, or {"ok": false, "error"} where it failed."""
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        try:
            return lower_one(arch, shape_name, mesh, dtype=DTYPES[dtype])
        except Exception as e:  # a failure is a bug in the port
            traceback.print_exc()
            return {"arch": arch, "shape": shape_name,
                    "mesh": mesh_tag(mesh), "ok": False, "error": str(e)}


def _cost(cell) -> tuple:
    """Longest first: the xLSTM's cells (the sLSTM runs its ops once a
    position), then the train shapes."""
    arch, shape_name, _ = cell
    return (arch != "xlstm-350m", INPUT_SHAPES[shape_name].kind != "train")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS) + [None])
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--all", action="store_true",
                    help="every arch and shape (the default when neither "
                         "--arch nor --shape is given)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--dtype", default="bf16", choices=sorted(DTYPES))
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes, each cell in a fake group of "
                         "its own (1: every cell in this process)")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    pods = [False, True] if args.both_meshes else [args.multi_pod]
    archs = [args.arch] if args.arch else sorted(ARCHS)
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    cells = sorted(((a, s, p) for p in pods for a in archs for s in shapes),
                   key=_cost)
    os.makedirs(args.out, exist_ok=True)
    failures = []

    def write(res, multi_pod):
        name = f"{res['arch']}_{res['shape']}_" \
            f"{'2x16x16' if multi_pod else '16x16'}"
        if not res["ok"]:
            failures.append(name)
        with open(os.path.join(args.out, name + ".json"), "w") as f:
            json.dump(res, f, indent=1)

    if args.jobs <= 1:
        for cell in cells:
            write(_cell(*cell, args.dtype), cell[2])
    else:
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(args.jobs,
                                                    mp_context=ctx) as pool:
            running = {pool.submit(_cell, *cell, args.dtype): cell
                       for cell in cells}
            for done in concurrent.futures.as_completed(running):
                write(done.result(), running[done][2])
    if failures:
        print("FAILURES:", sorted(failures))
        return 1
    print(f"all {len(cells)} dry-runs ran OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
