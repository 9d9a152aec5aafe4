"""Rank side of tests/test_torch_dryrun.py: the dry-run's counts on a fake
process group against the same steps run on four ``gloo`` ranks.

``rank_main`` joins a gloo group of WORLD ranks on the CPU and runs every
cell of ``cells`` through ``launch.dryrun.dry_run(..., device="cpu")``:
real weights and inputs, the same counters. There the kernel wrappers run
their plain versions, whose aten products the FLOP counter would book
where the card's kernels book their work; ``kernels_booked`` makes a CPU
call book exactly what the kernel's ``meta`` branch books (the wrapper
called on ``meta`` copies of its inputs, and a flash or scan backward the
backward kernel's work) and runs the plain version outside every
dispatch mode, its backward too. ``fake_main`` runs the same cells on
``meta`` as the dry-run does, rank 0 of a ``fake`` group of WORLD, the
decode partials planned for one SM (one split, as the plain partials
take). Each pickles {cell: counts}.
"""
import contextlib
import datetime
import pickle
import traceback

WORLD = 4
MESH = (2, 2)
GROUP_TIMEOUT_S = 300
# (arch, kind, global batch, sequence, cache length) at ``reduced()``
CELLS = (("granite-moe-1b-a400m", "train", 4, 16, None),
         ("granite-moe-1b-a400m", "prefill", 4, 16, None),
         ("granite-moe-1b-a400m", "decode", 4, 16, 32),
         ("recurrentgemma-9b", "train", 4, 16, None),
         ("recurrentgemma-9b", "prefill", 4, 16, None),
         ("recurrentgemma-9b", "decode", 4, 16, 32))


def cells():
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    return [(f"{arch} {kind}", get_config(arch).reduced(),
             InputShape(kind, s, b, kind), cache_len)
            for arch, kind, b, s, cache_len in CELLS]


def count(device):
    """Every cell's counts on this rank of a MESH mesh."""
    import torch

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_model_mesh
    mesh = make_model_mesh(MESH, device_type="cpu")
    out = {}
    for name, cfg, shape, cache_len in cells():
        r = dryrun.dry_run(cfg, shape, mesh, dtype=torch.float32,
                           cache_len=cache_len, accum_steps=1, device=device)
        out[name] = {k: r[k] for k in (
            "flops", "kernels", "collectives", "collective_calls",
            "param_bytes_per_device", "opt_bytes_per_device",
            "cache_bytes_per_device", "batch_bytes_per_device",
            "n_params", "n_active_params")}
        out[name]["argument_bytes"] = r["memory_analysis"]["argument_bytes"]
    return out


@contextlib.contextmanager
def kernels_booked():
    """CPU kernel calls book the kernels' work and run their plain
    versions unseen by the dispatch modes (module docstring)."""
    import torch
    from torch.utils._python_dispatch import _disable_current_modes

    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.roofline import analysis as ra

    def meta(x):
        return x.detach().to("meta") if isinstance(x, torch.Tensor) else x

    class Flash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, window, cap):
            with _disable_current_modes():
                out = fa.flash_attention_plain(q, k, v, causal=causal,
                                               window=window, soft_cap=cap)
                lse = fa.attention_lse_plain(q, k, causal=causal,
                                             window=window, soft_cap=cap)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.args = causal, window, cap
            return out

        @staticmethod
        def backward(ctx, do):
            q, k, v, out, lse = ctx.saved_tensors
            causal, window, cap = ctx.args
            ra.record("flash_attention_bwd",
                      fa._meta_work(q, k, causal, window, backward=True))
            with _disable_current_modes():
                grads = fa.flash_attention_bwd_plain(
                    q, k, v, out, lse, do, causal=causal, window=window,
                    soft_cap=cap)
            return (*grads, None, None, None)

    class Scan(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, u, h0):
            with _disable_current_modes():
                h = rs.rglru_scan_plain(a, u, h0)
            ctx.save_for_backward(a, h, h0)
            ctx.u_dtype = u.dtype
            return h

        @staticmethod
        def backward(ctx, dh):
            a, h, h0 = ctx.saved_tensors
            ra.record("rglru_scan_bwd",
                      ra.rglru_bwd_work(*a.shape, a.element_size()))
            with _disable_current_modes():
                da, du, dh0 = rs.rglru_scan_bwd_plain(a, h, dh, h0)
            return da.to(a.dtype), du.to(ctx.u_dtype), dh0

    def booked(name):
        real = getattr(ops, name)

        def run(*args, **kw):
            real(*map(meta, args), **{k: meta(v) for k, v in kw.items()})
            if name == "flash_attention" and _build.wants_grad(*args[:3]):
                return Flash.apply(*args[:3], kw.get("causal", True),
                                   kw.get("window"), kw.get("soft_cap"))
            if name == "rglru_scan" and _build.wants_grad(*args):
                return Scan.apply(*args, *([None] * (3 - len(args))))
            with _disable_current_modes():
                return real(*args, **kw)
        return real, run

    names = ("bvsb", "bvsb_partials", "bvsb_merge", "flash_attention",
             "decode_attention", "decode_attention_partials",
             "decode_attention_merge", "rglru_scan", "moe_dispatch",
             "moe_combine")
    saved = {n: booked(n) for n in names}
    for n, (_, run) in saved.items():
        setattr(ops, n, run)
    try:
        yield
    finally:
        for n, (real, _) in saved.items():
            setattr(ops, n, real)


def rank_main(rank, init_file, out_dir):
    """One gloo rank: every cell run on the CPU, its counts pickled."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", world_size=WORLD,
        rank=rank, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    results = {}
    try:
        with kernels_booked():
            results["cells"] = {"ok": count("cpu")}
    except Exception:
        results["cells"] = {"error": traceback.format_exc()}
    finally:
        with open(f"{out_dir}/dryrun{rank}.pkl", "wb") as f:
            pickle.dump(results, f)
    dist.destroy_process_group()


def fake_main():
    """Every cell on ``meta``, rank 0 of a fake group of WORLD."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun
    torch.set_num_threads(1)
    _build.META_SMS = 1
    with dryrun.fake_world(WORLD):
        return count("meta")


# the fake dry-run's process: pickles fake_main() to its last argument
FAKE_CODE = ("import pickle, sys\n"
             "import dryrun_ranks\n"
             "with open(sys.argv[-1], 'wb') as f:\n"
             "    pickle.dump(dryrun_ranks.fake_main(), f)\n")
