"""The dry-run (``repro_torch.launch.dryrun``) held to the JAX package and
to an executed run.

* ``n_params`` / ``n_active_params`` equal the JAX driver's
  ``_param_counts`` for every arch, over ``jax.eval_shape`` parameters
  from ``repro.launch.inputs`` (in a process of its own: importing
  ``repro.launch.dryrun`` sets XLA_FLAGS for its process; the override
  it reads keeps one host device), exactly.
* The bytes a rank of the 16 x 16 mesh stores, leaf by leaf (its
  parameters in bf16 and AdamW's f32 moments, stored FSDP as for
  training), equal the shard bytes of JAX's ``param_shardings(fsdp=True)``
  and ``opt_shardings`` on an ``AbstractMesh``, but for the departures
  ROADMAP names, which are checked to be those: wk / wv (and wq / wo)
  whose heads "model" does not divide, and an xLSTM block whose heads it
  does not divide, kept whole.
* A dry-run on a ``fake`` (2, 2) group (rank 0, ``meta``) of the reduced
  granite-moe-1b-a400m and recurrentgemma-9b (a train step, a prefill and
  a serve step each) books, on rank 0, the same FLOPs (the aten products'
  and every kernel's work), the same collectives (kind, group, calls,
  ring bytes) and the same argument bytes as the same steps executed on
  four gloo ranks on the CPU (tests/dryrun_ranks.py), exactly.
* ``aux_load_balance_loss``'s static-shape count equals the
  ``torch.bincount`` it replaced.
"""
import json
import math
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import dryrun_ranks as D
import sharded_ranks as R
from repro.configs import get_config as jget_config
from repro.launch import inputs as jinputs
from repro.launch import shardings as jshard
from repro.models.model import build_model as jbuild_model
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import dryrun, shardings
from repro_torch.models import layout, moe
from repro_torch.models.common import MeshContext, ring_bytes
from repro_torch.models.model import _jax_location, build_model

ARCH_NAMES = sorted(ARCHS)
ROOT = pathlib.Path(__file__).resolve().parents[1]

# the JAX driver's own _param_counts over repro.launch.inputs' stand-ins,
# with one host device (REPRO_DRYRUN_XLA_FLAGS, read by the driver's first
# lines)
_JAX_COUNTS = """
import json, sys
import jax.numpy as jnp
from repro.configs import get_config, list_archs
from repro.launch import dryrun, inputs
from repro.models.model import build_model
out = {}
for arch in list_archs():
    cfg = get_config(arch)
    params = inputs.params_specs(build_model(cfg), jnp.bfloat16)
    out[arch] = list(dryrun._param_counts(params, cfg))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_counts():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               REPRO_DRYRUN_XLA_FLAGS="--xla_force_host_platform_device_"
                                      "count=1",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _JAX_COUNTS], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _rank0(cfg, m=16, d=16, dtype=torch.bfloat16):
    """Rank 0 of a (d, m) mesh's model stored FSDP, on ``meta``."""
    cls = build_model(cfg, device="meta").__class__
    return cls(cfg, device=torch.device("meta"), dtype=dtype,
               mctx=MeshContext(model_size=m, data_size=d, fsdp=d > 1))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_counts_equal_the_jax_drivers(arch, jax_counts):
    cfg = get_config(arch)
    total, active = dryrun.param_counts(_rank0(cfg))
    assert [total, active] == jax_counts[arch]
    assert dryrun.param_counts(build_model(cfg, device="meta")) == \
        (total, active)


def _names(path):
    return tuple(str(p.key) if hasattr(p, "key") else str(p.idx)
                 for p in path)


def _shard_bytes(leaf, spec, sizes):
    shape = list(leaf.shape)
    for i, axes in enumerate(spec):
        for ax in (axes,) if isinstance(axes, str) else axes or ():
            shape[i] //= sizes[ax]
    return math.prod(shape) * leaf.dtype.itemsize


def _departure(name, path, shape, cfg, m):
    """Whether the port keeps whole a leaf ``param_spec`` cuts over
    "model" (ROADMAP's departures)."""
    return layout.model_dim(path, shape, m, cfg) is None and \
        shardings.spec_model_dim(shardings.param_spec(
            path, shape, model_size=m)) is not None


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_rank_bytes_equal_jax_shard_bytes(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    params = jinputs.params_specs(jbuild_model(jcfg), jnp.bfloat16)
    mesh = AbstractMesh((16, 16), ("data", "model"))
    sizes = {"data": 16, "model": 16}
    pspecs = jshard.param_shardings(mesh, params, fsdp=True)
    ospecs = jshard.opt_shardings(mesh, params)["mu"]
    leaves = {_names(p): leaf for p, leaf in
              jax.tree_util.tree_flatten_with_path(params)[0]}
    want = {k: (_shard_bytes(leaves[k], tuple(sh.spec), sizes),
                _shard_bytes(jax.ShapeDtypeStruct(leaves[k].shape,
                                                  np.float32),
                             tuple(osh.spec), sizes))
            for (p, sh), (_, osh) in zip(
                jax.tree_util.tree_flatten_with_path(pspecs)[0],
                jax.tree_util.tree_flatten_with_path(ospecs)[0])
            for k in (_names(p),)}
    full = dict(build_model(cfg, device="meta").named_parameters())
    got, departures = {}, set()
    for name, p in _rank0(cfg).named_parameters():
        path, layer, n = _jax_location(name, cfg)
        key = tuple(map(str, path))
        shape = tuple(full[name].shape) if layer < 0 else \
            (n,) + tuple(full[name].shape)
        if _departure(name, path, shape, cfg, 16):
            departures.add(key)
        pb, ob = got.get(key, (0, 0))
        got[key] = (pb + p.numel() * p.element_size(), ob + p.numel() * 4)
    assert set(got) == set(want)
    for key in got:
        if key not in departures:
            assert got[key] == want[key], (key, got[key], want[key])
    heads = {"wq": cfg.num_heads, "wo": cfg.num_heads,
             "wk": cfg.num_kv_heads, "wv": cfg.num_kv_heads}
    for key in departures:
        blocks = {"mlstm", "slstm"} & set(key)
        assert (blocks and all(layout.xlstm_heads(cfg, b) % 16
                               for b in blocks)) or \
            (not blocks and heads.get(key[-1], 16) % 16), key


def test_ring_bytes_of_each_kind():
    assert ring_bytes("reduce", 4, 400) == 600
    assert ring_bytes("gather", 4, 400) == 300
    assert ring_bytes("reduce-scatter", 16, 1600) == 1500
    assert ring_bytes("gather", 1, 400) == 0


@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    spawned = R.Spawned(tmp, D.rank_main, (), "dryrun", D.FAKE_CODE, ())
    try:
        yield spawned.per_rank("cells")[0], spawned.jax()
    finally:
        spawned.close()


@pytest.mark.parametrize("cell", [f"{a} {k}" for a, k, *_ in D.CELLS])
def test_fake_dry_run_equals_four_gloo_ranks(cell, counted):
    ran, fake = (c[cell] for c in counted)
    assert fake["kernels"], cell
    assert fake["collective_calls"] > 0, cell
    for key in ("flops", "kernels", "collectives", "collective_calls",
                "argument_bytes", "param_bytes_per_device",
                "opt_bytes_per_device", "cache_bytes_per_device",
                "batch_bytes_per_device", "n_params", "n_active_params"):
        assert fake[key] == ran[key], (cell, key, fake[key], ran[key])


def test_aux_load_balance_count_equals_bincount():
    cfg = get_config("deepseek-moe-16b")
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, cfg.num_experts, (333, 6)))
    probs = torch.softmax(torch.as_tensor(
        rng.standard_normal((333, cfg.num_experts)), dtype=torch.float32), -1)
    counts = torch.bincount(ids.reshape(-1), minlength=cfg.num_experts)
    frac = counts.float() / torch.clamp(counts.float().sum(), min=1.0)
    want = cfg.num_experts * torch.sum(probs.mean(dim=0) * frac)
    assert torch.equal(moe.aux_load_balance_loss(probs, ids, cfg), want)
    meta = moe.aux_load_balance_loss(probs.to("meta"), ids.to("meta"), cfg)
    assert meta.shape == () and meta.device.type == "meta"
