"""The port's sharding rules and input stand-ins held to the JAX
package's ``launch/shardings.py`` and ``launch/inputs.py``.

Every leaf of every config in ``ARCHS`` at full size (``jax.eval_shape``
of the JAX parameters, no device): the port's ``param_spec`` equals
JAX's at model sizes 4 and 16 and FSDP sizes 1, 2 and 16; its cache rule
equals ``cache_shardings``' specs on an ``AbstractMesh``; its
``batch_spec`` equals JAX's, and so do its ``param_shardings`` and
``opt_shardings`` with and without FSDP. The layout the port stores
(``models.layout.model_dim``, and the shapes a model built for a model rank
allocates) is ``param_spec``'s model part but for the two named
departures: attention projections whose head count "model" does not
divide, and an xLSTM block whose heads "model" does not divide; its data
part (``models.layout.data_dim``, and the shapes a model stored FSDP
allocates) is ``param_spec``'s FSDP entry. ``inputs.py``'s meta tensors match
``repro.launch.inputs``' ``ShapeDtypeStruct``s, shape and dtype, for every
(arch x ``INPUT_SHAPES``) cell. Everything here is exact.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jget_config
from repro.launch import inputs as jinputs
from repro.launch import shardings as jshard
from repro.models.model import build_model as jbuild_model
from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config
from repro_torch.launch import inputs, shardings
from repro_torch.models import layout
from repro_torch.models.common import MeshContext
from repro_torch.models.model import _jax_location, build_model

ARCH_NAMES = sorted(ARCHS)
DTYPES = {np.dtype("float32"): torch.float32,
          np.dtype("int32"): torch.int32,
          np.dtype(jax.numpy.bfloat16): torch.bfloat16}


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    cfg = jget_config(arch)
    return jax.eval_shape(lambda: jbuild_model(cfg).init(jax.random.key(0)))


def _names(path):
    return [str(p.key) if hasattr(p, "key") else str(p.idx) for p in path]


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("model_size", [4, 16])
@pytest.mark.parametrize("fsdp_size", [1, 2, 16])
def test_param_spec_equals_jax_for_every_leaf(arch, model_size, fsdp_size):
    axes = ("data",) if fsdp_size > 1 else ()
    leaves = _leaves(_jax_params(arch))
    assert leaves
    for path, leaf in leaves:
        want = jshard.param_spec(path, leaf, fsdp_axes=axes,
                                 fsdp_size=fsdp_size, model_size=model_size)
        got = shardings.param_spec(_names(path), leaf.shape, fsdp_axes=axes,
                                   fsdp_size=fsdp_size,
                                   model_size=model_size)
        assert got == tuple(want), (_names(path), got, want)


def _rank_model(cfg, m, d=1):
    """The model of the last model rank of m (and, stored FSDP, of the
    last data rank of d), on ``meta``."""
    cls = build_model(cfg, device="meta").__class__
    return cls(cfg, device=torch.device("meta"),
               mctx=MeshContext(model_size=m, model_rank=m - 1, data_size=d,
                                data_rank=d - 1, fsdp=d > 1))


def _jax_shape(full, name, cfg):
    """(JAX leaf path, the leaf's shape, its stacked layer or -1) of a port
    parameter whose one-card shape ``full`` holds."""
    path, layer, n = _jax_location(name, cfg)
    shape = tuple(full[name].shape) if layer < 0 else \
        (n,) + tuple(full[name].shape)
    return path, shape, layer


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("m", [4, 16])
def test_each_rank_allocates_only_its_model_part(arch, m):
    """A model built for a model rank allocates each parameter at its full
    shape with the stored model dim cut m ways, and that dim is
    ``param_spec``'s but for the departures, which are named: wq / wk /
    wv / wo where m does not divide the heads they hold, and an xLSTM
    block's leaves where m does not divide its heads (xlstm-350m's four:
    none at m = 4, both blocks whole at m = 16)."""
    cfg = get_config(arch)
    full = dict(build_model(cfg, device="meta").named_parameters())
    departures = set()
    for name, p in _rank_model(cfg, m).named_parameters():
        path, jshape, layer = _jax_shape(full, name, cfg)
        dim = layout.model_dim(path, jshape, m, cfg)
        spec_dim = shardings.spec_model_dim(shardings.param_spec(
            path, jshape, model_size=m))
        want = list(full[name].shape)
        if dim is not None:
            dim -= layer >= 0
            want[dim] //= m
        assert list(p.shape) == want, (name, tuple(p.shape), want)
        if dim is None and spec_dim is not None:
            departures.add(name)
    heads = {"wq": cfg.num_heads, "wo": cfg.num_heads,
             "wk": cfg.num_kv_heads, "wv": cfg.num_kv_heads}
    for name in departures:
        leaf = name.rsplit(".", 1)[-1]
        blocks = {"mlstm", "slstm"} & set(name.split("."))
        assert (blocks and all(layout.xlstm_heads(cfg, b) % m
                               for b in blocks)) or \
            (not blocks and leaf in heads and heads[leaf] % m), name
    if arch == "recurrentgemma-9b" and m == 4:
        # one KV head of 256 over four ranks: JAX's 64-feature pieces
        assert {n.rsplit(".", 1)[-1] for n in departures} == {"wk", "wv"}
    if arch == "xlstm-350m":
        if m == 4:
            assert not departures
        else:
            blocks = {n for n in departures
                      if {"mlstm", "slstm"} & set(n.split("."))}
            assert blocks == departures and \
                {n.split(".")[2] for n in blocks} == {"mlstm", "slstm"}


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("data_size", [2, 16])
def test_data_dim_equals_param_spec_fsdp_entry(arch, data_size):
    """``layout.data_dim`` is the dim ``param_spec`` puts the FSDP axes on,
    for every leaf of the config at full size (None where it puts them
    nowhere)."""
    leaves = _leaves(_jax_params(arch))
    cut = 0
    for path, leaf in leaves:
        spec = shardings.param_spec(_names(path), leaf.shape,
                                    fsdp_axes=("data",),
                                    fsdp_size=data_size)
        want = spec.index("data") if "data" in spec else None
        got = layout.data_dim(_names(path), leaf.shape, data_size)
        assert got == want, (_names(path), got, want)
        cut += got is not None
    assert cut


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("shape", [(2, 4), (16, 16)])
def test_each_rank_allocates_its_fsdp_part(arch, shape):
    """A model stored FSDP for data rank d - 1 and model rank m - 1
    allocates each parameter with its model dim cut m ways and its data
    dim (``layout.data_dim``) d ways, two different dims; the leaves
    ``param_spec`` stores over the data axes are exactly those."""
    d, m = shape
    cfg = get_config(arch)
    full = dict(build_model(cfg, device="meta").named_parameters())
    n_cut = 0
    for name, p in _rank_model(cfg, m, d).named_parameters():
        path, jshape, layer = _jax_shape(full, name, cfg)
        want = list(jshape)
        mdim = layout.model_dim(path, jshape, m, cfg)
        ddim = layout.data_dim(path, jshape, d)
        spec = shardings.param_spec(path, jshape, fsdp_axes=("data",),
                                    fsdp_size=d, model_size=m)
        assert ddim == (spec.index("data") if "data" in spec else None)
        assert ddim is None or ddim != mdim, name
        if mdim is not None:
            want[mdim] //= m
        if ddim is not None:
            want[ddim] //= d
            n_cut += 1
        if layer >= 0:
            want = want[1:]
        assert list(p.shape) == want, (name, tuple(p.shape), want)
    assert n_cut


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4), (4, 16)])
def test_param_and_opt_shardings_equal_jax(arch, mesh_shape):
    """``param_shardings`` with ``fsdp`` on and off, and ``opt_shardings``
    (the moments as the parameters are for training, the step
    replicated), against the JAX package's on an ``AbstractMesh``."""
    mesh = _abstract_mesh(mesh_shape)
    params = _jax_params(arch)
    leaves = {tuple(_names(p)): leaf.shape for p, leaf in _leaves(params)}
    kw = dict(data_size=mesh_shape[0], model_size=mesh_shape[1])
    for fsdp in (True, False):
        got = shardings.param_shardings(leaves, fsdp=fsdp, **kw)
        jtree = jshard.param_shardings(mesh, params, fsdp=fsdp)
        for path, sh in _leaves(jtree):
            assert got[tuple(_names(path))] == tuple(sh.spec), path
    opt = shardings.opt_shardings(leaves, **kw)
    jopt = jshard.opt_shardings(mesh, params)
    assert opt["step"] == tuple(jopt["step"].spec)
    for key in ("mu", "nu"):
        for path, sh in _leaves(jopt[key]):
            assert opt[key][tuple(_names(path))] == tuple(sh.spec), path


def _abstract_mesh(shape):
    return AbstractMesh(shape, ("data", "model"))


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4), (4, 16)])
def test_cache_rule_equals_cache_shardings(arch, mesh_shape):
    """Every leaf of the JAX cache at decode_32k and long_500k (and a batch
    the data axis does not divide) against ``cache_shardings``."""
    mesh = _abstract_mesh(mesh_shape)
    for shape_name in ("decode_32k", "long_500k"):
        shape = INPUT_SHAPES[shape_name]
        jcfg = jinputs.arch_for_shape(jget_config(arch), shape)
        cache = jinputs.cache_specs(jbuild_model(jcfg), jcfg, shape)
        for b in (shape.global_batch, 3):
            got_tree = jshard.cache_shardings(mesh, cache, b)
            for (path, leaf), (_, sh) in zip(_leaves(cache),
                                             _leaves(got_tree)):
                got = shardings.cache_spec(
                    _names(path), leaf.shape, b, batch_axes=("data",),
                    data_size=mesh_shape[0], model_size=mesh_shape[1])
                assert got == tuple(sh.spec), (_names(path), got, sh.spec)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4), (4, 16)])
def test_batch_spec_equals_jax(mesh_shape):
    mesh = _abstract_mesh(mesh_shape)
    for b in (1, 3, 4, 32, 128):
        assert shardings.batch_spec(b, data_size=mesh_shape[0]) == \
            tuple(jshard.batch_spec(mesh, b)), b


def _same(meta, spec, what):
    assert meta.device.type == "meta", what
    assert tuple(meta.shape) == tuple(spec.shape), (what, meta.shape,
                                                    spec.shape)
    assert meta.dtype == DTYPES[np.dtype(spec.dtype)], (what, meta.dtype,
                                                        spec.dtype)


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("shape_name", sorted(INPUT_SHAPES))
def test_input_specs_match_jax(arch, shape_name):
    """batch_specs, decode_specs (with cache_specs) and params_specs at
    every (arch, input shape): the same leaves, shapes and dtypes."""
    shape = INPUT_SHAPES[shape_name]
    cfg = inputs.arch_for_shape(get_config(arch), shape)
    jcfg = jinputs.arch_for_shape(jget_config(arch), shape)
    assert repr(cfg) == repr(jcfg)
    jbatch = jinputs.batch_specs(jcfg, shape)
    batch = inputs.batch_specs(cfg, shape)
    assert sorted(batch) == sorted(jbatch)
    for key in batch:
        _same(batch[key], jbatch[key], key)
    jmodel = jbuild_model(jcfg)
    jtok, jcache, jpos = jinputs.decode_specs(jmodel, jcfg, shape)
    tok, cache, pos = inputs.decode_specs(None, cfg, shape)
    _same(tok, jtok, "tokens1")
    _same(pos, jpos, "pos")
    jleaves = {tuple(_names(p)): v for p, v in _leaves(jcache)}
    seen = set()
    for path, layer, t in inputs.cache_leaves(cache, cfg):
        path = tuple(map(str, path))
        spec = jleaves[path]
        if layer >= 0:
            spec = jax.ShapeDtypeStruct(spec.shape[1:], spec.dtype)
        _same(t, spec, path)
        seen.add(path)
    assert seen == set(jleaves)
    params = inputs.params_specs(None, cfg)
    jparams = {tuple(_names(p)): v for p, v in _leaves(_jax_params(arch))}
    used = set()
    for name, t in params.items():
        path, layer, _ = _jax_location(name, cfg)
        spec = jparams[tuple(map(str, path))]
        if layer >= 0:
            spec = jax.ShapeDtypeStruct(spec.shape[1:], spec.dtype)
        _same(t, spec, name)
        used.add(tuple(map(str, path)))
    assert used == set(jparams)
