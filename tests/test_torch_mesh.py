"""The step factories over a (data, model) mesh held to the JAX package's,
on four ``gloo`` ranks on the CPU.

A module-scoped fixture draws the JAX package's weights for the reduced
granite-moe-1b-a400m (MoE, tied table), deepseek-moe-16b (a dense first
layer, a shared expert, an untied head), seamless-m4t-medium (the
encoder-decoder), recurrentgemma-9b (RG-LRU blocks over 16 gate
blocks, one KV head, a local window of 128) and xlstm-350m (an mLSTM and
an sLSTM block of 4 heads each, cut by heads), then starts the four ranks
once
(tests/sharded_ranks.py's ``Spawned`` running ``mesh_rank_main``: a
``file://`` rendezvous under the test's temporary directory, one torch
thread a rank, a group timeout, a join timeout) and, beside them, the
JAX package's own steps on 4-device CPU meshes with Auto axes, its
parameters placed by ``param_shardings`` and its cache by
``cache_shardings`` (``jax_mesh_reference``, a subprocess with XLA_FLAGS
set). On meshes (2, 2) and (1, 4) each rank runs ``make_prefill_step`` on
4 prompts of 8 tokens into rings of ``MESH_CACHE`` slots, 2
``make_serve_step`` steps of seeded tokens, the gradients of the train
step's loss and one ``make_train_step``, every layer but the norms and
the router cut over the model ranks (``launch.shardings``); on (2, 2)
the training runs on a model stored FSDP (``fsdp=True``: each matrix's
other dim over the data ranks, as JAX's ``param_shardings(fsdp=True)``
places the reference), beside the same steps on the resident weights;
on (1, 4) also the port's one-rank steps on the same inputs. The tests
below read the ranks' results.

Tolerances: conf 1e-5 absolute and top-1 equal wherever the top-2 logit
gap exceeds 1e-4 (float32 sums over the model ranks in another order);
every rank's conf and top-1 equal bit for bit; the loss and the step's
metrics 1e-5 relative; each gradient, and each first moment of the
train step (the gradient the step applied after its accumulation, its
sum over the data group and its clipping, times 1 - beta1), within 1e-4
of the JAX leaf's (or its expert slice's) max; the updated parameters
within 2 lr of JAX's (Adam's first step moves a parameter by about lr
sign(g), so a gradient near zero may move the two apart by up to 2 lr,
as in tests/test_torch_grads.py). FSDP against the resident weights:
each gradient within 1e-4 of the leaf's max, the metrics 1e-5 relative,
conf 1e-5 and top-1 equal where the gap exceeds 1e-4; each rank's bytes
exactly the leaves' parts. The plain BvSB partial and merge entries
against ``bvsb_plain`` 1e-6, top-1 exact (on rows without +inf, whose
BvSB is NaN on either side), for any cut of a row.
"""
import pickle

import jax
import numpy as np
import pytest
import torch

import sharded_ranks as R
from repro.configs import get_config as jget_config
from repro.models.model import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.kernels.bvsb import (bvsb_merge_plain, bvsb_partials_plain,
                                      bvsb_plain)
from repro_torch.launch.shardings import param_spec, spec_model_dim
from repro_torch.models.layout import data_dim, model_dim
from repro_torch.models.model import _jax_location, part_index

torch.set_num_threads(2)

CONF_ATOL = 1e-5
GAP = 1e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
MERGE_ATOL = 1e-6
CASES = [(arch, shape) for arch in R.MESH_ARCHS for shape in R.MESH_SHAPES]
CASE_IDS = [f"{a}-{s[0]}x{s[1]}" for a, s in CASES]
FSDP_SHAPE = (2, 2)


class _MeshRanks(R.Spawned):
    """The JAX package's weights drawn here, then the four ranks and the
    JAX reference started on them."""

    def __init__(self, tmp):
        trees = {}
        for i, arch in enumerate(R.MESH_ARCHS):
            jcfg = jget_config(arch).reduced()
            assert repr(jcfg) == repr(get_config(arch).reduced())
            trees[arch] = jax.tree.map(np.asarray, jbuild_model(jcfg).init(
                jax.random.key(31 + i)))
        trees_file = tmp / "trees.pkl"
        trees_file.write_bytes(pickle.dumps(trees))
        super().__init__(tmp, R.mesh_rank_main, (str(trees_file),), "mesh",
                         "import sys, sharded_ranks; "
                         "sharded_ranks.jax_mesh_reference(*sys.argv[1:])",
                         (trees_file,))
        self.trees = trees

    def case(self, name):
        return self.per_rank(name)

    def jax(self, name):
        return super().jax()[name]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = _MeshRanks(tmp_path_factory.mktemp("mesh"))
    yield r
    r.close()


def _leaf(tree, name, cfg):
    path, layer, _ = _jax_location(name, cfg)
    for key in path:
        tree = tree[key]
    tree = np.asarray(tree)
    return tree if layer < 0 else tree[layer]


def _part(res, name, train=True):
    """The index of this rank's stored part of a leaf into the whole leaf:
    of the trained model (its model and data parts), or of the serving
    model's (``train=False``: its model part)."""
    parts = res["train_parts"] if train else res["parts"]
    dparts = res["train_data_parts"] if train else {}
    data = dparts[name][:2] if name in dparts else None
    if name in parts:
        return part_index(*parts[name][:2], data=data)
    return () if data is None else part_index(*data)


def _flat(tree, path=()):
    """(path of key names, leaf) of a JAX parameter tree of numpy arrays."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (str(i),))
    else:
        yield path, np.asarray(tree)


def _leaf_err(got, ref):
    ref = np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / (scale if scale > 0 else 1.0))


def _gaps(per_rank):
    """The whole batch's top-2 gap at each served position, from the ranks
    at model position 0."""
    out = np.zeros((R.MESH_SERVE + 1, R.MESH_B))
    for res in per_rank:
        if res["positions"][1] == 0:
            start, stop, gaps = res["gaps"]
            out[:, start:stop] = np.stack(gaps)
    return out


def _assert_steps(steps, ref, gaps):
    for i, ((conf, top1), (rconf, rtop1)) in enumerate(zip(steps, ref)):
        np.testing.assert_allclose(conf, rconf, atol=CONF_ATOL,
                                   err_msg=f"step {i}")
        clear = gaps[i] > GAP
        assert clear.any()
        assert np.array_equal(top1[clear], np.asarray(rtop1)[clear]), i


@pytest.mark.parametrize("arch,shape", CASES, ids=CASE_IDS)
def test_prefill_and_serve_steps_match_jax(ranks, arch, shape):
    """Prefill and two serve steps on every rank: conf and top-1 of the
    whole batch against the JAX package's on the same mesh, and equal bit
    for bit on every rank."""
    per_rank = ranks.case(f"{arch} {shape}")
    ref = ranks.jax(f"{arch} {shape}")["steps"]
    gaps = _gaps(per_rank)
    for res in per_rank:
        _assert_steps(res["steps"], ref, gaps)
        for (c, t), (c0, t0) in zip(res["steps"], per_rank[0]["steps"]):
            assert np.array_equal(c, c0) and np.array_equal(t, t0)
            assert t.dtype == np.int32 and c.dtype == np.float32


@pytest.mark.parametrize("arch,shape", CASES, ids=CASE_IDS)
def test_train_step_matches_jax(ranks, arch, shape):
    """One train step on every rank: the loss and the step's metrics
    against JAX's, each gradient (summed over the data group) and the
    step's first moment against the JAX leaf or this rank's stored part of
    it (``model_parts``, and ``data_parts`` for (2, 2)'s FSDP storage),
    the updated parameters likewise."""
    cfg = get_config(arch).reduced()
    ref = ranks.jax(f"{arch} {shape}")
    lr = R.MESH_ADAMW["lr"]
    for res in ranks.case(f"{arch} {shape}"):
        for key in ("loss", "ce", "aux", "grad_norm", "lr"):
            assert res["metrics"][key] == pytest.approx(
                ref["metrics"][key], rel=LOSS_RTOL, abs=1e-7), key
        assert res["grad_loss"] == pytest.approx(ref["metrics"]["loss"],
                                                 rel=LOSS_RTOL)
        for name, g in res["grads"].items():
            rows = _part(res, name)
            want = _leaf(ref["grads"], name, cfg)[rows]
            assert g.shape == want.shape, name
            assert _leaf_err(g, want) <= GRAD_TOL, (name, _leaf_err(g, want))
            mu = _leaf(ref["mu"], name, cfg)[rows]
            assert res["mu"][name].shape == mu.shape, name
            assert _leaf_err(res["mu"][name], mu) <= GRAD_TOL, \
                (name, _leaf_err(res["mu"][name], mu))
            p = res["params"][name]
            assert np.abs(p - _leaf(ref["params"], name, cfg)[rows]).max() \
                <= 2 * lr + 1e-7, name


def test_train_step_accumulates_each_global_microbatch(ranks):
    """Two microbatches on (2, 2): each rank differentiates its share of
    each global microbatch, as JAX's shard_map inside its scan; the loss
    and the step's metrics against JAX's."""
    ref = ranks.jax("accum")
    for met in ranks.case("accum"):
        for key in ("loss", "ce", "aux", "grad_norm", "lr"):
            assert met[key] == pytest.approx(ref[key], rel=LOSS_RTOL,
                                             abs=1e-7), key


@pytest.mark.parametrize("arch", R.MESH_ARCHS)
def test_one_by_m_mesh_is_the_one_rank_run(ranks, arch):
    """On (1, 4) every rank's steps, loss and gradients equal the port's
    one-rank run on the same weights and inputs, within the tolerances
    (the model ranks' partial sums add in another order)."""
    per_rank = ranks.case(f"{arch} (1, 4)")
    gaps = _gaps(per_rank)
    for res in per_rank:
        local = res["local"]
        _assert_steps(res["steps"], res["local_steps"], gaps)
        assert res["metrics"]["loss"] == pytest.approx(
            local["metrics"]["loss"], rel=LOSS_RTOL)
        for name, g in res["grads"].items():
            want = local["grads"][name][_part(res, name)]
            assert _leaf_err(g, want) <= GRAD_TOL, name


@pytest.mark.parametrize("shape", R.MESH_SHAPES)
def test_experts_are_held_only_by_their_rank(ranks, shape):
    """Model rank j holds experts [j E/m, (j+1) E/m) and nothing else of
    the expert leaves; the replicated parameters are equal bit for bit on
    every rank after the step."""
    cfg = get_config("deepseek-moe-16b").reduced()
    e, m = cfg.num_experts, shape[1]
    per_rank = ranks.case(f"deepseek-moe-16b {shape}")
    for r, res in enumerate(per_rank):
        assert res["positions"] == divmod(r, m)
        j = res["positions"][1]
        experts = {k: v for k, v in res["parts"].items()
                   if ".moe.w_" in k}
        assert experts
        for name, (dim, rows, pshape) in experts.items():
            assert (dim, rows) == (0, slice(j * e // m, (j + 1) * e // m))
            assert pshape[0] == e // m, name
        for name, p in res["params"].items():
            if name not in res["train_parts"] and \
                    name not in res["train_data_parts"]:
                assert np.array_equal(p, per_rank[0]["params"][name]), name


@pytest.mark.parametrize("arch,shape", CASES, ids=CASE_IDS)
def test_each_rank_holds_only_its_model_part(ranks, arch, shape):
    """Each rank's parameter bytes are the sum over the JAX leaves of the
    part the layout gives it: a leaf the port cuts (``layout.model_dim``)
    a 1/m share, the rest whole; the leaves ``param_spec`` cuts but the
    port keeps whole are exactly the named departure (wk / wv where m does
    not divide the KV heads: recurrentgemma's one KV head; no xLSTM leaf,
    whose heads m divides); each rank's parts are [j n, (j+1) n) of their
    leaf, but the mLSTM's w_up (its heads' columns of each gate)."""
    cfg = get_config(arch).reduced()
    m = shape[1]
    tree = ranks.trees[arch]
    want, departures = 0, set()
    for path, leaf in _flat(tree):
        dim = model_dim(path, leaf.shape, m, cfg)
        spec_dim = spec_model_dim(param_spec(path, leaf.shape, model_size=m))
        want += leaf.size * 4 // (m if dim is not None else 1)
        if dim is None and spec_dim is not None:
            departures.add(path[-1])
    assert departures == ({"wk", "wv"} if cfg.num_kv_heads % m else set())
    for res in ranks.case(f"{arch} {shape}"):
        assert res["bytes"] == want
        assert res["parts"]
        j = res["positions"][1]
        for name, (dim, rows, pshape) in res["parts"].items():
            if name.endswith("mlstm.w_up"):
                assert len(rows) == pshape[dim], name
                continue
            assert (rows.start, rows.stop) == (j * pshape[dim],
                                               (j + 1) * pshape[dim]), name


@pytest.mark.parametrize("arch", R.MESH_ARCHS)
def test_fsdp_rank_stores_its_model_and_data_part(ranks, arch):
    """On (2, 2) the trained model is stored FSDP: each rank's parameter
    bytes equal, exactly, the sum over the JAX leaves of the whole leaf
    over its model cut (``layout.model_dim``) and its data cut
    (``layout.data_dim``, ``param_spec``'s FSDP entry); each data part is
    data rank r's [r n, (r + 1) n) of a dim the model ranks do not cut,
    and the resident serving model stores no data part."""
    cfg = get_config(arch).reduced()
    d, m = FSDP_SHAPE
    want = 0
    for path, leaf in _flat(ranks.trees[arch]):
        mdim = model_dim(path, leaf.shape, m, cfg)
        ddim = data_dim(path, leaf.shape, d)
        assert ddim is None or ddim != mdim, path
        want += leaf.size * 4 // (m if mdim is not None else 1) \
            // (d if ddim is not None else 1)
    per_rank = ranks.case(f"{arch} {FSDP_SHAPE}")
    cut = set()
    for name in per_rank[0]["params"]:
        path, layer, _ = _jax_location(name, cfg)
        shape = _leaf(ranks.trees[arch], name, cfg).shape
        if data_dim(path, shape, d) is not None:
            cut.add(name)
    assert cut
    for res in per_rank:
        assert res["train_bytes"] == want
        assert res["bytes"] > want
        r = res["positions"][0]
        assert set(res["train_data_parts"]) == cut
        for name, (dim, rows, pshape) in res["train_data_parts"].items():
            assert rows == slice(r * pshape[dim], (r + 1) * pshape[dim])
            assert name not in res["train_parts"] or \
                res["train_parts"][name][0] != dim


@pytest.mark.parametrize("arch", R.MESH_ARCHS)
def test_fsdp_and_resident_steps_agree(ranks, arch):
    """On (2, 2) the FSDP-stored model's train step against the same step
    on the resident weights: the metrics 1e-5 relative, each gradient and
    first moment (the FSDP shard against its slice) within 1e-4 of the
    leaf's max; its prefill and serve steps against the resident ones,
    conf 1e-5 and top-1 equal where the top-2 gap exceeds 1e-4."""
    per_rank = ranks.case(f"{arch} {FSDP_SHAPE}")
    gaps = _gaps(per_rank)
    for res in per_rank:
        resident = res["resident"]
        for key in ("loss", "ce", "aux", "grad_norm", "lr"):
            assert res["metrics"][key] == pytest.approx(
                resident["metrics"][key], rel=LOSS_RTOL, abs=1e-7), key
        for name, g in res["grads"].items():
            dparts = res["train_data_parts"]
            rows = part_index(*dparts[name][:2]) if name in dparts else ()
            for key, got in (("grads", g), ("mu", res["mu"][name])):
                want = resident[key][name][rows]
                assert got.shape == want.shape, name
                assert _leaf_err(got, want) <= GRAD_TOL, (key, name)
        _assert_steps(res["fsdp_steps"], res["steps"], gaps)


@pytest.mark.parametrize("shape", R.MESH_SHAPES)
def test_mlstm_w_up_holds_its_heads_gate_columns(ranks, shape):
    """The mLSTM's w_up (d, 3d) = [cell input 2d | output gate d] cut by
    heads: model rank j holds cell-input columns [j 2d/m, (j+1) 2d/m) and
    output-gate columns 2d + [j d/m, (j+1) d/m) of the JAX leaf, in that
    order (the same count as ``param_spec``'s contiguous cut)."""
    arch = "xlstm-350m"
    cfg = get_config(arch).reduced()
    d, m = cfg.d_model, shape[1]
    leaf = np.asarray(ranks.trees[arch]["blocks"][0]["mlstm"]["w_up"][0])
    for res in ranks.case(f"{arch} {shape}"):
        j = res["positions"][1]
        cols = list(range(j * 2 * d // m, (j + 1) * 2 * d // m)) + \
            list(range(2 * d + j * d // m, 2 * d + (j + 1) * d // m))
        assert res["w_up"].shape == (d, 3 * d // m)
        assert np.array_equal(res["w_up"], leaf[:, cols])


def test_rings_cut_on_their_slots_and_whole(ranks):
    """A ring the model ranks divide is cut on its slots: granite's 10
    slots over (2, 2)'s two model ranks and recurrentgemma's 128 over
    both meshes; granite's 10 over (1, 4)'s four stay whole. The 8 + 2
    written slots of recurrentgemma's ring lie in model rank 0's shard,
    the other shards empty."""
    for arch, shape, cut in (("granite-moe-1b-a400m", (2, 2), True),
                             ("granite-moe-1b-a400m", (1, 4), False),
                             ("recurrentgemma-9b", (2, 2), True),
                             ("recurrentgemma-9b", (1, 4), True)):
        w = R.MESH_CACHE[arch]
        for res in ranks.case(f"{arch} {shape}"):
            assert res["rings"]
            j = res["positions"][1]
            for whole, mine, written in res["rings"]:
                assert whole == w
                assert mine == (w // shape[1] if cut else w)
                if arch == "recurrentgemma-9b":
                    used = R.MESH_S + R.MESH_SERVE
                    assert written == min(max(used - j * mine, 0), mine)


def test_model_mesh_helpers(ranks):
    for res in ranks.case("helpers"):
        assert res["axes"] == ("data", "model")
        assert res["batch_axes"] == ("data",)
        assert res["sizes"] == (2, 2, 1, 4)
        assert res["groups"] == (True, False)
        assert "(2, 3)" in res["bad_shape"]
    assert [res["positions"] for res in ranks.case("helpers")] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_vocab_parallel_tie_keeps_the_one_device_semantics(ranks):
    """A maximum tied across two model shards: the port's merge gives
    margin 0 at the first index, as the one-device BvSB does; the JAX
    package's vocab-parallel merge takes the larger index and a runner-up
    past the duplicated maximum (ROADMAP.md's divergences)."""
    hidden, table, vocab = R.tie_inputs()
    logits = hidden[:, 0] @ table.T
    logits[:, vocab:] = -1e30
    pconf, ptop1 = bvsb_plain(torch.from_numpy(logits))
    assert int(ptop1[0]) == R.TIE_ROWS[0] and float(pconf[0]) == 0.0
    for conf, top1 in ranks.case("tie"):
        assert np.array_equal(top1, ptop1.numpy())
        assert conf[0] == 0.0
        np.testing.assert_allclose(conf, pconf.numpy(), atol=MERGE_ATOL)
    jconf, jtop1 = ranks.jax("tie")
    assert int(jtop1[0]) == R.TIE_ROWS[1] and float(jconf[0]) > 0.0
    assert int(jtop1[1]) == int(ptop1[1])


# ---------------------------------------------------------------------------
# the BvSB kernel's partial and merge entries, plain versions
# ---------------------------------------------------------------------------
def _cuts(v, n, rng):
    """n contiguous shards of a row of v columns, at random boundaries (a
    shard may hold one column)."""
    inner = np.sort(rng.choice(np.arange(1, v), n - 1, replace=False))
    return [0, *inner.tolist(), v]


def _merged(x, bounds):
    parts = torch.stack([bvsb_partials_plain(x[:, a:b], a)
                         for a, b in zip(bounds[:-1], bounds[1:])], dim=1)
    return bvsb_merge_plain(parts)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 16])
def test_partials_merged_equal_bvsb_plain_for_any_cut(n):
    rng = np.random.default_rng(n)
    x = torch.from_numpy((rng.standard_normal((6, 300)) * 4).astype(
        np.float32))
    x[1, 280:] = -1e30                       # padded columns
    x[2, [3, 290]] = 40.0                    # a tie, likely across shards
    x[3, :150] = float("-inf")               # shards all -inf
    x[4] = 0.0                               # every column tied
    x[5, 17] = float("inf")                  # +inf: NaN, as on one device
    for trial in range(3):
        bounds = _cuts(300, n, rng)
        conf, top1 = _merged(x, bounds)
        pconf, ptop1 = bvsb_plain(x)
        np.testing.assert_allclose(conf.numpy(), pconf.numpy(),
                                   atol=MERGE_ATOL)
        finite = ~torch.isnan(pconf)       # a NaN row's top-1 is arbitrary
        assert torch.equal(top1[finite], ptop1[finite]), bounds
        assert bool(torch.isnan(conf[5]))
        assert conf.dtype == torch.float32 and top1.dtype == torch.int32
        assert float(conf[2]) == 0.0 and int(top1[2]) == 3
        assert float(conf[4]) == 0.0 and int(top1[4]) == 0


def test_partials_of_an_all_inf_shard_weigh_nothing():
    x = torch.full((2, 10), float("-inf"))
    t = bvsb_partials_plain(x, 40)
    assert torch.equal(t, torch.tensor([[float("-inf"), float("-inf"), 0.0,
                                         40.0]] * 2))
    live = torch.tensor([[1.0, 3.0, 3.0, -2.0]])
    parts = torch.stack([bvsb_partials_plain(live, 0),
                         bvsb_partials_plain(torch.full((1, 5), -1e30), 4),
                         bvsb_partials_plain(x[:1], 9)], dim=1)
    conf, top1 = bvsb_merge_plain(parts)
    assert int(top1[0]) == 1 and float(conf[0]) == 0.0
