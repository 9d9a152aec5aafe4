"""The port's decoder zoo held to the JAX package on the CPU: the three MoE
configs, the three dense GQA configs and Qwen2-VL-7B's M-RoPE decoder at
``reduced()`` size, JAX's weights carried across by ``params_from_jax``.

Tolerances: forward logits 1e-4 (float32 matmuls and sums in another
order); decode over the f32 cache 5e-3 and over the default bf16 cache the
same (as tests/test_models.py and tests/test_torch_recurrent.py gate
decode); the step factories' BvSB 1e-6, top-1 equal wherever JAX's top-2
logit gap exceeds 1e-4; MoE routing ids equal wherever the gap between
the k-th and (k+1)-th router probability exceeds 1e-6, the MoE output
within 1e-4 on the tokens whose routing and kept assignments agree, the
aux loss within 1e-5 relative; M-RoPE 1e-5 (cos / sin of another
library); parameter counts and configs exactly equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import cascade_tiers as jtiers
from repro.configs import get_config as jget_config
from repro.configs import list_archs
from repro.launch import distributed as jdist
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.models.common import LOCAL, KeyGen
from repro.models.model import build_model as jbuild_model
from repro.configs.base import INPUT_SHAPES as JAX_INPUT_SHAPES
from repro_torch.configs import ARCHS, INPUT_SHAPES, InputShape, get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.cascade_tiers import TIERS
from repro_torch.launch.distributed import make_prefill_step, make_serve_step
from repro_torch.models import common, moe, transformer
from repro_torch.models.model import build_model, init_params, params_from_jax

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-4)
DECODE_ATOL = 5e-3
CONF_ATOL = 1e-6
GAP = 1e-4
ROUTE_GAP = 1e-6
MOE_ATOL = 1e-4
AUX_RTOL = 1e-5
MROPE_ATOL = 1e-5

ZOO = ("granite-moe-1b-a400m", "deepseek-moe-16b", "moonshot-v1-16b-a3b",
       "qwen3-32b", "gemma-7b", "stablelm-12b", "qwen2-vl-7b")


@pytest.fixture(scope="module")
def zoo():
    """name -> (jax model, jax params (numpy tree), port model, cfg) of the
    reduced config, built once per module."""
    built = {}

    def get(name):
        if name not in built:
            jcfg = jget_config(name).reduced()
            cfg = get_config(name).reduced()
            assert repr(cfg) == repr(jcfg)
            jm = jbuild_model(jcfg)
            tree = jax.tree.map(np.asarray,
                                jm.init(jax.random.key(ZOO.index(name))))
            built[name] = (jm, tree, params_from_jax(tree, cfg, device="cpu"),
                           cfg)
        return built[name]

    return get


def _inputs(cfg, b, s, seed):
    """Tokens (B, S) and, for the VLM, seeded vision embeddings (B, V, d)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    vision = None
    if cfg.family == "vlm":
        vision = rng.standard_normal(
            (b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    return tokens, vision


def _batch(tokens, vision):
    return {"tokens": tokens} if vision is None else \
        {"tokens": tokens, "vision_embeds": vision}


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _jax_cache_entry(jcache, cfg, i):
    """Layer i's entry of the JAX cache ({"prefix", "blocks", "tail"})."""
    n_prefix = cfg.first_dense_layers
    if i < n_prefix:
        return jcache["prefix"][i]
    n_sb = cfg.num_layers - n_prefix
    if i - n_prefix >= n_sb:
        return jcache["tail"][i - n_prefix - n_sb]
    return {k: v[i - n_prefix] for k, v in jcache["blocks"][0].items()}


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
def _as_port(jcfg):
    return ArchConfig(**dataclasses.asdict(jcfg))


def test_zoo_configs_are_the_jax_packages():
    assert set(ARCHS) == set(list_archs())
    for name in ARCHS:
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(jget_config(name)), name
        assert dataclasses.asdict(get_config(name).reduced()) == \
            dataclasses.asdict(jget_config(name).reduced()), name


def test_input_shapes_are_the_jax_packages():
    assert INPUT_SHAPES == {k: InputShape(**dataclasses.asdict(v))
                            for k, v in JAX_INPUT_SHAPES.items()}
    assert INPUT_SHAPES["long_500k"] == InputShape("long_500k", 524_288, 1,
                                                   "decode")


@pytest.mark.parametrize("name", list_archs() + sorted(jtiers.TIERS))
def test_param_counts_equal_jax(name):
    """Every arch of the JAX package and every tier, full size and reduced
    (through a copy of the JAX config, and the port's own)."""
    jcfg = jget_config(name)
    for j in (jcfg, jcfg.reduced()):
        cfg = _as_port(j)
        assert cfg.param_count() == j.param_count(), name
        assert cfg.active_param_count() == j.active_param_count(), name
    if name in TIERS or name in ARCHS:
        assert get_config(name).param_count() == jcfg.param_count()


def test_param_count_is_the_models_for_the_zoo():
    """The count is exact for the port's modules too (the padded vocab
    aside, as in the JAX package)."""
    for name in ZOO:
        cfg = get_config(name).reduced()
        model = build_model(cfg, device="meta")
        n = sum(p.numel() for p in model.parameters())
        pad = common.padded_vocab(cfg.vocab_size) - cfg.vocab_size
        heads = 1 if cfg.tie_embeddings else 2
        assert n - heads * pad * cfg.d_model == cfg.param_count(), name


# ---------------------------------------------------------------------------
# forward, prefill cache and decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ZOO)
def test_zoo_forward_matches_jax(zoo, name):
    jm, tree, model, cfg = zoo(name)
    tokens, vision = _inputs(cfg, 2, 16, 1)
    jlogits = np.asarray(jax.jit(lambda p, bt: jm.forward(p, bt)[0])(
        tree, _batch(tokens, vision)))
    with torch.inference_mode():
        logits, cache = model(torch.from_numpy(tokens),
                              vision_embeds=_t(vision))
    v = 0 if vision is None else vision.shape[1]
    assert cache is None
    assert logits.shape == jlogits.shape == \
        (2, v + 16, common.padded_vocab(cfg.vocab_size))
    np.testing.assert_allclose(logits.numpy(), jlogits, **TOL)


@pytest.mark.parametrize("name", ZOO)
def test_zoo_prefill_cache_and_decode_match_jax(zoo, name, monkeypatch):
    """Prefill 12 tokens (after 16 vision embeddings for the VLM) into an
    f32 cache of 16 more slots, then 4 decode steps: the cache and each
    step's logits against JAX's, and (text-only configs) against JAX's
    teacher-forced forward. No capacity drops on either side, as
    tests/test_models.py runs it."""
    monkeypatch.setattr(jmoe, "CAPACITY_FACTOR", 100.0)
    monkeypatch.setattr(moe, "CAPACITY_FACTOR", 100.0)
    jm, tree, model, cfg = zoo(name)
    b, s, n = 2, 12, 4
    tokens, vision = _inputs(cfg, b, s + n, 2)
    v = 0 if vision is None else vision.shape[1]
    cache_len = v + s + 16
    _, jcache, _ = jax.jit(lambda p, bt: jm.forward(
        p, bt, collect_cache=True, cache_len=cache_len))(
            tree, _batch(tokens[:, :s], vision))
    with torch.inference_mode():
        _, cache = model(torch.from_numpy(tokens[:, :s]),
                         vision_embeds=_t(vision), collect_cache=True,
                         cache_len=cache_len)
    for i, entry in enumerate(cache):
        jentry = _jax_cache_entry(jcache, cfg, i)
        for key, value in entry.items():
            assert value.shape[1] == cache_len
            np.testing.assert_allclose(value.numpy(),
                                       np.asarray(jentry[key]), **TOL)
    jfull = None
    if vision is None:
        jfull = np.asarray(jax.jit(lambda p, t: jm.forward(
            p, {"tokens": t})[0])(tree, tokens))
    jdec = jax.jit(lambda *a: jm.decode_step(*a))
    for i in range(n):
        t = s + i
        pos = np.full((b,), v + t, np.int32)
        jlg, jcache = jdec(tree, tokens[:, t:t + 1], jcache, pos)
        with torch.inference_mode():
            lg, cache = model.decode_step(torch.from_numpy(tokens[:, t:t + 1]),
                                          cache, torch.from_numpy(pos).long())
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg),
                                   atol=DECODE_ATOL)
        if jfull is not None:
            np.testing.assert_allclose(lg.numpy()[:, 0], jfull[:, t],
                                       atol=DECODE_ATOL)


@pytest.mark.parametrize("name", ZOO)
def test_zoo_decode_over_the_default_bf16_cache_matches_jax(zoo, name,
                                                            monkeypatch):
    """Both sides' default caches (bf16 rings) under the f32 model, 8
    tokens decoded one at a time from an empty cache (text only): each
    step's logits against JAX's at the decode gate, the rings bf16 on both
    sides to the end."""
    monkeypatch.setattr(jmoe, "CAPACITY_FACTOR", 100.0)
    monkeypatch.setattr(moe, "CAPACITY_FACTOR", 100.0)
    jm, tree, model, cfg = zoo(name)
    b, s = 2, 8
    tokens, _ = _inputs(cfg, b, s, 3)
    jdec = jax.jit(lambda *a: jm.decode_step(*a))
    jcache = jm.init_cache(tree, b, s)
    with torch.inference_mode():
        cache = model.init_cache(b, s)
        for t in range(s):
            pos = np.full((b,), t, np.int32)
            lg, cache = model.decode_step(torch.from_numpy(tokens[:, t:t + 1]),
                                          cache, torch.from_numpy(pos).long())
            jlg, jcache = jdec(tree, tokens[:, t:t + 1], jcache, pos)
            assert lg.dtype == torch.float32
            np.testing.assert_allclose(lg.numpy(), np.asarray(jlg),
                                       atol=DECODE_ATOL)
    for i, entry in enumerate(cache):
        jentry = _jax_cache_entry(jcache, cfg, i)
        assert entry["k"].dtype == torch.bfloat16
        assert np.asarray(jentry["k"]).dtype == jnp.bfloat16
        np.testing.assert_allclose(entry["k"].float().numpy(),
                                   np.asarray(jentry["k"]).astype(np.float32),
                                   atol=DECODE_ATOL)


# ---------------------------------------------------------------------------
# the step factories
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mesh():
    # Auto axes: jax 0.9's default (Explicit) makes the JAX package's
    # head-sharded attention raise (see tests/test_torch_decode.py)
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _gap(hidden, table):
    logits = hidden[:, -1, :].astype(np.float64) @ table.T.astype(np.float64)
    top2 = np.sort(logits, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def _agree(conf, top1, jconf, jtop1, gap):
    np.testing.assert_allclose(conf.numpy(), np.asarray(jconf),
                               atol=CONF_ATOL)
    clear = gap > GAP
    assert clear.any()
    assert np.array_equal(top1.numpy()[clear], np.asarray(jtop1)[clear])


@pytest.mark.parametrize("name", ZOO)
def test_zoo_prefill_and_serve_steps_match_jax(zoo, mesh, name):
    """Prefill of 2 prompts of 20 tokens (after the VLM's vision
    embeddings), then 4 decode steps feeding back JAX's top-1, against the
    JAX package's step factories on a (1, 1) mesh, default capacity."""
    jm, tree, model, cfg = zoo(name)
    jprefill = jax.jit(jdist.make_prefill_step(jm, mesh))
    jserve = jax.jit(jdist.make_serve_step(jm, mesh, 2))
    table = tree["embed" if cfg.tie_embeddings else "lm_head"]["table"]
    tokens, vision = _inputs(cfg, 2, 20, 4)
    v = 0 if vision is None else vision.shape[1]
    prefill, serve = make_prefill_step(model), make_serve_step(model)
    with mesh:
        jconf, jtop1, jcache = jprefill(tree, _batch(tokens, vision))
    conf, top1, cache = prefill(torch.from_numpy(tokens),
                                vision_embeds=_t(vision))
    with torch.inference_mode():
        hidden, _ = model(torch.from_numpy(tokens), vision_embeds=_t(vision),
                          return_hidden=True)
    _agree(conf, top1, jconf, jtop1, _gap(hidden.numpy(), table))
    tok = np.array(jtop1)
    for i in range(4):
        pos = np.full((2,), v + 20 + i, np.int32)
        with mesh:
            jconf, jtop1, jcache = jserve(tree, tok[:, None], jcache, pos)
        with torch.inference_mode():
            hidden, _ = model.decode_step(
                torch.from_numpy(tok[:, None]),
                [{k: x.clone() for k, x in c.items()} for c in cache],
                torch.from_numpy(pos).long(), return_hidden=True)
        conf, top1, cache = serve(torch.from_numpy(tok[:, None]), cache,
                                  torch.from_numpy(pos).long())
        _agree(conf, top1, jconf, jtop1, _gap(hidden.numpy(), table))
        tok = np.array(jtop1)


# ---------------------------------------------------------------------------
# MoE at the default capacity, with drops
# ---------------------------------------------------------------------------
def _np_keep(ids, e, cap):
    """The JAX package's capacity rule, written out: the p-th assignment to
    an expert (token-major, then top-k slot) is kept iff p < cap."""
    seen = np.zeros(e, np.int64)
    keep = np.zeros(ids.size, bool)
    for i, x in enumerate(ids.reshape(-1)):
        keep[i] = seen[x] < cap
        seen[x] += 1
    return keep


def _moe_layer(cfg, seed):
    jp = jmoe.moe_init(KeyGen(jax.random.key(seed)), cfg, jnp.float32)
    jp = jax.tree.map(np.asarray, jp)
    p = moe.MoE(cfg, device="cpu", dtype=torch.float32)
    flat = {"router": jp["router"], "w_gate": jp["w_gate"],
            "w_up": jp["w_up"], "w_down": jp["w_down"]}
    if cfg.num_shared_experts:
        flat.update({f"shared.{k}": v for k, v in jp["shared"].items()})
    with torch.no_grad():
        for name, t in p.named_parameters():
            t.copy_(torch.from_numpy(np.array(flat.pop(name))))
    assert not flat
    return jp, p


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "granite-moe-1b-a400m"])
def test_moe_default_capacity_drops_match_jax(name):
    """Tokens pulled toward one expert, so that it gets more assignments
    than its capacity: JAX drops some (asserted), and the port drops the
    same ones, gives the same output on every token whose routing and kept
    assignments agree, and the same aux loss."""
    cfg = get_config(name).reduced()
    jp, p = _moe_layer(cfg, 5)
    b, s, d = 2, 32, cfg.d_model
    rng = np.random.default_rng(7)
    toward = jp["router"][:, 0] / np.linalg.norm(jp["router"][:, 0])
    x = (rng.standard_normal((b, s, d)) + 4.0 * toward).astype(np.float32)
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), cfg, LOCAL,
                              return_aux=True)
    jgates, jids, jprobs = map(np.asarray, jmoe._route(
        jnp.asarray(x.reshape(-1, d)), jp["router"], cfg))
    cap = moe.capacity(b * s, cfg)
    assert cap == max(int(jmoe.CAPACITY_FACTOR * b * s
                          * cfg.num_experts_per_tok / cfg.num_experts), 8)
    jkeep = _np_keep(jids, cfg.num_experts, cap)
    assert (~jkeep).sum() > 0, "the case must drop assignments"

    with torch.inference_mode():
        y, aux = moe.moe_apply(p, torch.from_numpy(x), cfg, return_aux=True)
        gates, ids, probs = moe.route(torch.from_numpy(x.reshape(-1, d)),
                                      p.router, cfg)
        _, _, keep = moe.dispatch(ids, cfg.num_experts, cap)
    ids, keep = ids.numpy(), keep.numpy()
    k = cfg.num_experts_per_tok
    srt = np.sort(jprobs, axis=-1)[:, ::-1]
    clear = srt[:, k - 1] - srt[:, k] > ROUTE_GAP
    near_ties = int((~clear).sum())
    print(f"{name}: {int((~jkeep).sum())} of {jkeep.size} assignments "
          f"dropped, {near_ties} near-tie tokens")
    assert np.array_equal(np.sort(ids[clear], -1), np.sort(jids[clear], -1))
    agree = (ids == jids).all(-1) & \
        (keep == jkeep).reshape(-1, k).all(-1)
    assert agree.sum() >= clear.sum() - near_ties
    np.testing.assert_allclose(probs.numpy(), jprobs, atol=1e-6)
    np.testing.assert_allclose(gates.numpy()[agree], jgates[agree],
                               atol=1e-6)
    np.testing.assert_allclose(y.numpy().reshape(-1, d)[agree],
                               np.asarray(jy).reshape(-1, d)[agree],
                               atol=MOE_ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_RTOL)


def test_moe_no_drop_matches_the_dense_mixture():
    """With room for every assignment, the routed output is the dense
    top-k mixture of the experts plus the shared expert (the JAX package's
    test_moe_routes_topk_and_drops_within_capacity, on the port)."""
    cfg = get_config("deepseek-moe-16b").reduced()
    _, p = _moe_layer(cfg, 0)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32))
    with torch.inference_mode():
        y = moe.moe_apply(p, x, cfg)
        xf = x.reshape(-1, cfg.d_model)
        gates, ids, _ = moe.route(xf, p.router, cfg)
        ref = torch.zeros_like(xf)
        for e in range(cfg.num_experts):
            oe = (torch.nn.functional.silu(xf @ p.w_gate[e])
                  * (xf @ p.w_up[e])) @ p.w_down[e]
            ref += oe * torch.where(ids == e, gates, 0.0).sum(-1)[:, None]
        ref += p.shared(xf, "silu")
    torch.testing.assert_close(y.reshape(-1, cfg.d_model), ref, atol=1e-5,
                               rtol=0)


def test_moe_dispatch_is_token_major_and_drops_past_capacity():
    ids = torch.tensor([[0, 1], [0, 2], [0, 1], [1, 0]])
    expert, row, keep = moe.dispatch(ids, 3, 2)
    assert keep.tolist() == [True, True, True, True, False, True, False,
                             False]
    assert expert.tolist() == [0, 1, 0, 2, 3, 1, 3, 3]
    assert row.tolist() == [0, 0, 1, 0, 0, 1, 0, 0]


# ---------------------------------------------------------------------------
# M-RoPE and the VLM positions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hd,sections", [(128, (16, 24, 24)),
                                         (64, (8, 12, 12)), (32, (6, 5, 5))])
def test_apply_mrope_matches_jax(hd, sections):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 40, 3, hd)).astype(np.float32)
    pos3 = np.array(jtransformer.vlm_positions(2, 25, 15))
    out = common.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                             1e6, sections)
    ref = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6,
                              sections)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=MROPE_ATOL)
    # equal ids on the three axes are plain RoPE, bit for bit
    flat = torch.arange(40).expand(2, 40)
    assert torch.equal(
        common.apply_mrope(torch.from_numpy(x), flat.expand(3, 2, 40), 1e6,
                           sections),
        common.apply_rope(torch.from_numpy(x), flat, 1e6))
    with pytest.raises(ValueError, match="sections"):
        common.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), 1e6,
                           (1, 2, 3))


@pytest.mark.parametrize("v,s", [(16, 12), (10, 5), (1, 3), (1024, 7)])
def test_vlm_positions_equal_jax(v, s):
    pos = transformer.vlm_positions(3, v, s)
    assert np.array_equal(pos.numpy(),
                          np.asarray(jtransformer.vlm_positions(3, v, s)))


# ---------------------------------------------------------------------------
# the converter and the initialiser on MoE layouts
# ---------------------------------------------------------------------------
def test_converter_maps_prefix_blocks_and_shared_experts(zoo):
    _, tree, model, cfg = zoo("deepseek-moe-16b")
    assert cfg.first_dense_layers == 1 and cfg.num_layers == 2
    assert np.array_equal(model.layers[0].mlp.w_gate.numpy(),
                          tree["prefix"][0]["mlp"]["w_gate"])
    blk = tree["blocks"][0]["moe"]
    assert np.array_equal(model.layers[1].moe.router.numpy(),
                          blk["router"][0])
    assert np.array_equal(model.layers[1].moe.shared.w_up.numpy(),
                          blk["shared"]["w_up"][0])
    assert np.array_equal(model.layers[1].moe.w_down.numpy(),
                          blk["w_down"][0])
    assert not hasattr(model.layers[0], "moe")
    assert not hasattr(model.layers[1], "mlp")


def test_init_params_keeps_the_router_f32():
    cfg = get_config("granite-moe-1b-a400m").reduced()
    m = init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                    dtype=torch.bfloat16)
    for name, p in m.named_parameters():
        want = torch.float32 if name.endswith("router") else torch.bfloat16
        assert p.dtype == want, name
        if not name.endswith("scale"):
            assert p.float().std() > 0, name
    x = torch.randint(0, cfg.vocab_size, (1, 6))
    with torch.inference_mode():
        logits, _ = m(x)
    assert logits.dtype == torch.bfloat16 and torch.isfinite(
        logits[..., :cfg.vocab_size].float()).all()

