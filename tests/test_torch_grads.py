"""The port's gradients held to the JAX package on the CPU.

``Model.loss`` differentiated by autograd against ``jax.grad`` of the JAX
``Model.loss`` on the same weights and batch, for tier-low (dense),
granite-moe-1b-a400m (MoE with its aux loss), RecurrentGemma (the RG-LRU
scan's gradient through the plain loop, a window crossed) and Qwen2-VL
(the vision prefix dropped from the loss), all at ``reduced()`` size;
the port's ``launch.distributed.make_train_step`` against the JAX one on
a (1, 1) mesh; the plain backward of flash attention and of the scan
against autograd of their plain forwards; the grad guard of the kernel
wrappers.

Tolerances: each leaf's gradient within 1e-4 of that leaf's max |g|
(float32 sums in another order); the loss within 1e-5 relative; the
train step's metrics 1e-5 relative, its first moments (0.1 clip g) 1e-4
of a leaf's max and its parameters within 2 lr of JAX's (Adam's first
step moves a parameter by about lr sign(g), so a gradient near zero may
move the two apart by up to 2 lr); the flash backward 1e-5 of max |ref|
(float32, the same formulas in another order); the scan's backward
bitwise (the same rounded operations).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import distributed as jdist
from repro.models.model import build_model as jbuild_model
from repro.training import optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (attention_lse_plain,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_plain)
from repro_torch.kernels.rglru_scan import (rglru_scan_bwd_plain,
                                            rglru_scan_plain)
from repro_torch.launch import distributed as dist
from repro_torch.models.model import _jax_location, params_from_jax
from repro_torch.training import optimizer as opt
from repro_torch.training.trainer import trainable

torch.set_num_threads(2)

GRAD_TOL = 1e-4
LOSS_RTOL = 1e-5
FLASH_BWD_TOL = 1e-5

# (arch, reduced, B, S): RecurrentGemma's S crosses its reduced window
CASES = {"tier-low": (False, 2, 16), "granite-moe-1b-a400m": (True, 2, 16),
         "recurrentgemma-9b": (True, 2, 136), "qwen2-vl-7b": (True, 2, 12)}


def _cfgs(name):
    reduced = CASES[name][0]
    jcfg, cfg = jget_config(name), get_config(name)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    assert repr(cfg) == repr(jcfg)
    return jcfg, cfg


@pytest.fixture(scope="module")
def built():
    cache = {}

    def get(name):
        if name not in cache:
            jcfg, cfg = _cfgs(name)
            jm = jbuild_model(jcfg)
            tree = jax.tree.map(np.asarray, jm.init(
                jax.random.key(list(CASES).index(name))))
            cache[name] = (jm, tree, cfg)
        return cache[name]

    return get


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((b, 1), -100, np.int32)],
                            axis=1)
    labels[0, :3] = -100                   # some ignored positions
    batch = {"tokens": tokens, "labels": labels}
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _jax_leaf(tree, name, cfg):
    path, layer, _ = _jax_location(name, cfg)
    leaf = tree
    for key in path:
        leaf = leaf[key]
    leaf = np.asarray(leaf)
    return leaf if layer < 0 else leaf[layer]


def _leaf_err(got, ref):
    ref = np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    return np.abs(np.asarray(got, np.float64) - ref).max() / (
        scale if scale > 0 else 1.0)


def _check_grads(model, grads, jgrads, cfg):
    n = 0
    for name, _ in model.named_parameters():
        err = _leaf_err(grads[name].numpy(), _jax_leaf(jgrads, name, cfg))
        assert err <= GRAD_TOL, (name, err)
        n += 1
    return n


@pytest.mark.parametrize("name", list(CASES))
def test_loss_gradients_match_jax(built, name):
    jm, tree, cfg = built(name)
    _, b, s = CASES[name]
    batch = _batch(cfg, b, s, 1)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, bt: jm.loss(p, bt), has_aux=True))(tree, batch)

    model = params_from_jax(tree, cfg, device="cpu")
    params = trainable(model)
    vision = batch.get("vision_embeds")
    loss, met = model.loss(
        torch.from_numpy(batch["tokens"]), torch.from_numpy(batch["labels"]),
        vision_embeds=None if vision is None else torch.from_numpy(vision))
    gs = torch.autograd.grad(loss, list(params.values()))
    grads = dict(zip(params, gs))
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert float(met["aux"].detach()) == pytest.approx(float(jmet["aux"]),
                                              rel=LOSS_RTOL, abs=1e-7)
    if cfg.is_moe:
        assert float(met["aux"].detach()) > 0
    assert _check_grads(model, grads, jgrads, cfg) == len(params)


def test_remat_gives_the_same_gradients(built):
    """Per-layer checkpointing on the CPU: the recompute repeats the
    forward, so the gradients are bitwise those of no remat."""
    jm, tree, cfg = built("granite-moe-1b-a400m")
    batch = _batch(cfg, 2, 16, 2)
    out = []
    for remat in (False, True):
        model = params_from_jax(tree, cfg, device="cpu")
        params = trainable(model)
        loss, _ = model.loss(torch.from_numpy(batch["tokens"]),
                             torch.from_numpy(batch["labels"]), remat=remat)
        out.append(torch.autograd.grad(loss, list(params.values())))
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def mesh():
    # Auto axes: jax 0.9's default (Explicit) makes the JAX package's
    # head-sharded attention raise (see tests/test_torch_decode.py)
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


@pytest.mark.parametrize("name,accum", [("tier-low", 1),
                                        ("granite-moe-1b-a400m", 1),
                                        ("granite-moe-1b-a400m", 2)])
def test_train_step_matches_jax(built, mesh, name, accum):
    """One step of the port's ``make_train_step`` (remat on) against the
    JAX package's on a (1, 1) mesh from the same weights and batch."""
    jm, tree, cfg = built(name)
    batch = _batch(cfg, 4, 16, 3)
    jcfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20)
    jstep = jax.jit(jdist.make_train_step(jm, mesh, remat=True,
                                          accum_steps=accum, adamw=jcfg))
    with mesh:
        jparams, jstate, jmet = jstep(tree, jopt.init(tree), batch)

    model = params_from_jax(tree, cfg, device="cpu")
    step = dist.make_train_step(model, remat=True, accum_steps=accum,
                                adamw=opt.AdamWConfig(
                                    **dataclasses.asdict(jcfg)))
    state, met = step(opt.init(trainable(model)), batch)
    for key in ("loss", "ce", "aux", "grad_norm", "lr"):
        assert float(met[key]) == pytest.approx(
            float(jmet[key]), rel=LOSS_RTOL, abs=1e-7), key
    lr = float(met["lr"])
    for pname, p in model.named_parameters():
        mu = _jax_leaf(jstate["mu"], pname, cfg)
        assert _leaf_err(state["mu"][pname].numpy(), mu) <= GRAD_TOL, pname
        ref = _jax_leaf(jparams, pname, cfg)
        assert np.abs(p.detach().numpy() - ref).max() <= 2 * lr + 1e-7, pname
    assert int(state["step"]) == int(jstate["step"]) == 1


def test_head_ce_is_cross_entropy_of_the_padded_head():
    """The one-card vocab-parallel CE equals the CE of the head's logits
    (padding at finfo.min) and ignores -100 labels."""
    from repro_torch.models.common import cross_entropy, lm_head_apply
    gen = torch.Generator().manual_seed(0)
    hidden = torch.randn(2, 5, 16, generator=gen)
    table = torch.randn(128, 16, generator=gen)
    labels = torch.randint(0, 100, (2, 5), generator=gen)
    labels[1, 2:] = -100
    got = dist.head_ce(hidden, table, labels, 100)
    ref = cross_entropy(lm_head_apply(table, hidden, 100), labels, 100)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=0)
    assert dist.default_accum_steps(3e10, 64, 4) == 8
    assert dist.default_accum_steps(1e9, 64, 4) == 1
    assert dist.default_accum_steps(5e9, 4, 4) == 1


# ---------------------------------------------------------------------------
# the kernels' plain backwards
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,s,t,h,kv,hd,causal,window", [
    (2, 19, None, 4, 4, 16, True, None),      # causal, MHA
    (2, 40, None, 8, 2, 32, True, 7),         # GQA, window
    (1, 33, None, 16, 1, 64, True, 32),       # one KV head for 16
    (2, 24, None, 4, 2, 16, False, None),     # non-causal, T = S
    (2, 11, 29, 4, 2, 16, False, None),       # non-causal over T != S
    (1, 30, 9, 6, 3, 8, False, None),
])
def test_flash_bwd_plain_matches_autograd(b, s, t, h, kv, hd, causal, window):
    gen = torch.Generator().manual_seed(s * 7 + hd)
    t = t or s
    q = torch.randn(b, s, h, hd, generator=gen, requires_grad=True)
    k = torch.randn(b, t, kv, hd, generator=gen, requires_grad=True)
    v = torch.randn(b, t, kv, hd, generator=gen, requires_grad=True)
    do = torch.randn(b, s, h, hd, generator=gen)
    o = flash_attention_plain(q, k, v, causal=causal, window=window)
    ref = torch.autograd.grad(o, (q, k, v), do)
    with torch.no_grad():
        lse = attention_lse_plain(q, k, causal=causal, window=window)
        got = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                        window=window)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    for name, g, r in zip("qkv", got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        err = float((g - r).abs().max() / r.abs().max())
        assert err <= FLASH_BWD_TOL, (name, err)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,s,d", [(2, 37, 24), (1, 1, 8), (3, 5, 33)])
def test_rglru_bwd_plain_is_autograd_bitwise(b, s, d, with_h0):
    gen = torch.Generator().manual_seed(b * 100 + s)
    a = (torch.rand(b, s, d, generator=gen) * 0.5 + 0.499).requires_grad_()
    u = torch.randn(b, s, d, generator=gen, requires_grad=True)
    h0 = torch.randn(b, d, generator=gen, requires_grad=True) \
        if with_h0 else None
    dh = torch.randn(b, s, d, generator=gen)
    h = rglru_scan_plain(a, u, h0)
    ins = (a, u) + ((h0,) if with_h0 else ())
    ref = torch.autograd.grad(h, ins, dh)
    da, du, dh0 = rglru_scan_bwd_plain(a.detach(), h.detach(), dh,
                                       None if h0 is None else h0.detach())
    assert torch.equal(da, ref[0]) and torch.equal(du, ref[1])
    if with_h0:
        assert torch.equal(dh0, ref[2])
    else:
        assert dh0 is None


def test_grad_guard_sees_grad_mode_and_requires_grad():
    """What the CUDA wrappers test before a launch: autograd would record
    the call only with grad mode on and an input that requires grad."""
    x = torch.zeros(2, requires_grad=True)
    y = torch.zeros(2)
    assert _build.wants_grad(y, x) and not _build.wants_grad(y, None)
    with torch.no_grad():
        assert not _build.wants_grad(x)
    with torch.inference_mode():
        assert not _build.wants_grad(x)
    with pytest.raises(RuntimeError, match="no backward"):
        _build.refuse_grad("bvsb", x)
    _build.refuse_grad("bvsb", y)
    with torch.no_grad():
        _build.refuse_grad("bvsb", x)
