"""Soft-capped attention in the port held to the JAX package on the CPU.

The JAX package applies s <- c tanh(s / c) to the scaled scores, before
the mask, wherever ``cfg.logit_soft_cap`` (or ``soft_cap``) is set: in
``dense_attention``, ``windowed_attention``, ``chunked_attention`` and
``attn_decode``; an encoder's self-attention and every cross-attention
take none. The port's plain versions (what the CPU runs and what the card
holds its kernels to) take the same ``soft_cap``.

The inputs are scaled so that the scores reach the cap's curved part
(|s| of order c), else a cap of 30 or 50 would change nothing a test can
see; each test also shows that the cap moves its output by far more than
its tolerance (by 100 times, or 10 times for an attention layer's
output, which the small output projection scales down).

Tolerances: attention outputs and the lse 1e-5 absolute (float32 einsums
and softmax sums in another order, outputs of order 1); gradients 1e-5 of
the largest (max |err| over max |ref|, as tests/test_torch_grads.py holds
the uncapped backward); attention-layer and model outputs 1e-4 (float32
matmuls); model loss 1e-5 relative and each gradient leaf 1e-4 of its max
|g|, as tests/test_torch_grads.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models.common import KeyGen
from repro.models.model import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import (attention_lse_plain,
                                                 cap_operand,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_plain)
from repro_torch.models import attention
from repro_torch.models.model import _jax_location, params_from_jax
from repro_torch.training.trainer import trainable

torch.set_num_threads(2)

ATOL = 1e-5
GRAD_RTOL = 1e-5
LAYER_TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-4
CAPS = [30.0, 50.0]
# q and k are drawn at this scale, so that hd-dimensional scores reach
# the order of the cap
QK_SCALE = 4.0


def _qkv(b, s, t, h, kv, hd, seed):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, s, h, hd)) * QK_SCALE).astype(np.float32)
    k = (rng.standard_normal((b, t, kv, hd)) * QK_SCALE).astype(np.float32)
    v = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    return q, k, v


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _close(got, ref, atol=ATOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), atol=atol,
                               rtol=0)


def _moved(capped, uncapped, by=100 * ATOL):
    """The cap changes the output by far more than the tolerance."""
    assert float(np.abs(np.asarray(capped) - np.asarray(uncapped)).max()) > by


# ---------------------------------------------------------------------------
# attention_core's three JAX paths
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("b,s,h,kv,hd,window", [
    (2, 40, 8, 2, 32, None), (2, 40, 8, 2, 32, 7), (1, 96, 16, 1, 64, 33),
    (2, 24, 4, 4, 16, None)])
def test_attention_core_dense_path_matches_jax(cap, b, s, h, kv, hd, window):
    """T <= DENSE_MAX: JAX's ``dense_attention`` with the cap."""
    q, k, v = _qkv(b, s, s, h, kv, hd, s + hd)
    out = attention.attention_core(*_t(q, k, v), window=window, soft_cap=cap)
    ref = jattn.attention_core(q, k, v, causal=True, window=window,
                               soft_cap=cap)
    _close(out, ref)
    _moved(out, jattn.attention_core(q, k, v, causal=True, window=window))
    assert torch.equal(out, ops.flash_attention(*_t(q, k, v), window=window,
                                                soft_cap=cap))


@pytest.mark.parametrize("cap", CAPS)
def test_attention_core_windowed_path_matches_jax(cap):
    """T > DENSE_MAX and S > window + Q_BLOCK: JAX's
    ``windowed_attention`` (a query block over a static KV slice), with
    the cap."""
    s, window = 1536, 256
    assert s > jattn.DENSE_MAX and s > window + jattn.Q_BLOCK
    q, k, v = _qkv(1, s, s, 2, 1, 16, 7)
    out = attention.attention_core(*_t(q, k, v), window=window, soft_cap=cap)
    ref = jattn.attention_core(q, k, v, causal=True, window=window,
                               soft_cap=cap)
    _close(out, ref)
    _moved(out, jattn.windowed_attention(q, k, v, window=window))


@pytest.mark.parametrize("cap", CAPS)
def test_attention_core_chunked_non_causal_other_keys_matches_jax(cap):
    """T != S past DENSE_MAX keys, non-causal (an encoder-decoder's
    cross-attention shape): JAX's ``chunked_attention`` with the cap."""
    q, k, v = _qkv(2, 8, 2048, 4, 2, 16, 9)
    out = attention.attention_core(*_t(q, k, v), causal=False, soft_cap=cap)
    ref = jattn.attention_core(q, k, v, causal=False, soft_cap=cap)
    _close(out, ref)
    _moved(out, jattn.attention_core(q, k, v, causal=False))


# window + Q_BLOCK >= S > DENSE_MAX: JAX's windowed_attention falls back to
# dense_attention without passing the cap on
DIVERGENT = dict(s=1536, window=1024)


@pytest.mark.parametrize("cap", CAPS)
def test_attention_core_caps_where_jax_windowed_falls_back(cap):
    """At window + 512 >= S > 1,024 the port caps, as ``dense_attention``
    with the cap does (JAX's ``attention_core`` does not: next test)."""
    s, window = DIVERGENT["s"], DIVERGENT["window"]
    q, k, v = _qkv(1, s, s, 2, 1, 16, 11)
    out = attention.attention_core(*_t(q, k, v), window=window, soft_cap=cap)
    _close(out, jattn.dense_attention(q, k, v, causal=True, window=window,
                                      soft_cap=cap))


def test_jax_attention_core_drops_the_cap_there():
    """The divergence on record: JAX's ``attention_core`` at window + 512
    >= S > 1,024 equals the uncapped ``dense_attention``, and differs from
    the capped one."""
    s, window, cap = DIVERGENT["s"], DIVERGENT["window"], 30.0
    assert jattn.DENSE_MAX < s <= window + jattn.Q_BLOCK
    q, k, v = _qkv(1, s, s, 2, 1, 16, 11)
    got = np.asarray(jattn.attention_core(q, k, v, causal=True, window=window,
                                          soft_cap=cap))
    _close(got, jattn.dense_attention(q, k, v, causal=True, window=window))
    _moved(got, jattn.dense_attention(q, k, v, causal=True, window=window,
                                      soft_cap=cap))


# ---------------------------------------------------------------------------
# the lse and the backward
# ---------------------------------------------------------------------------
def _jax_capped_scores(q, k, causal, window, cap):
    """JAX's capped, masked scores (B, KV, G, S, T), as ``dense_attention``
    forms them."""
    hd = q.shape[-1]
    sc = jattn._gqa_scores(q, k, 1.0 / jnp.sqrt(hd).astype(jnp.float32))
    sc = jnp.tanh(sc / cap) * cap
    return sc + jattn._mask_bias(jnp.arange(q.shape[1]),
                                 jnp.arange(k.shape[1]), causal, window)


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("b,s,t,h,kv,hd,causal,window", [
    (2, 40, None, 8, 2, 32, True, None), (1, 33, None, 16, 1, 64, True, 9),
    (2, 11, 29, 4, 2, 16, False, None)])
def test_attention_lse_plain_matches_jax(cap, b, s, t, h, kv, hd, causal,
                                         window):
    q, k, _ = _qkv(b, s, t or s, h, kv, hd, s * hd)
    lse = attention_lse_plain(*_t(q, k), causal=causal, window=window,
                              soft_cap=cap)
    ref = jax.nn.logsumexp(_jax_capped_scores(q, k, causal, window, cap),
                           axis=-1).reshape(b, h, s)
    assert lse.shape == (b, h, s)
    _close(lse, ref)


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("b,s,t,h,kv,hd,causal,window", [
    (2, 40, None, 8, 2, 32, True, None),      # GQA
    (1, 48, None, 16, 1, 64, True, 13),       # one KV head for 16, window
    (2, 24, None, 4, 4, 16, True, 5),         # MHA, window
    (2, 11, 29, 4, 2, 16, False, None),       # non-causal over T != S
    (1, 30, 9, 6, 3, 8, False, None)])
def test_flash_bwd_plain_matches_jax_grad(cap, b, s, t, h, kv, hd, causal,
                                          window):
    """dq, dk, dv of ``flash_attention_bwd_plain`` on the forward's output
    and lse against ``jax.vjp`` of ``dense_attention`` with the cap."""
    q, k, v = _qkv(b, s, t or s, h, kv, hd, s * 3 + hd)
    do = np.random.default_rng(s).standard_normal(q.shape).astype(np.float32)
    tq, tk, tv, tdo = _t(q, k, v, do)
    o = flash_attention_plain(tq, tk, tv, causal=causal, window=window,
                              soft_cap=cap)
    lse = attention_lse_plain(tq, tk, causal=causal, window=window,
                              soft_cap=cap)
    got = flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal=causal,
                                    window=window, soft_cap=cap)
    out, vjp = jax.vjp(lambda *a: jattn.dense_attention(
        *a, causal=causal, window=window, soft_cap=cap), q, k, v)
    _close(o, out)
    ref = vjp(jnp.asarray(do))
    for name, g, r in zip("qkv", got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape
        err = float(np.abs(g.numpy() - r).max() / np.abs(r).max())
        assert err <= GRAD_RTOL, (name, err)
    # the cap's derivative matters: without it dq moves far
    plain = flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal=causal,
                                      window=window)
    _moved(plain[0], got[0], by=100 * GRAD_RTOL * float(got[0].abs().max()))


@pytest.mark.parametrize("cap", CAPS)
def test_flash_plain_autograd_equals_the_plain_backward(cap):
    """On the CPU autograd differentiates ``flash_attention_plain``; the
    plain backward (the card's reference) gives the same gradients."""
    q, k, v = _qkv(2, 40, 40, 8, 2, 32, 3)
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    do = torch.randn(tq.shape, generator=torch.Generator().manual_seed(0))
    o = ops.flash_attention(tq, tk, tv, window=9, soft_cap=cap)
    ref = torch.autograd.grad(o, (tq, tk, tv), do)
    with torch.no_grad():
        lse = attention_lse_plain(tq, tk, window=9, soft_cap=cap)
        got = flash_attention_bwd_plain(tq, tk, tv, o, lse, do, window=9,
                                        soft_cap=cap)
    for g, r in zip(got, ref):
        assert float((g - r).abs().max() / r.abs().max()) <= GRAD_RTOL


def test_a_cap_of_none_or_zero_is_no_cap_and_negative_raises():
    q, k, v = _t(*_qkv(1, 20, 20, 4, 2, 16, 0))
    base = flash_attention_plain(q, k, v)
    assert torch.equal(flash_attention_plain(q, k, v, soft_cap=0), base)
    assert torch.equal(ops.flash_attention(q, k, v, soft_cap=None), base)
    lens = torch.tensor([20])
    assert torch.equal(decode_attention_plain(q[:, 0], k, v, lens, 0),
                       decode_attention_plain(q[:, 0], k, v, lens))
    assert cap_operand(None) == cap_operand(0) == 0.0
    assert cap_operand(50) == 50.0
    with pytest.raises(ValueError, match="positive"):
        cap_operand(-1.0)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("b,h,kvh,hd,w,lengths", [
    (3, 16, 1, 64, 96, [1, 50, 96]), (2, 8, 2, 32, 40, [40, 7])])
def test_decode_attention_plain_matches_jax_attn_decode_core(cap, b, h, kvh,
                                                             hd, w, lengths):
    """Against the softmax of JAX's ``attn_decode`` with a cap: scaled
    scores, c tanh(s / c), the invalid slots at NEG_INF."""
    rng = np.random.default_rng(w + hd)
    q = (rng.standard_normal((b, h, hd)) * QK_SCALE).astype(np.float32)
    k = (rng.standard_normal((b, w, kvh, hd)) * QK_SCALE).astype(np.float32)
    v = rng.standard_normal((b, w, kvh, hd)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    out = decode_attention_plain(*_t(q, k, v, lens), soft_cap=cap)
    sc = jattn._gqa_scores(q[:, None], k,
                           1.0 / jnp.sqrt(hd).astype(jnp.float32))
    sc = jnp.tanh(sc / cap) * cap
    valid = jnp.arange(w)[None, :] < lens[:, None]
    sc = jnp.where(valid[:, None, None, None, :], sc, jattn.NEG_INF)
    ref = jattn._gqa_out(jax.nn.softmax(sc, axis=-1), v, jnp.float32)[:, 0]
    _close(out, ref)
    _moved(out, decode_attention_plain(*_t(q, k, v, lens)))
    assert torch.equal(ops.decode_attention(*_t(q, k, v, lens), soft_cap=cap),
                       out)


@pytest.fixture(scope="module")
def capped_layer():
    """(cfg, JAX attention params, the port's Attention holding them) of
    the reduced RecurrentGemma's local attention, window 16, with the
    queries' projection scaled up so that the scores reach the cap."""
    cfg = get_config("recurrentgemma-9b").reduced().with_(local_attn_window=16)
    jp = jattn.attn_init(KeyGen(jax.random.key(5)), cfg, jnp.float32)
    jp = {k: np.array(v) for k, v in jp.items()}
    jp["wq"] = jp["wq"] * 40.0
    p = attention.Attention(cfg, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for name, t in p.named_parameters():
            t.copy_(torch.from_numpy(jp[name]))
    return cfg, jp, p


@pytest.mark.parametrize("cap", CAPS)
def test_attn_decode_with_a_cap_matches_jax_over_the_ring(capped_layer, cap):
    """30 steps over a ring of 16 slots, before and after it wraps, the
    requests 5 positions apart: outputs and caches against JAX's
    ``attn_decode`` under ``logit_soft_cap``."""
    base, jp, p = capped_layer
    cfg = base.with_(logit_soft_cap=cap)
    w, b = 16, 2
    rng = np.random.default_rng(int(cap))
    cache = attention.init_kv_cache(b, w, cfg, torch.float32)
    free = attention.init_kv_cache(b, w, base, torch.float32)
    jcache = jattn.init_kv_cache(b, w, cfg, jnp.float32)
    jstep = jax.jit(lambda p_, x, c, pos: jattn.attn_decode(
        p_, x, c, pos, cfg, window=w))
    moved = 0.0
    for t in range(30):
        x1 = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        pos = np.array([t, t + 5], np.int32)
        tpos = torch.from_numpy(pos).long()
        out, cache = attention.attn_decode(p, torch.from_numpy(x1), cache,
                                           tpos, cfg)
        uncapped, free = attention.attn_decode(p, torch.from_numpy(x1), free,
                                               tpos, base)
        jout, jcache = jstep(jp, x1, jcache, pos)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **LAYER_TOL)
        np.testing.assert_allclose(cache["k"].numpy(),
                                   np.asarray(jcache["k"]), **LAYER_TOL)
        moved = max(moved, float((out - uncapped).abs().max()))
    assert moved > 10 * LAYER_TOL["atol"]


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------
# gemma-7b cut to the JAX package's reduced size with Gemma 2's attention
# soft cap; weights drawn at INIT_SCALE so that the scores reach the cap
# (the default 0.02 leaves them far below it; at 0.25 float32 reorderings
# alone move the reduced seamless's logits by 8e-4, with or without a cap,
# and at 0.15 by 1.3e-4)
INIT_SCALE = 0.1


def _capped(getter, arch, cap):
    return getter(arch).reduced().with_(logit_soft_cap=cap,
                                        init_scale=INIT_SCALE)


def _jax_leaf(tree, name, cfg):
    path, layer, _ = _jax_location(name, cfg)
    leaf = tree
    for key in path:
        leaf = leaf[key]
    leaf = np.asarray(leaf)
    return leaf if layer < 0 else leaf[layer]


@pytest.mark.parametrize("cap", [50.0])
def test_capped_decoder_loss_and_gradients_match_jax(cap):
    """A reduced capped gemma-7b: ``Model.loss`` and its gradients against
    JAX's ``Model.loss`` and ``jax.grad``, and the forward logits."""
    jcfg, cfg = _capped(jget_config, "gemma-7b", cap), \
        _capped(get_config, "gemma-7b", cap)
    assert repr(cfg) == repr(jcfg)
    jm = jbuild_model(jcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(2)))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((2, 1), -100, np.int32)],
                            axis=1)
    batch = {"tokens": tokens, "labels": labels}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, bt: jm.loss(p, bt), has_aux=True))(tree, batch)
    jlogits = jax.jit(lambda p, t: jm.forward(p, {"tokens": t})[0])(tree,
                                                                   tokens)

    model = params_from_jax(tree, cfg, device="cpu")
    params = trainable(model)
    loss, _ = model.loss(torch.from_numpy(tokens), torch.from_numpy(labels))
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    for name, g in grads.items():
        ref = np.asarray(_jax_leaf(jgrads, name, cfg), np.float64)
        err = np.abs(g.numpy() - ref).max() / max(np.abs(ref).max(), 1e-30)
        assert err <= LEAF_TOL, (name, err)
    with torch.inference_mode():
        logits = model(torch.from_numpy(tokens))[0]
        free = params_from_jax(tree, cfg.with_(logit_soft_cap=None),
                               device="cpu")(torch.from_numpy(tokens))[0]
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LAYER_TOL)
    assert float((logits - free).abs().max()) > 100 * LAYER_TOL["atol"]


def test_capped_encoder_decoder_matches_jax():
    """A reduced seamless-m4t-medium with a cap: the encoder output and
    the forward logits against JAX's, whose encoder self-attention and
    cross-attention take no cap. The encoder output equals the uncapped
    model's bit for bit, and the logits differ from it (the decoder's
    self-attention is capped)."""
    arch, cap = "seamless-m4t-medium", 30.0
    jcfg, cfg = _capped(jget_config, arch, cap), _capped(get_config, arch, cap)
    assert repr(cfg) == repr(jcfg)
    jm = jbuild_model(jcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(4)))
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    audio = rng.standard_normal((2, cfg.audio_frames, cfg.d_model)) \
        .astype(np.float32)
    model = params_from_jax(tree, cfg, device="cpu")
    free = params_from_jax(tree, cfg.with_(logit_soft_cap=None), device="cpu")
    with torch.inference_mode():
        enc = model.encode(torch.from_numpy(audio))
        logits, _ = model(torch.from_numpy(tokens),
                          audio_embeds=torch.from_numpy(audio))
        assert torch.equal(enc, free.encode(torch.from_numpy(audio)))
        free_logits, _ = free(torch.from_numpy(tokens),
                              audio_embeds=torch.from_numpy(audio))
    np.testing.assert_allclose(enc.numpy(),
                               np.asarray(jencdec.encode(tree, jcfg, audio)),
                               **LAYER_TOL)
    jlogits = jax.jit(lambda p, bt: jm.forward(p, bt)[0])(
        tree, {"tokens": tokens, "audio_embeds": audio})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LAYER_TOL)
    assert float((logits - free_logits).abs().max()) > 100 * LAYER_TOL["atol"]
