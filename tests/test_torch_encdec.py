"""The port's encoder-decoder (seamless-m4t-medium at ``reduced()`` size)
and its cross-attention held to the JAX package on the CPU.

The audio frames are seeded numpy embeddings (B, F, d), as in
tests/test_models.py; JAX's weights are carried across by
``params_from_jax``.

Tolerances: attention over keys of another length, the encoder output,
the forward logits and the prefill caches 1e-4 absolute and relative
(float32 einsums and softmax sums in another order); decode steps 5e-3,
as tests/test_models.py and the port's other decode tests gate decode;
the step factories' BvSB 1e-6 and top-1 equal wherever JAX's top-2 logit
gap exceeds 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import distributed as jdist
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models.common import KeyGen
from repro.models.model import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.launch.distributed import make_prefill_step, make_serve_step
from repro_torch.models import attention, common
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.model import build_model, init_params, params_from_jax

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-4)
DECODE_ATOL = 5e-3
CONF_ATOL = 1e-6
GAP = 1e-4
ARCH = "seamless-m4t-medium"


def _np(x):
    return np.asarray(x)


def _close(a, b, **tol):
    np.testing.assert_allclose(a.float().numpy() if torch.is_tensor(a)
                               else a, _np(b).astype(np.float32),
                               **(tol or TOL))


# ---------------------------------------------------------------------------
# attention over T != S keys
# ---------------------------------------------------------------------------
def _qkv(b, s, t, h, kv, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, hd)).astype(np.float32),
            rng.standard_normal((b, t, kv, hd)).astype(np.float32),
            rng.standard_normal((b, t, kv, hd)).astype(np.float32))


@pytest.mark.parametrize("b,s,t,h,kv,hd,window", [
    (2, 12, 40, 4, 4, 64, None), (2, 40, 12, 8, 2, 32, None),
    (1, 77, 300, 4, 1, 16, None), (1, 300, 77, 4, 2, 16, None),
    (2, 12, 40, 4, 2, 32, 5),
    # past DENSE_MAX keys: JAX's chunked online-softmax path
    (1, 8, 2048, 2, 1, 16, None)])
def test_flash_plain_over_other_key_lengths_matches_jax(b, s, t, h, kv, hd,
                                                        window):
    """``flash_attention_plain`` with T != S, non-causal, against what the
    JAX package runs there: ``attention_core(causal=False)`` (its dense
    path up to DENSE_MAX keys, chunked past it); and ``ops`` on CPU
    tensors is the plain version."""
    q, k, v = _qkv(b, s, t, h, kv, hd, s * t)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out = flash_attention_plain(tq, tk, tv, causal=False, window=window)
    ref = jattn.attention_core(q, k, v, causal=False, window=window)
    assert out.shape == (b, s, h, hd)
    _close(out, ref)
    assert torch.equal(ops.flash_attention(tq, tk, tv, causal=False,
                                           window=window), out)
    bf = [x.bfloat16() for x in (tq, tk, tv)]
    assert flash_attention_plain(*bf, causal=False).dtype == torch.bfloat16


def test_causal_flash_over_other_key_lengths_raises():
    tq, tk, tv = map(torch.from_numpy, _qkv(1, 12, 40, 4, 4, 16, 0))
    for fn in (flash_attention_plain, ops.flash_attention):
        with pytest.raises(ValueError, match="causal"):
            fn(tq, tk, tv, causal=True)
        with pytest.raises(ValueError, match="causal"):
            fn(tq, tk, tv)                    # causal is the default


def _attn_pair(cfg, seed):
    """(JAX cross-attention params, the port's Attention holding them)."""
    jp = jax.tree.map(np.asarray, jattn.attn_init(
        KeyGen(jax.random.key(seed)), cfg, jnp.float32, cross=True))
    p = attention.Attention(cfg, device="cpu", dtype=torch.float32,
                            cross=True)
    with torch.no_grad():
        for name, t in p.named_parameters():
            t.copy_(torch.from_numpy(np.array(jp[name])))
    assert {n for n, _ in p.named_parameters()} == set(jp)
    return jp, p


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
def test_cross_attention_and_its_decode_match_jax(cache_dtype):
    """``encode_kv``, ``cross_attention`` (12 positions over 40 frames)
    and ``cross_attn_decode`` (one query over the 40 frames, as the
    decode kernel's ring with every length T) against JAX's; the decode
    also over bf16 K/V under an f32 query (the default cache's dtype), and
    ``decode_attention_plain`` on those K/V against JAX's
    ``cross_attn_decode`` core."""
    cfg = get_config(ARCH).reduced().with_(num_kv_heads=2)
    jp, p = _attn_pair(cfg, 0)
    rng = np.random.default_rng(1)
    enc = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    jkv = jattn.encode_kv(jp, enc, cfg)
    with torch.inference_mode():
        kv = attention.encode_kv(p, torch.from_numpy(enc), cfg)
        for a, ja in zip(kv, jkv):
            assert a.shape == (2, 40, 2, cfg.resolved_head_dim)
            _close(a, ja)
        _close(attention.cross_attention(p, torch.from_numpy(x), kv, cfg),
               jattn.cross_attention(jp, x, jkv, cfg))
        kv_c = tuple(a.to(cache_dtype) for a in kv)
        jkv_c = tuple(jnp.asarray(a.float().numpy()).astype(
            jnp.bfloat16 if cache_dtype == torch.bfloat16 else jnp.float32)
            for a in kv_c)
        x1 = x[:, :1]
        out = attention.cross_attn_decode(p, torch.from_numpy(x1), kv_c, cfg)
        assert out.dtype == torch.float32
        _close(out, jattn.cross_attn_decode(jp, x1, jkv_c, cfg))
        q = (torch.from_numpy(x1[:, 0]) @ p.wq).view(2, cfg.num_heads, -1)
        lengths = torch.full((2,), 40)
        core = decode_attention_plain(q, *kv_c, lengths)
        jq = jnp.asarray(q.numpy())[:, None]
        _close(core, jattn.dense_attention(jq, *jkv_c, causal=False,
                                           window=None)[:, 0])


# ---------------------------------------------------------------------------
# the reduced seamless-m4t-medium
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params (numpy tree), port model, cfg): 2 encoder
    and 2 decoder layers, d 256, 4 heads, 64 audio frames."""
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    assert repr(cfg) == repr(jcfg) and cfg.is_encoder_decoder
    jm = jbuild_model(jcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(21)))
    return jm, tree, params_from_jax(tree, cfg, device="cpu"), cfg


def _inputs(cfg, b, s, seed):
    """Tokens (B, S) and seeded audio frame embeddings (B, F, d)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            rng.standard_normal((b, cfg.audio_frames, cfg.d_model))
            .astype(np.float32))


def test_encdec_encode_and_forward_match_jax(pair):
    jm, tree, model, cfg = pair
    assert isinstance(model, EncDecModel)
    tokens, audio = _inputs(cfg, 2, 16, 1)
    with torch.inference_mode():
        enc = model.encode(torch.from_numpy(audio))
        logits, cache = model(torch.from_numpy(tokens),
                              audio_embeds=torch.from_numpy(audio))
    _close(enc, jencdec.encode(tree, cfg, audio))
    jlogits = jax.jit(lambda p, bt: jm.forward(p, bt)[0])(
        tree, {"tokens": tokens, "audio_embeds": audio})
    assert cache is None
    assert logits.shape == jlogits.shape == (2, 16, 1024)
    _close(logits, jlogits)
    assert model.head_table is model.lm_head.table


def test_encdec_prefill_caches_and_decode_match_jax(pair):
    """Prefill 12 tokens into a self ring of 20 slots: the self and cross
    caches (f32, as JAX's forward returns them) against JAX's; then 4
    decode steps against JAX's decode and JAX's teacher-forced forward."""
    jm, tree, model, cfg = pair
    b, s, n, cache_len = 2, 12, 4, 20
    tokens, audio = _inputs(cfg, b, s + n, 2)
    _, jcache, _ = jax.jit(lambda p, bt: jm.forward(
        p, bt, collect_cache=True, cache_len=cache_len))(
            tree, {"tokens": tokens[:, :s], "audio_embeds": audio})
    with torch.inference_mode():
        _, cache = model(torch.from_numpy(tokens[:, :s]),
                         audio_embeds=torch.from_numpy(audio),
                         collect_cache=True, cache_len=cache_len)
    for i, entry in enumerate(cache):
        for key in ("k", "v"):
            assert entry["self"][key].shape[1] == cache_len
            _close(entry["self"][key], jcache["self"][key][i])
        for a, ja in zip(entry["cross"], jcache["cross"]):
            assert a.dtype == torch.float32
            assert a.shape[1] == cfg.audio_frames
            _close(a, ja[i])
    jfull = _np(jax.jit(lambda p, bt: jm.forward(p, bt)[0])(
        tree, {"tokens": tokens, "audio_embeds": audio}))
    jdec = jax.jit(lambda *a: jm.decode_step(*a))
    for t in range(s, s + n):
        pos = np.full((b,), t, np.int32)
        jlg, jcache = jdec(tree, tokens[:, t:t + 1], jcache, pos)
        with torch.inference_mode():
            lg, cache = model.decode_step(torch.from_numpy(tokens[:, t:t + 1]),
                                          cache, torch.from_numpy(pos).long())
        _close(lg, jlg, atol=DECODE_ATOL)
        _close(lg[:, 0], jfull[:, t], atol=DECODE_ATOL)


def test_encdec_default_cache_and_prefill_cross_match_jax(pair):
    """The default bf16 cache, its cross part filled by ``prefill_cross``
    (which gives the encoder's f32 K/V, as JAX's does), then 8 tokens
    decoded one at a time from the empty ring: each step's logits against
    JAX's, the rings bf16 on both sides to the end."""
    jm, tree, model, cfg = pair
    b, s = 2, 8
    tokens, audio = _inputs(cfg, b, s, 3)
    jcache = jencdec.prefill_cross(tree, cfg, audio,
                                   jm.init_cache(tree, b, s))
    with torch.inference_mode():
        empty = model.init_cache(b, s)
        assert all(c["self"]["k"].dtype == torch.bfloat16
                   and c["cross"][0].dtype == torch.bfloat16
                   and c["cross"][0].shape[1] == cfg.audio_frames
                   for c in empty)
        cache = model.prefill_cross(torch.from_numpy(audio), empty)
    jdec = jax.jit(lambda *a: jm.decode_step(*a))
    for i, c in enumerate(cache):
        for a, ja in zip(c["cross"], jcache["cross"]):
            assert a.dtype == torch.float32
            _close(a, ja[i])
    for t in range(s):
        pos = np.full((b,), t, np.int32)
        with torch.inference_mode():
            lg, cache = model.decode_step(torch.from_numpy(tokens[:, t:t + 1]),
                                          cache, torch.from_numpy(pos).long())
        jlg, jcache = jdec(tree, tokens[:, t:t + 1], jcache, pos)
        assert lg.dtype == torch.float32
        _close(lg, jlg, atol=DECODE_ATOL)
    for i, c in enumerate(cache):
        assert c["self"]["k"].dtype == torch.bfloat16
        _close(c["self"]["k"], jcache["self"]["k"][i], atol=DECODE_ATOL)


@pytest.fixture(scope="module")
def mesh():
    # Auto axes: jax 0.9's default (Explicit) makes the JAX package's
    # head-sharded attention raise (see tests/test_torch_decode.py)
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _agree(conf, top1, jconf, jtop1, hidden, table):
    np.testing.assert_allclose(conf.numpy(), _np(jconf), atol=CONF_ATOL)
    logits = hidden[:, -1].astype(np.float64) @ table.T.astype(np.float64)
    top2 = np.sort(logits, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > GAP
    assert clear.any()
    assert np.array_equal(top1.numpy()[clear], _np(jtop1)[clear])


def test_encdec_prefill_and_serve_steps_match_jax(pair, mesh):
    """Prefill of 2 prompts of 20 tokens over 64 frames (its ring of 20
    slots, JAX's default), then 4 decode steps feeding back JAX's top-1,
    against the JAX package's step factories on a (1, 1) mesh; the head is
    the untied lm_head."""
    jm, tree, model, cfg = pair
    jprefill = jax.jit(jdist.make_prefill_step(jm, mesh))
    jserve = jax.jit(jdist.make_serve_step(jm, mesh, 2))
    table = tree["lm_head"]["table"]
    tokens, audio = _inputs(cfg, 2, 20, 4)
    prefill, serve = make_prefill_step(model), make_serve_step(model)
    with mesh:
        jconf, jtop1, jcache = jprefill(
            tree, {"tokens": tokens, "audio_embeds": audio})
    conf, top1, cache = prefill(torch.from_numpy(tokens),
                                audio_embeds=torch.from_numpy(audio))
    with torch.inference_mode():
        hidden, _ = model(torch.from_numpy(tokens),
                          audio_embeds=torch.from_numpy(audio),
                          return_hidden=True)
    _agree(conf, top1, jconf, jtop1, hidden.numpy(), table)
    tok = np.array(jtop1)
    for i in range(4):
        pos = np.full((2,), 20 + i, np.int32)
        with mesh:
            jconf, jtop1, jcache = jserve(tree, tok[:, None], jcache, pos)
        with torch.inference_mode():
            hidden, _ = model.decode_step(
                torch.from_numpy(tok[:, None]),
                [{"self": {k: x.clone() for k, x in c["self"].items()},
                  "cross": c["cross"]} for c in cache],
                torch.from_numpy(pos).long(), return_hidden=True)
        conf, top1, cache = serve(torch.from_numpy(tok[:, None]), cache,
                                  torch.from_numpy(pos).long())
        _agree(conf, top1, jconf, jtop1, hidden.numpy(), table)
        tok = np.array(jtop1)


def test_encdec_layout_and_init(pair):
    """Parameter names map onto the JAX tree (stacked over encoder_layers
    and num_layers), the cross-attention has no QK norm, and
    ``init_params`` fills every parameter."""
    _, tree, model, cfg = pair
    assert np.array_equal(model.enc_blocks[1].attn.wq.numpy(),
                          tree["enc_blocks"]["attn"]["wq"][1])
    assert np.array_equal(model.dec_blocks[0].xattn.wv.numpy(),
                          tree["dec_blocks"]["xattn"]["wv"][0])
    assert np.array_equal(model.frontend_proj.numpy(), tree["frontend_proj"])
    qk = cfg.with_(qk_norm=True)
    m = build_model(qk, device="meta")
    assert hasattr(m.dec_blocks[0].attn, "q_norm")
    assert not hasattr(m.dec_blocks[0].xattn, "q_norm")
    m = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for name, p in m.named_parameters():
        if name.endswith("scale"):
            assert (p == 1).all(), name
        else:
            assert p.std() > 0 and p.abs().max() <= 2 * cfg.init_scale, name
    pv = common.padded_vocab(get_config(ARCH).vocab_size)
    assert pv == 256_256


def test_both_new_models_default_to_the_card():
    """``build_model`` and ``init_params`` build xlstm-350m and
    seamless-m4t-medium on ``device="cuda"`` unless asked otherwise, so
    without a card they raise; on the CPU they build when asked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    for name in ("xlstm-350m", ARCH):
        cfg = get_config(name).reduced()
        with pytest.raises(RuntimeError, match="CUDA"):
            build_model(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            init_params(cfg, torch.Generator().manual_seed(0))
        assert build_model(cfg, device="cpu").device == torch.device("cpu")
