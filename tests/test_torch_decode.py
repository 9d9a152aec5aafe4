"""The port's decode path held to the JAX package on the CPU: the decode
attention kernel's plain version, ``attn_decode`` over a ring cache, and
the prefill / serve step factories.

Tolerances: decode attention 1e-5 (float32 sums in another order);
attention layer outputs 1e-4 (float32 matmuls); serve-step BvSB 1e-6
(both compute a float32 softmax of logits within 1e-6), top-1 equal
wherever JAX's top-2 logit gap exceeds 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as jdecode
from repro.launch import distributed as jdist
from repro.models import attention as jattn
from repro.models.common import KeyGen
from repro.models.model import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import (BLOCKS_PER_SM, MAX_SPLITS,
                                                  TILE, decode_attention_plain,
                                                  splits)
from repro_torch.launch.distributed import (head_bvsb, make_prefill_step,
                                            make_serve_step)
from repro_torch.models import attention
from repro_torch.models.model import params_from_jax

torch.set_num_threads(2)

DECODE_ATOL = 1e-5
TOL = dict(atol=1e-4, rtol=1e-4)
CONF_ATOL = 1e-6
GAP = 1e-4


def _decode_inputs(b, h, kvh, hd, w, lengths, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, w, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, w, kvh, hd)).astype(np.float32)
    return q, k, v, np.asarray(lengths, np.int32)


# (B, H, KV, hd, W, lengths): W <= 512 or a multiple of 512 for the Pallas
# kernel's cache tile; lengths 1, W and ragged, alone and mixed
DECODE_CASES = [
    (3, 16, 1, 256, 512, [1, 300, 512]),
    (2, 8, 2, 64, 1024, [1024, 777]),
    (1, 4, 4, 32, 512, [1]),
    (4, 8, 2, 128, 100, [100, 1, 50, 99]),
]


@pytest.mark.parametrize("b,h,kvh,hd,w,lengths", DECODE_CASES)
def test_decode_attention_plain_matches_jax(b, h, kvh, hd, w, lengths):
    q, k, v, lens = _decode_inputs(b, h, kvh, hd, w, lengths, hd + w)
    out = decode_attention_plain(*map(torch.from_numpy, (q, k, v, lens)))
    assert out.shape == (b, h, hd) and out.dtype == torch.float32
    ref = jref.decode_attention_ref(q, k, v, lens)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=DECODE_ATOL)
    if w <= 512 or w % 512 == 0:
        kern = jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(lens), interpret=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(kern),
                                   atol=DECODE_ATOL)


def test_decode_attention_plain_ignores_masked_slots():
    """Whatever the slots at or past the length hold changes nothing."""
    q, k, v, lens = _decode_inputs(2, 4, 1, 64, 64, [5, 64], 0)
    k2, v2 = k.copy(), v.copy()
    k2[0, 5:] = 1e3
    v2[0, 5:] = -1e3
    a = decode_attention_plain(*map(torch.from_numpy, (q, k, v, lens)))
    b = decode_attention_plain(*map(torch.from_numpy, (q, k2, v2, lens)))
    assert torch.equal(a[0], b[0])


def test_decode_attention_cpu_takes_the_plain_version():
    q, k, v, lens = map(torch.from_numpy,
                        _decode_inputs(2, 8, 2, 64, 96, [1, 96], 1))
    ops.reset_launch_counts()
    assert torch.equal(ops.decode_attention(q, k, v, lens),
                       decode_attention_plain(q, k, v, lens))
    assert ops.launch_counts()["decode_attention"] == 0
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    assert ops.decode_attention(qb, kb, vb, lens).dtype == torch.bfloat16


@pytest.mark.parametrize("b,kvh,w,sms", [(4, 1, 2048, 132), (64, 1, 2048, 132),
                                         (1, 1, 2048, 132), (2, 2, 100, 132),
                                         (1, 1, 1, 132), (8, 4, 3000, 114)])
def test_decode_splits_cover_the_window(b, kvh, w, sms):
    ns, chunk = splits(b, kvh, w, sms)
    tiles = -(-w // TILE)
    assert 1 <= ns <= MAX_SPLITS and chunk % TILE == 0
    assert ns * chunk >= w and (ns - 1) * chunk < w   # covered, none empty
    assert ns <= tiles                 # no more splits than key tiles
    wave = BLOCKS_PER_SM * sms
    assert b * kvh * ns <= max(wave, b * kvh)         # one wave of blocks
    # and at least half the splits that the wave and the tiles allow
    assert 2 * ns >= min(tiles, wave // (b * kvh), MAX_SPLITS)


# ---------------------------------------------------------------------------
# attn_decode over the ring
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("w", [1, 5, 16, 128])
def test_ring_lengths_equal_the_jax_validity_mask(w):
    """lengths = min(pos + 1, W) marks exactly the slots the JAX
    ``attn_decode`` keeps, before and after the ring wraps."""
    pos = np.arange(0, 3 * w + 2)
    slot = pos % w
    j = np.arange(w)[None, :]
    abs_pos = pos[:, None] - np.mod(slot[:, None] - j, w)
    valid = (abs_pos >= 0) & ((pos[:, None] - abs_pos) < w)
    lengths = attention.ring_lengths(torch.from_numpy(pos), w).numpy()
    assert np.array_equal(valid, j < lengths[:, None])


@pytest.fixture(scope="module")
def lattn_layer():
    """(cfg, jax attention params, port Attention) of the reduced
    RecurrentGemma's local attention, window 16."""
    cfg = get_config("recurrentgemma-9b").reduced().with_(local_attn_window=16)
    jp = jattn.attn_init(KeyGen(jax.random.key(3)), cfg, jnp.float32)
    jp = {k: np.array(v) for k, v in jp.items()}
    p = attention.Attention(cfg, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for name, t in p.named_parameters():
            t.copy_(torch.from_numpy(jp[name]))
    return cfg, jp, p


@pytest.mark.parametrize("start", [0, 11])
def test_attn_decode_matches_jax_over_the_ring(lattn_layer, start):
    """40 steps over a ring of W = 16 slots, before and after it wraps;
    the requests sit at different positions (``start`` apart)."""
    cfg, jp, p = lattn_layer
    w, b = 16, 2
    rng = np.random.default_rng(start)
    cache = attention.init_kv_cache(b, w, cfg, torch.float32)
    jcache = jattn.init_kv_cache(b, w, cfg, jnp.float32)
    jstep = jax.jit(lambda p_, x, c, pos: jattn.attn_decode(
        p_, x, c, pos, cfg, window=w))
    for t in range(40):
        x1 = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        pos = np.array([t, t + start], np.int32)
        out, cache = attention.attn_decode(p, torch.from_numpy(x1), cache,
                                           torch.from_numpy(pos).long(), cfg)
        jout, jcache = jstep(jp, x1, jcache, pos)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
        np.testing.assert_allclose(cache["k"].numpy(),
                                   np.asarray(jcache["k"]), **TOL)


def test_fill_kv_cache_places_positions_in_ring_slots():
    cfg = get_config("recurrentgemma-9b").reduced()
    for s, w in ((10, 16), (16, 16), (40, 16), (3000, 2048)):
        k = torch.arange(s, dtype=torch.float32)[None, :, None, None] \
            .expand(1, s, 1, 2)
        c = attention.fill_kv_cache(
            attention.init_kv_cache(1, w, cfg.with_(head_dim=2), torch.float32),
            k, k)
        kept = torch.arange(max(0, s - w), s)
        assert torch.equal(c["k"][0, kept % w, 0, 0], kept.float())
        if s < w:
            assert not c["k"][0, s:].any()


def test_soft_capped_decode_raises(lattn_layer):
    """Soft-capped decode, which raised before the kernels took the cap,
    now agrees with the JAX package's ``attn_decode`` under
    ``logit_soft_cap`` = 30: 20 steps over a ring of 16 slots on inputs
    scaled by 20, so that the scores reach the cap (outputs within TOL,
    and off the uncapped decode's by more)."""
    base, jp, p = lattn_layer
    cfg = base.with_(logit_soft_cap=30.0)
    w, b = 16, 2
    rng = np.random.default_rng(30)
    cache = attention.init_kv_cache(b, w, cfg, torch.float32)
    free = attention.init_kv_cache(b, w, base, torch.float32)
    jcache = jattn.init_kv_cache(b, w, cfg, jnp.float32)
    jstep = jax.jit(lambda p_, x, c, pos: jattn.attn_decode(
        p_, x, c, pos, cfg, window=w))
    moved = 0.0
    for t in range(20):
        x1 = (rng.standard_normal((b, 1, cfg.d_model)) * 20).astype(np.float32)
        pos = np.array([t, t + 3], np.int32)
        tpos = torch.from_numpy(pos).long()
        out, cache = attention.attn_decode(p, torch.from_numpy(x1), cache,
                                           tpos, cfg)
        uncapped, free = attention.attn_decode(p, torch.from_numpy(x1), free,
                                               tpos, base)
        jout, jcache = jstep(jp, x1, jcache, pos)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
        moved = max(moved, float((out - uncapped).abs().max()))
    assert moved > 10 * TOL["atol"]


# ---------------------------------------------------------------------------
# the step factories
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def served():
    """JAX prefill / serve steps of the reduced RecurrentGemma on a
    (1, 1) mesh, jitted, and the port's model on the same weights."""
    jcfg = jget_config("recurrentgemma-9b").reduced()
    cfg = get_config("recurrentgemma-9b").reduced()
    jm = jbuild_model(jcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(1)))
    # Auto axes, the default of the JAX releases the package was written
    # for: jax 0.9's default (Explicit) makes its head-sharded attention's
    # with_sharding_constraint raise
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    prefill = jax.jit(jdist.make_prefill_step(jm, mesh))
    serve = jax.jit(jdist.make_serve_step(jm, mesh, 2))
    return mesh, prefill, serve, tree, params_from_jax(tree, cfg, device="cpu"), cfg


def _agree(conf, top1, jconf, jtop1, gap):
    np.testing.assert_allclose(conf.numpy(), np.asarray(jconf),
                               atol=CONF_ATOL)
    clear = gap > GAP
    assert clear.any()
    assert np.array_equal(top1.numpy()[clear], np.asarray(jtop1)[clear])


def _gap(hidden, table):
    logits = hidden[:, -1, :].astype(np.float64) @ table.T.astype(np.float64)
    top2 = np.sort(logits, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


@pytest.mark.parametrize("s", [150, 60])
def test_prefill_and_serve_steps_match_jax(served, s):
    """Prefill of 2 prompts (past the window of 128 at S = 150), then 6
    decode steps feeding back JAX's top-1."""
    mesh, jprefill, jserve, tree, model, cfg = served
    table = tree["embed"]["table"]
    tokens = np.random.default_rng(s).integers(
        0, cfg.vocab_size, (2, s)).astype(np.int32)
    prefill, serve = make_prefill_step(model), make_serve_step(model)
    with mesh:
        jconf, jtop1, jcache = jprefill(tree, {"tokens": tokens})
    conf, top1, cache = prefill(torch.from_numpy(tokens))
    with torch.inference_mode():
        hidden, _ = model(torch.from_numpy(tokens), return_hidden=True)
    _agree(conf, top1, jconf, jtop1, _gap(hidden.numpy(), table))
    tok = np.array(jtop1)
    for i in range(6):
        pos = np.full((2,), s + i, np.int32)
        with mesh:
            jconf, jtop1, jcache = jserve(tree, tok[:, None], jcache, pos)
        with torch.inference_mode():
            hidden, _ = model.decode_step(
                torch.from_numpy(tok[:, None]),
                [{k: v.clone() for k, v in c.items()} for c in cache],
                torch.from_numpy(pos).long(), return_hidden=True)
        conf, top1, cache = serve(torch.from_numpy(tok[:, None]), cache,
                                  torch.from_numpy(pos).long())
        _agree(conf, top1, jconf, jtop1, _gap(hidden.numpy(), table))
        tok = np.array(jtop1)


def test_head_bvsb_masks_padded_vocab():
    rng = np.random.default_rng(0)
    hidden = torch.from_numpy(rng.standard_normal((3, 1, 8)).astype(np.float32))
    table = torch.from_numpy(rng.standard_normal((128, 8)).astype(np.float32))
    conf, top1 = head_bvsb(hidden, table, 100)
    logits = hidden[:, 0] @ table[:100].T
    pconf, ptop1 = ops.bvsb(logits)
    torch.testing.assert_close(conf, pconf, atol=CONF_ATOL, rtol=0)
    assert torch.equal(top1, ptop1) and (top1 < 100).all()
