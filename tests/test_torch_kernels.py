"""The port's kernel plain versions held to the JAX package on the CPU.

``repro_torch.kernels`` run their plain PyTorch versions on CPU tensors;
these tests feed the same numpy inputs to them and to the JAX package's
``kernels/ref.py`` oracles, its dispatch layer (Pallas interpret mode on
the CPU, the TPU kernel body) and the tiers' XLA attention path. The CUDA
kernels themselves are held to the same plain versions on the card by
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import ops
from repro_torch.kernels.bvsb import (BLOCKS_PER_SM, MIN_CHUNK, MIN_CHUNKS,
                                     VEC, bvsb_plain, chunks)
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import (BWD_KEYS, BWD_WAVES,
                                                 MAX_BWD_SPLITS,
                                                 MIN_SPLIT_TILES, bwd_rows,
                                                 bwd_splits,
                                                 flash_attention_plain)
from repro_torch.kernels.moe_route import (moe_combine_plain,
                                           moe_dispatch_plain)
from repro_torch.kernels.rglru_scan import STRIP as SCAN_STRIP
from repro_torch.kernels.rglru_scan import (BWD_SMEM, BWD_STEPS, bwd_tiles,
                                            rglru_scan_plain)

torch.set_num_threads(2)

CONF_ATOL = 1e-6     # both compute a float32 softmax of identical values
FLASH_ATOL = 1e-5    # float32 sums taken in another order


def _bvsb_grid():
    """(name, logits f32) cases of tests/test_kernel_numerics.py's grid."""
    cases = []
    for b in (1, 3, 20, 64):
        for v in (2048, 1000, 700, 130):
            rng = np.random.default_rng(b * 4096 + v)
            cases.append((f"randn-{b}x{v}",
                          (rng.standard_normal((b, v)) * 4).astype(np.float32)))
    ties = np.full((4, 1100), -1.0, np.float32)
    ties[0, [7, 199]] = 3.0      # duplicate max within one 512-column tile
    ties[1, [5, 600]] = 2.5      # duplicate max across 512-column tiles
    ties[2, :] = 0.0             # fully tied row
    ties[3, 1099] = 5.0          # unique max in the last (ragged) column
    cases.append(("ties", ties))
    ext = np.full((3, 600), -1e38, np.float32)
    ext[0, 5] = 1e4
    ext[1, 7] = 0.0
    ext[2, :10] = -np.inf
    ext[2, 11] = 2.0
    cases.append(("extreme", ext))
    return cases


BVSB_CASES = _bvsb_grid()


@pytest.mark.parametrize("name,x", BVSB_CASES, ids=[c[0] for c in BVSB_CASES])
def test_bvsb_plain_matches_jax(name, x):
    conf, top1 = bvsb_plain(torch.from_numpy(x))
    rconf, rtop1 = jref.bvsb_ref(jnp.asarray(x))
    kconf, ktop1 = jops.bvsb(jnp.asarray(x))   # Pallas interpret mode
    for other, otop1 in ((rconf, rtop1), (kconf, ktop1)):
        np.testing.assert_allclose(conf.numpy(), np.asarray(other),
                                   atol=CONF_ATOL)
        assert np.array_equal(top1.numpy(), np.asarray(otop1))
    assert conf.dtype == torch.float32 and top1.dtype == torch.int32


def test_bvsb_plain_tie_rows_first_index_zero_margin():
    x = dict(BVSB_CASES)["ties"]
    conf, top1 = bvsb_plain(torch.from_numpy(x))
    np.testing.assert_allclose(conf[:3].numpy(), 0.0, atol=CONF_ATOL)
    assert top1.tolist() == [7, 5, 0, 1099]


@pytest.mark.parametrize("b,v", [(20, 1000), (64, 2048), (3, 130)])
def test_bvsb_plain_bf16_matches_jax(b, v):
    """Both sides see identical bf16 values (rounded once, in JAX)."""
    rng = np.random.default_rng(7 + b)
    xb = jnp.asarray(rng.standard_normal((b, v)) * 4, jnp.bfloat16)
    x32 = np.array(xb.astype(jnp.float32))
    conf, top1 = bvsb_plain(torch.from_numpy(x32).to(torch.bfloat16))
    rconf, rtop1 = jref.bvsb_ref(xb)
    kconf, ktop1 = jops.bvsb(xb)
    for other, otop1 in ((rconf, rtop1), (kconf, ktop1)):
        np.testing.assert_allclose(conf.numpy(), np.asarray(other),
                                   atol=CONF_ATOL)
        assert np.array_equal(top1.numpy(), np.asarray(otop1))


def test_bvsb_plain_pos_inf_is_nan_in_both():
    x = np.zeros((2, 64), np.float32)
    x[0, 3] = np.inf
    x[1, [5, 9]] = np.inf
    conf, _ = bvsb_plain(torch.from_numpy(x))
    rconf, _ = jref.bvsb_ref(jnp.asarray(x))
    assert torch.isnan(conf).all() and np.isnan(np.asarray(rconf)).all()


def test_bvsb_plain_padding_columns_have_no_mass():
    """The LM head's finfo(f32).min padding columns change nothing."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 1000)).astype(np.float32) * 3
    padded = np.concatenate(
        [x, np.full((5, 24), np.finfo(np.float32).min, np.float32)], axis=1)
    conf, top1 = bvsb_plain(torch.from_numpy(x))
    pconf, ptop1 = bvsb_plain(torch.from_numpy(padded))
    np.testing.assert_allclose(pconf.numpy(), conf.numpy(), atol=CONF_ATOL)
    assert torch.equal(ptop1, top1)


@pytest.mark.parametrize("b,v,sms", [(4, 256_000, 132), (64, 256_000, 132),
                                     (8, 2048, 132), (1, 2048, 132),
                                     (1, 1, 132), (3, 130, 132),
                                     (8, 8192, 132), (1, 256_000, 114),
                                     (1000, 256_000, 132), (2, 8191, 132)])
def test_bvsb_chunks_cover_the_row(b, v, sms):
    n, per = chunks(b, v, sms)
    assert per % VEC == 0                            # whole 16-byte vectors
    assert n * per >= v and (n - 1) * per < v        # [0, V) covered, none empty
    assert 1 <= n <= max(1, -(-BLOCKS_PER_SM * sms // b))   # the stated maximum
    assert n == 1 or per >= MIN_CHUNK
    if v < MIN_CHUNKS * MIN_CHUNK:   # the cascade's (B, 2048): one block
        assert n == 1


def _fold(s, x, col):
    """The kernel's one-exp fold of element x (float32) into (m1, m2, z,
    idx)."""
    m1, m2, z, idx = s
    if x > m1:
        return x, m1, np.float32(z * np.exp(np.float32(m1 - x)) + 1), col
    e = np.float32(0) if x == -np.inf else np.exp(np.float32(x - m1))
    return m1, max(m2, x), np.float32(z + e), idx


def _merge(a, b):
    m1 = max(a[0], b[0])
    m2 = max(a[1], b[1], min(a[0], b[0]))
    za = np.float32(0) if a[0] == -np.inf else a[2] * np.exp(a[0] - m1)
    zb = np.float32(0) if b[0] == -np.inf else b[2] * np.exp(b[0] - m1)
    idx = a[3] if a[0] > b[0] else b[3] if b[0] > a[0] else min(a[3], b[3])
    return m1, m2, np.float32(za + zb), idx


def _bvsb_chunked(x, per, threads):
    """``csrc/bvsb.cu``'s algorithm in float32 numpy: chunks of ``per``
    columns, ``threads`` threads a chunk each folding its strided columns
    in order, the threads' and the chunks' tuples merged."""
    empty = (np.float32(-np.inf), np.float32(-np.inf), np.float32(0), 2 ** 31)
    conf, top1 = [], []
    with np.errstate(invalid="ignore", over="ignore"):
        for row in x.astype(np.float32):
            total = empty
            for c0 in range(0, len(row), per):
                chunk = empty
                for t in range(threads):
                    s = empty
                    for col in range(c0 + t, min(c0 + per, len(row)), threads):
                        s = _fold(s, row[col], col)
                    chunk = _merge(chunk, s)
                if chunk[3] == 2 ** 31:   # every logit -inf
                    chunk = chunk[:3] + (c0,)
                total = _merge(total, chunk)
            m1, m2, z, idx = total
            conf.append(np.float32((1 - np.exp(np.float32(m2 - m1))) / z))
            top1.append(idx)
    return np.array(conf, np.float32), np.array(top1)


def _fold_cases():
    cases = dict(BVSB_CASES)
    x = np.random.default_rng(9).standard_normal((3, 300)).astype(np.float32)
    x[0, [7, 290]] = 9.0                     # a tie across chunks
    x[1, 64:128] = -np.inf                   # a chunk all -inf
    x[2, 299] = np.inf                       # +inf in the last chunk
    return [("ties", cases["ties"][:, :300], 64, 8),
            ("extreme", cases["extreme"], 128, 16),
            ("randn-3x130", cases["randn-3x130"], 32, 4),
            ("chunk edges", x, 64, 8)]


@pytest.mark.parametrize("name,x,per,threads", _fold_cases(),
                         ids=[c[0] for c in _fold_cases()])
def test_bvsb_one_exp_fold_matches_plain(name, x, per, threads):
    """The kernel's fold and merges, emulated: the same confidence as the
    plain version, the first index on ties also across chunks, -inf and
    -1e38 without mass, +inf NaN."""
    conf, top1 = _bvsb_chunked(x, per, threads)
    pconf, ptop1 = bvsb_plain(torch.from_numpy(x))
    np.testing.assert_allclose(conf, pconf.numpy(), atol=CONF_ATOL)
    finite = ~np.isnan(pconf.numpy())
    assert np.array_equal(top1[finite], ptop1.numpy()[finite])


FLASH_CASES = [(hd, g, s, window) for hd in (32, 48, 64) for g in (1, 4)
               for s in (8, 16, 64) for window in (None, 5)]


@pytest.mark.parametrize("hd,g,s,window", FLASH_CASES)
def test_flash_attention_plain_matches_jax(hd, g, s, window):
    kvh = 2
    rng = np.random.default_rng(hd * 1000 + g * 100 + s)
    q = rng.standard_normal((2, s, kvh * g, hd)).astype(np.float32)
    k = rng.standard_normal((2, s, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((2, s, kvh, hd)).astype(np.float32)
    out = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=True,
                                window=window).numpy()
    ref = jref.flash_attention_ref(q, k, v, causal=True, window=window)
    core = jattn.attention_core(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, window=window)
    np.testing.assert_allclose(out, np.asarray(ref), atol=FLASH_ATOL)
    np.testing.assert_allclose(out, np.asarray(core), atol=FLASH_ATOL)


@pytest.mark.parametrize("s,window", [(40, 16), (77, None), (130, 128)])
def test_flash_attention_plain_matches_jax_at_head_dim_256(s, window):
    """RecurrentGemma's local attention: 16 query heads over 1 KV head of
    256, a window shorter than the sequence."""
    rng = np.random.default_rng(s)
    q = rng.standard_normal((2, s, 16, 256)).astype(np.float32)
    k = rng.standard_normal((2, s, 1, 256)).astype(np.float32)
    v = rng.standard_normal((2, s, 1, 256)).astype(np.float32)
    out = flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                causal=True, window=window).numpy()
    ref = jref.flash_attention_ref(q, k, v, causal=True, window=window)
    core = jattn.attention_core(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, window=window)
    np.testing.assert_allclose(out, np.asarray(ref), atol=FLASH_ATOL)
    np.testing.assert_allclose(out, np.asarray(core), atol=FLASH_ATOL)


def test_flash_attention_plain_non_causal_and_bf16():
    rng = np.random.default_rng(11)
    q = rng.standard_normal((1, 16, 4, 32)).astype(np.float32)
    k = rng.standard_normal((1, 16, 4, 32)).astype(np.float32)
    v = rng.standard_normal((1, 16, 4, 32)).astype(np.float32)
    out = flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                causal=False)
    ref = jref.flash_attention_ref(q, k, v, causal=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FLASH_ATOL)
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    assert flash_attention_plain(qb, kb, vb).dtype == torch.bfloat16


def test_cpu_tensors_take_the_plain_versions_without_launching():
    ops.reset_launch_counts()
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((4, 300)).astype(np.float32))
    conf, top1 = ops.bvsb(x)
    pconf, ptop1 = bvsb_plain(x)
    assert torch.equal(conf, pconf) and torch.equal(top1, ptop1)
    q = torch.from_numpy(rng.standard_normal((1, 16, 4, 32)).astype(np.float32))
    assert torch.equal(ops.flash_attention(q, q, q),
                       flash_attention_plain(q, q, q))
    lengths = torch.tensor([16])
    assert torch.equal(ops.decode_attention(q[:, 0], q, q, lengths),
                       decode_attention_plain(q[:, 0], q, q, lengths))
    a = torch.rand(2, 5, 8)
    assert torch.equal(ops.rglru_scan(a, x[:2, :40].reshape(2, 5, 8)),
                       rglru_scan_plain(a, x[:2, :40].reshape(2, 5, 8)))
    parts = ops.bvsb_partials(x[:, :64], 0)
    assert torch.equal(ops.bvsb_merge(parts[:, None])[1],
                       bvsb_plain(x[:, :64])[1])
    ids = torch.from_numpy(rng.integers(0, 4, (4, 2)))
    route = ops.moe_dispatch(ids, x[:, :8], 4, 3)
    for got, want in zip(route, moe_dispatch_plain(ids, x[:, :8], 4, 3)):
        assert torch.equal(got, want)
    gates = torch.rand(4, 2)
    assert torch.equal(ops.moe_combine(route[3], *route[:3], gates),
                       moe_combine_plain(route[3], *route[:3], gates))
    assert ops.launch_counts() == {"bvsb": 0, "bvsb_partials": 0,
                                   "bvsb_merge": 0, "flash_attention": 0,
                                   "decode_attention": 0,
                                   "decode_attention_partials": 0,
                                   "decode_attention_merge": 0,
                                   "rglru_scan": 0,
                                   "flash_attention_bwd": 0,
                                   "rglru_scan_bwd": 0,
                                   "moe_dispatch": 0, "moe_combine": 0}


class _Elsewhere(torch.Tensor):
    """A CPU tensor that reports a device with no kernel and no plain
    version ("xpu"): ``meta`` is served since the dry-run (no launch, the
    work booked; tests/test_torch_roofline.py)."""

    @property
    def device(self):
        return torch.device("xpu")


def test_other_devices_raise_instead_of_falling_back():
    x = torch.zeros(2, 8).as_subclass(_Elsewhere)
    with pytest.raises(ValueError):
        ops.bvsb(x)
    q = torch.zeros(1, 4, 2, 8).as_subclass(_Elsewhere)
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        ops.decode_attention(q[:, 0], q, q, torch.ones(1))
    with pytest.raises(ValueError):
        ops.rglru_scan(q[0], q[0])


def test_decode_wrapper_takes_exactly_three_dtype_mixes():
    """The CUDA wrapper's check (run here on CPU tensors): all f32, all
    bf16, or f32 q over bf16 caches; anything else raises."""
    from repro_torch.kernels import decode_attention as _decode
    lens = torch.tensor([8, 3])
    for qd, kd, vd, ok in (
            (torch.float32, torch.float32, torch.float32, True),
            (torch.bfloat16, torch.bfloat16, torch.bfloat16, True),
            (torch.float32, torch.bfloat16, torch.bfloat16, True),
            (torch.bfloat16, torch.float32, torch.float32, False),
            (torch.float32, torch.bfloat16, torch.float32, False),
            (torch.float32, torch.float32, torch.bfloat16, False),
            (torch.float16, torch.float16, torch.float16, False),
            (torch.float32, torch.float16, torch.float16, False)):
        args = (torch.zeros(2, 4, 16, dtype=qd),
                torch.zeros(2, 8, 1, 16, dtype=kd),
                torch.zeros(2, 8, 1, 16, dtype=vd), lens)
        if ok:
            _decode._check(*args)
        else:
            with pytest.raises(TypeError):
                _decode._check(*args)


def test_cache_token_separates_devices():
    assert ops.cache_token("cpu") != ops.cache_token("cuda")
    assert ops.cache_token(torch.device("cuda", 0)) == ops.cache_token("cuda")


# ---------------------------------------------------------------------------
# the tensor-core flash backward's plan and tile walks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,s,h,kv,hd,window,sms,want", [
    (2, 3000, 16, 1, 256, 2048, 132, 16),   # RecurrentGemma's training shape
    (4, 2048, 16, 8, 64, None, 132, 2),     # granite-moe-1b-a400m's
    (4, 2048, 16, 16, 128, None, 132, 1),   # deepseek-moe-16b's
    (64, 16, 8, 8, 48, None, 132, 1),       # the tiers'
    (1, 300, 16, 1, 256, 100, 132, 5),
    (1, 64, 4, 1, 128, None, 132, 1)])
def test_flash_bwd_splits_fill_the_card(b, s, h, kv, hd, window, sms, want):
    """Split only while the key-tile columns give fewer than BWD_WAVES
    blocks an SM, at most MAX_BWD_SPLITS, each split walking at least
    MIN_SPLIT_TILES row tiles."""
    n = bwd_splits(b, s, s, h, kv, hd, window, sms)
    assert n == want
    blocks = -(-s // BWD_KEYS) * kv * b
    span = s if window is None else min(s, window + BWD_KEYS - 1)
    tiles = -(-span * (h // kv) // bwd_rows(hd))
    assert 1 <= n <= MAX_BWD_SPLITS
    if n > 1:
        assert blocks * (n - 1) < BWD_WAVES * sms
        assert tiles // n >= MIN_SPLIT_TILES


def _dkdv_walk(s, t, g, causal, window, splits, rows_tile):
    """(first key, row tiles) of each block of flash_bwd_tc_dkdv_kernel, in
    the kernel's own arithmetic."""
    n_rows = s * g
    for k0 in range(0, t, BWD_KEYS):
        pos_lo = k0 if causal else 0
        pos_hi = min(s - 1, k0 + BWD_KEYS - 1 + window - 1) if window \
            else s - 1
        t_lo = pos_lo * g // rows_tile
        tiles = (min(n_rows, (pos_hi + 1) * g) - 1) // rows_tile - t_lo + 1
        for split in range(splits):
            yield k0, range(t_lo + split * tiles // splits,
                            t_lo + (split + 1) * tiles // splits)


def _dq_walk(s, t, g, causal, window, keys_tile, rows=64):
    """(first packed row, key tiles) of each block of
    flash_bwd_tc_dq_kernel, in the kernel's own arithmetic."""
    n_rows = s * g
    for m in range(0, n_rows, rows):
        p_lo, p_hi = m // g, (min(m + rows, n_rows) - 1) // g
        k_hi = min(p_hi, t - 1) if causal else t - 1
        k_lo = max(0, p_lo - window + 1) if window else 0
        yield m, range(k_lo // keys_tile * keys_tile, k_hi + 1, keys_tile)


@pytest.mark.parametrize("s,t,g,causal,window,hd", [
    (300, None, 16, True, 100, 256), (333, None, 16, True, 150, 256),
    (200, None, 2, True, 20, 64), (97, None, 1, True, None, 128),
    (80, None, 4, False, None, 64), (77, 300, 4, False, None, 64),
    (300, 77, 1, False, None, 64)])
@pytest.mark.parametrize("splits", [1, 3, 16])
def test_flash_bwd_tile_walks_visit_each_pair_once(s, t, g, causal, window,
                                                   hd, splits):
    """Every (packed query row, key) pair that the mask keeps lies in
    exactly one (block, streamed tile) of the dK/dV walk, split or not, and
    of the dQ walk: nothing summed twice, nothing left out; pairs outside
    the mask only in tiles that cross an edge."""
    t = t or s
    rows_tile = bwd_rows(hd)
    pos = np.repeat(np.arange(s), g)[:, None]
    key = np.arange(t)[None, :]
    ok = key <= pos if causal else np.ones((s * g, t), bool)
    if window:
        ok = ok & (pos - key < window)
    seen = np.zeros((s * g, t), np.int32)
    for k0, tiles in _dkdv_walk(s, t, g, causal, window, splits, rows_tile):
        for tile in tiles:
            r0 = tile * rows_tile
            seen[r0:r0 + rows_tile, k0:k0 + BWD_KEYS] += 1
    assert (seen[ok] == 1).all() and seen.max() <= 1
    seen[:] = 0
    for m, kts in _dq_walk(s, t, g, causal, window, rows_tile):
        for kt in kts:
            seen[m:m + 64, kt:kt + rows_tile] += 1
    assert (seen[ok] == 1).all() and seen.max() <= 1


# the RG-LRU scan backward's ring plan (kernels/rglru_scan.py bwd_tiles):
# one warp's ring of stages x steps rows of a, dh and h_{t-1}
SCAN_BWD_SMEM = 227 * 1024


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("elt", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,d", [(1, 3000, 4096), (2, 3000, 4096),
                                   (4, 3000, 4096), (2, 5, 4096),
                                   (1, 1, 32), (4, 129, 296),
                                   (64, 3000, 4096)])
def test_rglru_bwd_tiles_fit_the_sm(b, s, d, elt, sms):
    """Two tiles of a power of two of steps (or all of S), at most
    BWD_STEPS, never longer than S; one warp's ring within the 227 KB a
    block may use, and the rings of the warps an SM holds within BWD_SMEM;
    RecurrentGemma's training shape (B = 2) and B = 1 take the longest
    tiles."""
    steps, stages = bwd_tiles(b, s, d, elt, sms)
    assert 1 <= steps <= min(s, BWD_STEPS) and stages == 2
    assert steps == s or steps & (steps - 1) == 0
    row = SCAN_STRIP * (elt + 8)
    assert stages * steps * row <= SCAN_BWD_SMEM
    resident = min(-(-b * -(-d // SCAN_STRIP) // sms), 32)
    assert resident * stages * steps * row <= BWD_SMEM or steps == 1
    if b <= 2 and s >= BWD_STEPS:
        assert steps == BWD_STEPS
