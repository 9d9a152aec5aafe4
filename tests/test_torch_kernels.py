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
from repro_torch.kernels.bvsb import bvsb_plain
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.rglru_scan import rglru_scan_plain

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
    assert ops.launch_counts() == {"bvsb": 0, "flash_attention": 0,
                                   "decode_attention": 0, "rglru_scan": 0}


def test_other_devices_raise_instead_of_falling_back():
    x = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError):
        ops.bvsb(x)
    q = torch.zeros(1, 4, 2, 8, device="meta")
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        ops.decode_attention(q[:, 0], q, q, torch.ones(1, device="meta"))
    with pytest.raises(ValueError):
        ops.rglru_scan(q[0], q[0])


def test_cache_token_separates_devices():
    assert ops.cache_token("cpu") != ops.cache_token("cuda")
    assert ops.cache_token(torch.device("cuda", 0)) == ops.cache_token("cuda")
