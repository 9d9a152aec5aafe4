"""Decode attention over a ring cut on its W slots: the plain versions of
the decode kernel's partial and merge entries held to the whole-ring
``decode_attention_plain`` and to the JAX package's
``kernels/ref.py::decode_attention_ref``.

Rank j of m holds slots [j W/m, (j + 1) W/m) of every KV head; each rank's
partials buffer is zero but for its splits, so the buffers' sum is the
gather the mesh does with an all_reduce. Tolerance: 1e-5 absolute in
float32, tighter than the kernels' NUMERIC_ATOL of 2e-3 (the same float32
softmax, its sums in another order); bf16 outputs 2e-2 (rounded once).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import (
    MAX_SPLITS, decode_attention_merge_plain, decode_attention_partials_plain,
    decode_attention_plain, partials_rows, shard_splits)

torch.set_num_threads(2)

ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _ring(b, w, kvh, g, hd, seed, qd=torch.float32, cd=torch.float32):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, kvh * g, hd)).astype(
        np.float32) * 2).to(qd)
    k, v = (torch.from_numpy(rng.standard_normal((b, w, kvh, hd)).astype(
        np.float32)).to(cd) for _ in range(2))
    return q, k, v


def _sharded(q, k, v, lengths, m, soft_cap=None, n_splits=1):
    """Every rank's partials over its shard, summed (the gather), merged."""
    ws = k.shape[1] // m
    parts = sum(decode_attention_partials_plain(
        q, k[:, j * ws:(j + 1) * ws], v[:, j * ws:(j + 1) * ws], lengths,
        j, m, soft_cap, n_splits) for j in range(m))
    return decode_attention_merge_plain(parts, q, k.shape[2])


# (B, W, KV, G, hd): RecurrentGemma's ring (one KV head of 16 query heads),
# a small GQA ring, a group of one
SHAPES = [(3, 128, 1, 16, 64), (4, 40, 2, 4, 32), (2, 64, 4, 1, 16)]


@pytest.mark.parametrize("m", [1, 2, 4, 8])
@pytest.mark.parametrize("b,w,kvh,g,hd", SHAPES)
def test_shard_partials_merged_equal_the_whole_ring(m, b, w, kvh, g, hd):
    """Any cut m, lengths that leave shards empty (1 slot, a prompt of 8 in
    a ring of 128: three of four ranks empty), a partly filled ring and a
    full (wrapped) one; one split a shard and several."""
    q, k, v = _ring(b, w, kvh, g, hd, seed=m * 7 + w)
    lengths = torch.tensor(([1, 8, w // 2 + 3, w] * 2)[:b])
    want = decode_attention_plain(q, k, v, lengths)
    for n in (1, 3):
        got = _sharded(q, k, v, lengths, m, n_splits=n)
        assert got.dtype == q.dtype and got.shape == want.shape
        torch.testing.assert_close(got, want, atol=ATOL[torch.float32],
                                   rtol=0)
    jwant = jref.decode_attention_ref(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(
            v.numpy()), jnp.asarray(lengths.numpy()))
    np.testing.assert_allclose(_sharded(q, k, v, lengths, m).numpy(),
                               np.asarray(jwant), atol=ATOL[torch.float32])


@pytest.mark.parametrize("m", [1, 2, 4, 8])
@pytest.mark.parametrize("qd,cd", [(torch.float32, torch.bfloat16),
                                   (torch.bfloat16, torch.bfloat16)])
def test_shard_partials_over_bf16_rings_and_soft_cap(m, qd, cd):
    """f32 q over bf16 rings (the JAX package's default cache), bf16
    throughout, each with and without Gemma 2's cap of 50."""
    q, k, v = _ring(3, 64, 2, 4, 32, seed=m, qd=qd, cd=cd)
    q = q * 8                     # scores past the cap
    lengths = torch.tensor([1, 30, 64])
    for cap in (None, 50.0):
        want = decode_attention_plain(q, k, v, lengths, soft_cap=cap)
        got = _sharded(q, k, v, lengths, m, soft_cap=cap, n_splits=2)
        assert got.dtype == qd
        torch.testing.assert_close(got.float(), want.float(), atol=ATOL[qd],
                                   rtol=0)


def test_an_empty_shard_writes_nothing_that_weighs():
    """A shard past the length: m = -1e30, l = 0, acc = 0 in its splits,
    zeros elsewhere; merged with the filled shard it changes no bit, and
    no NaN comes from exp(-1e30 - (-1e30)) where every split is empty."""
    q, k, v = _ring(2, 64, 1, 4, 16, seed=3)
    lengths = torch.tensor([5, 32])
    empty = decode_attention_partials_plain(q, k[:, 32:], v[:, 32:], lengths,
                                            1, 2, n_splits=2)
    rows = partials_rows(2, 1, 4, 4)
    m, l, acc = empty[:rows], empty[rows:2 * rows], empty[2 * rows:]
    m = m.view(2, 1, 4, 4)
    assert torch.all(m[:, :, 2:] == -1e30) and torch.all(m[:, :, :2] == 0)
    assert torch.all(l == 0) and torch.all(acc == 0)
    full = decode_attention_partials_plain(q, k[:, :32], v[:, :32], lengths,
                                           0, 2, n_splits=2)
    alone = decode_attention_merge_plain(full, q, 1)
    both = decode_attention_merge_plain(full + empty, q, 1)
    assert torch.equal(alone, both)
    assert not torch.isnan(both).any()
    torch.testing.assert_close(both, decode_attention_plain(
        q, k, v, lengths), atol=ATOL[torch.float32], rtol=0)


class _Elsewhere(torch.Tensor):
    @property
    def device(self):
        return torch.device("xpu")


def test_ops_take_the_plain_versions_on_the_cpu_without_launching():
    q, k, v = _ring(2, 32, 2, 2, 16, seed=4)
    lengths = torch.tensor([3, 32])
    ops.reset_launch_counts()
    parts = ops.decode_attention_partials(q, k[:, 8:16], v[:, 8:16], lengths,
                                          1, 4)
    assert torch.equal(parts, decode_attention_partials_plain(
        q, k[:, 8:16], v[:, 8:16], lengths, 1, 4))
    assert torch.equal(ops.decode_attention_merge(parts, q, 2),
                       decode_attention_merge_plain(parts, q, 2))
    assert ops.launch_counts()["decode_attention_partials"] == 0
    assert ops.launch_counts()["decode_attention_merge"] == 0
    # a device with neither a kernel nor a plain version ("xpu"; ``meta``
    # is served since the dry-run: tests/test_torch_roofline.py)
    other = torch.zeros(2, 4, 16).as_subclass(_Elsewhere)
    with pytest.raises(ValueError):
        ops.decode_attention_partials(other, other[:, None], other[:, None],
                                      lengths)
    with pytest.raises(ValueError):
        ops.decode_attention_merge(other.flatten(), other, 2)
    with pytest.raises(ValueError, match="no partials buffer"):
        decode_attention_merge_plain(parts[:-1], q, 2)


@pytest.mark.parametrize("b,kvh,w,sms,ranks", [
    (4, 1, 512, 132, 4), (4, 8, 516, 132, 4), (64, 1, 512, 132, 4),
    (1, 1, 4096, 132, 16), (4, 1, 2048, 132, 1), (2, 4, 5, 132, 2)])
def test_shard_splits_fit_the_merge(b, kvh, w, sms, ranks):
    """A rank's plan: whole tiles covering its shard, none empty, m ranks'
    splits within the merge's MAX_SPLITS, a split at least SHARD_MIN_KEYS
    slots where the shard has them, and no more splits than the
    whole-ring plan of the shard would make."""
    from repro_torch.kernels.decode_attention import SHARD_MIN_KEYS, splits
    ns, chunk = shard_splits(b, kvh, w, sms, ranks)
    assert chunk % 16 == 0 and ns * chunk >= w > (ns - 1) * chunk
    assert ranks * ns <= MAX_SPLITS
    assert chunk >= min(SHARD_MIN_KEYS, 16 * -(-w // 16))
    assert ns <= splits(b, kvh, w, sms)[0]
