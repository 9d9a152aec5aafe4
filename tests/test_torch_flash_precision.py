"""The precision scheme of the tensor-core attention kernels, emulated on
the CPU.

``csrc/flash_attention.cu`` (and ``csrc/decode_attention.cu`` alike) runs
f32 attention on TF32 tensor cores as
3xTF32: each operand x splits into hi = tf32(x) (round to nearest, ties
away from zero: add half a TF32 ulp, mask the low 13 bits) and lo = x - hi,
whose low 13 bits the tensor core drops; a product is hi.hi + hi.lo +
lo.hi accumulated in f32. Both products, Q.K^T and P.V (P unnormalised,
divided by the row sum at the end), go through it. Here the same split
runs in torch on numpy inputs and is held to the JAX package's
``flash_attention_ref`` within the card gate for f32 (1e-4, as in
``tests/test_torch_cuda_kernels.py``); one TF32 product per operand pair
(1xTF32) misses that gate by more than ten times. The decode kernel's
split-K form (partial softmax states over 32-key splits, merged by their
maxima) is held to ``decode_attention_plain`` the same way.
"""
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels.decode_attention import decode_attention_plain

torch.set_num_threads(2)

F32_GATE = 1e-4      # FLASH_ATOL[float32] of the card checks
LOW_BITS = 0x1FFF    # the 13 mantissa bits a TF32 operand does not carry


def tf32_round(x):
    """Round to TF32, nearest with ties away (cvt.rna.tf32.f32)."""
    return ((x.view(torch.int32) + 0x1000) & ~LOW_BITS).view(torch.float32)


def tf32_truncate(x):
    """What the tensor core reads of an operand that is not TF32."""
    return (x.view(torch.int32) & ~LOW_BITS).view(torch.float32)


def split(x):
    hi = tf32_round(x)
    return hi, tf32_truncate(x - hi)


def mm_3xtf32(a, b):
    """a @ b as the kernel's mma chain forms it: small terms, then hi.hi."""
    (ah, al), (bh, bl) = split(a), split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm_1xtf32(a, b):
    return tf32_round(a) @ tf32_round(b)


def attention(q, k, v, window, mm):
    """Causal GQA attention with both products taken by ``mm``; the
    softmax's numerator stays unnormalised through P.V, as in the kernel."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, hd).permute(0, 2, 3, 1, 4)
    kt = k.permute(0, 2, 3, 1)[:, :, None]          # (b, kv, 1, hd, s)
    vt = v.permute(0, 2, 1, 3)[:, :, None]          # (b, kv, 1, s, hd)
    scores = mm(qg, kt) * np.float32(1.0 / np.sqrt(hd))
    i = torch.arange(s)
    ok = i[None, :] <= i[:, None]
    if window is not None:
        ok &= (i[:, None] - i[None, :]) < window
    scores = scores.masked_fill(~ok, -1e30)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    out = mm(p, vt) / p.sum(-1, keepdim=True)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd)


# (B, S, H, KV, hd, window): RecurrentGemma's local attention (hd 256,
# 16 heads over 1) at a window of 64 over a few hundred positions, and
# the tiers' tier-server-heavy at S = 16
CASES = [(1, 300, 16, 1, 256, 64), (2, 200, 16, 1, 256, 64),
         (8, 16, 8, 8, 64, None)]


def _inputs(b, s, h, kv, hd):
    rng = np.random.default_rng(s * 1000 + hd + h)
    return (rng.standard_normal((b, s, n, hd)).astype(np.float32)
            for n in (h, kv, kv))


def _errors(case):
    b, s, h, kv, hd, window = case
    q, k, v = _inputs(b, s, h, kv, hd)
    ref = np.asarray(jref.flash_attention_ref(q, k, v, causal=True,
                                              window=window))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    return {name: float(np.abs(attention(tq, tk, tv, window, mm).numpy()
                               - ref).max())
            for name, mm in (("3xtf32", mm_3xtf32), ("1xtf32", mm_1xtf32))}


@pytest.mark.parametrize("case", CASES, ids=str)
def test_3xtf32_attention_within_the_f32_gate(case):
    err = _errors(case)["3xtf32"]
    assert err <= F32_GATE, err
    # about f32's own ordering error, with room: 2-3e-6 at these shapes
    assert err <= F32_GATE / 10, err


@pytest.mark.parametrize("case", CASES, ids=str)
def test_1xtf32_attention_misses_the_f32_gate(case):
    """One TF32 product per pair is off by 1.2-1.7e-3 at these shapes:
    12-17 times the gate, so f32 attention needs the split."""
    errs = _errors(case)
    assert errs["1xtf32"] > 10 * F32_GATE, errs
    assert errs["1xtf32"] > 100 * errs["3xtf32"], errs


def test_tf32_split_rounds_to_nearest_ties_away_and_is_exact():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.concatenate([
        rng.standard_normal(10_000) * 10.0 ** rng.integers(-20, 20, 10_000),
        [1.0, -1.0, 0.0, 3.0e38]]).astype(np.float32))
    hi, lo = split(x)
    bits = hi.view(torch.int32)
    assert torch.all((bits & LOW_BITS) == 0)
    assert torch.all((lo.view(torch.int32) & LOW_BITS) == 0)
    # nearest: within half a TF32 ulp (2^-11 of the leading bit)
    x64, hi64 = x.double(), hi.double()
    assert torch.all((x64 - hi64).abs() <= x64.abs() * 2.0 ** -11)
    # hi + lo keeps x to 2^-21 of its size: the bits after lo's 11 dropped
    assert torch.all((x64 - hi64 - lo.double()).abs()
                     <= x64.abs() * 2.0 ** -21)
    # a tie (exactly half an ulp above 1 and below -1) rounds away from 0
    one_half_ulp = torch.tensor([0x3F801000, -0x407FF000],
                                dtype=torch.int32).view(torch.float32)
    assert tf32_round(one_half_ulp).tolist() == [1.0 + 2.0 ** -10,
                                                 -(1.0 + 2.0 ** -10)]


def test_tf32_products_are_exact_in_f32():
    """11-bit significands multiply into 22 bits: each of the three
    products the tensor core forms is exact before it is accumulated."""
    rng = np.random.default_rng(1)
    a, b = (split(torch.from_numpy(rng.standard_normal(4096)
                                   .astype(np.float32))) for _ in range(2))
    for x in a:
        for y in b:
            assert torch.equal((x * y).double(), x.double() * y.double())


def decode(q, k, v, lengths, mm, split=32):
    """One-token GQA attention over the first ``lengths`` slots, both
    products taken by ``mm``, as the decode kernel forms it: per split of
    ``split`` keys the unnormalised (m, l, acc), then the splits merged by
    their maxima."""
    b, h, hd = q.shape
    w, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, kvh, h // kvh, hd)
    scores = mm(qg, k.permute(0, 2, 3, 1)) * np.float32(1.0 / np.sqrt(hd))
    valid = torch.arange(w)[None, :] < lengths[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], -1e30)
    vt = v.permute(0, 2, 1, 3)                       # (b, kv, w, hd)
    ms, ls, accs = [], [], []
    for k0 in range(0, w, split):
        s = scores[..., k0:k0 + split]
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        ms.append(m)
        ls.append(p.sum(-1, keepdim=True))
        accs.append(mm(p, vt[:, :, k0:k0 + split]))
    mx = torch.stack(ms).amax(0)
    weights = [torch.exp(m - mx) for m in ms]
    out = sum(a * wt for a, wt in zip(accs, weights)) \
        / sum(l * wt for l, wt in zip(ls, weights))
    return out.reshape(b, h, hd)


# (B, H, KV, hd, W, lengths): RecurrentGemma's decode (16 query heads over
# one KV head of 256) at a reduced ring, and over two KV heads
DECODE_CASES = [(2, 16, 1, 256, 256, [256, 100]),
                (2, 32, 2, 256, 128, [128, 65])]


def _decode_errors(case):
    b, h, kv, hd, w, lengths = case
    rng = np.random.default_rng(w + h)
    q = torch.from_numpy(rng.standard_normal((b, h, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, w, kv, hd))
                             .astype(np.float32)) for _ in range(2))
    lens = torch.tensor(lengths)
    ref = decode_attention_plain(q, k, v, lens)
    return {name: float((decode(q, k, v, lens, mm) - ref).abs().max())
            for name, mm in (("3xtf32", mm_3xtf32), ("1xtf32", mm_1xtf32))}


@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
def test_3xtf32_decode_within_the_f32_gate(case):
    err = _decode_errors(case)["3xtf32"]
    assert err <= F32_GATE / 10, err


@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
def test_1xtf32_decode_misses_the_f32_gate(case):
    errs = _decode_errors(case)
    assert errs["1xtf32"] > F32_GATE, errs
    assert errs["1xtf32"] > 10 * errs["3xtf32"], errs
