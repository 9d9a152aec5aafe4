"""The CUDA kernels held to their plain versions on the card.

Needs an NVIDIA GPU and ``nvcc`` (the kernels build from
``src/repro_torch/kernels/csrc`` on first use); every test here skips on
a machine without a card. Imports no JAX, so it runs where JAX is absent:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.cascade_tiers import BATCH_LADDER
from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import rglru_scan as _rglru
from repro_torch.kernels.bvsb import bvsb_plain, chunks
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.rglru_scan import rglru_scan_plain
from repro_torch.launch.distributed import make_prefill_step, make_serve_step
from repro_torch.models.model import init_params

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)

F32_CONF_ATOL = 1e-5   # float32 sums taken in another order
BF16_CONF_ATOL = 2e-3  # the repo's kernel gate (NUMERIC_ATOL)
FLASH_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DECODE_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _check_bvsb(x, atol):
    ops.reset_launch_counts()
    conf, top1 = ops.bvsb(x)
    torch.cuda.synchronize()
    assert ops.launch_counts()["bvsb"] == 1
    pconf, ptop1 = bvsb_plain(x)
    assert conf.dtype == torch.float32 and top1.dtype == torch.int32
    torch.testing.assert_close(conf, pconf, atol=atol, rtol=0,
                               equal_nan=True)
    assert torch.equal(top1, ptop1.to(top1.device))


@pytest.mark.parametrize("b,v", [(1, 2048), (64, 2048), (20, 1000), (3, 130)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bvsb_kernel_matches_plain(dev, b, v, dtype):
    gen = torch.Generator(device=dev).manual_seed(b * 4096 + v)
    x = (torch.randn(b, v, generator=gen, device=dev) * 4).to(dtype)
    _check_bvsb(x, F32_CONF_ATOL if dtype == torch.float32 else BF16_CONF_ATOL)


def test_bvsb_kernel_ties_extremes_and_strides(dev):
    x = torch.full((6, 2048), -1.0, device=dev)
    x[0, [7, 1999]] = 3.0     # tied maxima in different warps
    x[1, [0, 1]] = 2.5        # tied maxima in neighbouring threads
    x[2] = 0.0                # fully tied row
    x[3] = -1e38
    x[3, 5] = 1e4
    x[4, :10] = float("-inf")
    x[4, 11] = 2.0
    x[5, 1000:] = torch.finfo(torch.float32).min   # LM-head padding
    _check_bvsb(x, F32_CONF_ATOL)
    conf, top1 = ops.bvsb(x)
    assert conf[:3].abs().max() == 0 and top1[:3].tolist() == [7, 0, 0]
    # the classify path hands the kernel a strided (B, V) view
    logits = torch.randn(4, 16, 2048, device=dev)
    _check_bvsb(logits[:, -1, :], F32_CONF_ATOL)


@pytest.mark.parametrize("b", BATCH_LADDER)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bvsb_kernel_serving_buckets(dev, b, dtype):
    # the classify path's input at every ladder bucket: the last position
    # of (B, S, V) logits, a view with row stride S * V
    gen = torch.Generator(device=dev).manual_seed(b)
    logits = (torch.randn(b, 16, 2048, generator=gen, device=dev) * 4).to(dtype)
    _check_bvsb(logits[:, -1, :],
                F32_CONF_ATOL if dtype == torch.float32 else BF16_CONF_ATOL)


def test_bvsb_kernel_pos_inf_is_nan(dev):
    x = torch.zeros(2, 64, device=dev)
    x[0, 3] = float("inf")
    x[1, [5, 9]] = float("inf")
    conf, _ = ops.bvsb(x)
    assert torch.isnan(conf).all() and torch.isnan(bvsb_plain(x)[0]).all()


def _bits(t):
    return t.contiguous().view(torch.int32)


def _bvsb_twice(x, atol):
    """The kernel against its plain version (top-1 on the rows whose
    confidence is a number: a row with +inf is NaN in both, and the plain
    argmax of a NaN row means nothing), and a second call on the same input
    bitwise equal to the first."""
    conf, top1 = ops.bvsb(x)
    pconf, ptop1 = bvsb_plain(x)
    torch.testing.assert_close(conf, pconf, atol=atol, rtol=0, equal_nan=True)
    finite = ~torch.isnan(pconf)
    assert torch.equal(top1[finite], ptop1[finite])
    conf2, top2 = ops.bvsb(x)
    assert torch.equal(_bits(conf), _bits(conf2)) and torch.equal(top1, top2)
    return conf, top1


@pytest.mark.parametrize("b", [4, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bvsb_kernel_edges_across_chunks(dev, b, dtype):
    """Rows of 256,000 take several chunk blocks: tied maxima in the first
    and the last chunk (columns 7 and 255,993), the second chunk all -inf,
    +inf in the last chunk."""
    n, per = chunks(b, 256_000, _build.sm_count(dev))
    assert n > 2 and 255_990 // per == n - 1   # +inf in the last chunk
    gen = torch.Generator(device=dev).manual_seed(b)
    x = torch.randn(b, 256_000, generator=gen, device=dev) * 4
    x[0, [7, 255_993]] = 30.0
    x[1, per:2 * per] = float("-inf")
    x[2, 255_990] = float("inf")
    x = x.to(dtype)
    conf, top1 = _bvsb_twice(
        x, F32_CONF_ATOL if dtype == torch.float32 else BF16_CONF_ATOL)
    assert float(conf[0]) == 0.0 and int(top1[0]) == 7
    assert torch.isfinite(conf[1]) and torch.isnan(conf[2])


@pytest.mark.parametrize("b,v", [(4, 256_000), (64, 256_000), (8, 2048),
                                 (3, 130)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bvsb_kernel_rows_off_alignment(dev, b, v, dtype):
    """A [:, 1:] view: every row starts 4 (2) bytes past a 16-byte
    boundary, so each chunk has a scalar head and tail around its vectors."""
    gen = torch.Generator(device=dev).manual_seed(v + b)
    x = (torch.randn(b, v + 1, generator=gen, device=dev) * 4).to(dtype)
    _bvsb_twice(x[:, 1:],
                F32_CONF_ATOL if dtype == torch.float32 else BF16_CONF_ATOL)


FLASH_CASES = [(1, 16, 4, 4, 32, None), (64, 16, 8, 8, 48, None),
               (64, 16, 8, 8, 64, None), (2, 200, 8, 2, 128, None),
               (2, 200, 8, 2, 64, 40), (3, 37, 4, 1, 48, 7),
               # RecurrentGemma's local attention: 16 heads over 1 of 256
               (1, 300, 16, 1, 256, 128), (2, 77, 8, 2, 256, None),
               (1, 1000, 16, 1, 256, 512),
               # both sides of the tensor-core threshold (S 48 at hd <=
               # 128, 80 above) at hd 64, 128 and 256: GQA 16:1 and 4:1,
               # windows under one 32-key tile and off its multiples, S
               # off the 32-key and 128-row tiles
               (2, 40, 8, 2, 64, 20), (2, 48, 8, 2, 64, 20),
               (2, 1000, 8, 2, 64, 100), (1, 1000, 16, 1, 64, 7),
               (1, 47, 16, 1, 128, None), (1, 1000, 16, 1, 128, 20),
               (1, 3000, 8, 2, 128, 2000), (2, 79, 16, 1, 256, 20),
               (2, 80, 16, 1, 256, 20), (1, 1000, 8, 2, 256, 100),
               (1, 999, 16, 1, 256, None)]


# every attention shape of the live cascade: tier-low at the clients'
# B = 1, each server tier at every ladder bucket
SERVING_FLASH_CASES = [
    (b, 16, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, None)
    for tier, buckets in (("tier-low", (1,)),
                          ("tier-server-fast", BATCH_LADDER),
                          ("tier-server-heavy", BATCH_LADDER))
    for cfg in (get_config(tier),) for b in buckets]


@pytest.mark.parametrize("b,s,h,kv,hd,window",
                         FLASH_CASES + SERVING_FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(dev, b, s, h, kv, hd, window, dtype):
    gen = torch.Generator(device=dev).manual_seed(s * 1000 + hd)
    q = torch.randn(b, s, h, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, s, kv, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, s, kv, hd, generator=gen, device=dev).to(dtype)
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = flash_attention_plain(q, k, v, causal=True, window=window)
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=FLASH_ATOL[dtype], rtol=0)


@pytest.mark.parametrize("s", [24, 300])
def test_flash_kernel_non_causal_and_strided(dev, s):
    qkv = torch.randn(2, s, 3, 4, 32, device=dev)       # packed q/k/v
    q, k, v = qkv.unbind(dim=2)                         # strided views
    out = ops.flash_attention(q, k, v, causal=False)
    ref = flash_attention_plain(q, k, v, causal=False)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("s", [40, 1000])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_strided_heads_both_sides(dev, s, offset, dtype):
    """(B, S, H) strides of a packed tensor; offset 1 moves every row start
    off 16 bytes, so the tensor-core kernel loads without cp.async."""
    packed = torch.randn(2, s, 3, 8, 65, device=dev).to(dtype)
    q, k, v = (packed[:, :, i, :, offset:offset + 64] for i in range(3))
    k, v = k[:, :, :2], v[:, :, :2]
    out = ops.flash_attention(q, k, v, window=100)
    ref = flash_attention_plain(q, k, v, window=100)
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=FLASH_ATOL[dtype], rtol=0)


@pytest.mark.parametrize("b,s,h,kv,hd,window",
                         [(64, 16, 8, 8, 64, None), (2, 63, 16, 1, 256, 20),
                          (2, 47, 8, 2, 128, None), (1, 200, 16, 1, 256, 7),
                          (3, 37, 4, 1, 48, 7)])
@pytest.mark.parametrize("kernel", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_both_kernels_match_plain(dev, b, s, h, kv, hd, window, kernel,
                                        dtype):
    """The CUDA-core (1) and tensor-core (2) kernels forced at shapes
    around the threshold, through the library's measuring entry."""
    gen = torch.Generator(device=dev).manual_seed(s * 1000 + hd)
    q = torch.randn(b, s, h, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, s, kv, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, s, kv, hd, generator=gen, device=dev).to(dtype)
    out = _flash.run_entry(_build.library().repro_flash_attention_kernel,
                           q, k, v, window=window, extra=(kernel,))
    torch.cuda.synchronize()
    ref = flash_attention_plain(q, k, v, window=window)
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=FLASH_ATOL[dtype], rtol=0)


# (B, W, KV, G, hd, lengths): RecurrentGemma's decode (W 2048, one KV head
# of 256 for 16 query heads) and a small GQA ring
DECODE_CASES = [
    (1, 2048, 1, 16, 256, [1]), (1, 2048, 1, 16, 256, [2048]),
    (4, 2048, 1, 16, 256, [1, 777, 2048, 1500]),
    (64, 2048, 1, 16, 256, None),
    (3, 100, 2, 4, 64, [1, 100, 37]), (2, 100, 2, 4, 128, [99, 64]),
]


@pytest.mark.parametrize("b,w,kvh,g,hd,lengths", DECODE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain(dev, b, w, kvh, g, hd, lengths, dtype):
    gen = torch.Generator(device=dev).manual_seed(b * w + hd)
    q = torch.randn(b, kvh * g, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, w, kvh, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, w, kvh, hd, generator=gen, device=dev).to(dtype)
    lens = torch.tensor(lengths, device=dev) if lengths else \
        torch.randint(1, w + 1, (b,), generator=gen, device=dev)
    ops.reset_launch_counts()
    out = ops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert ops.launch_counts()["decode_attention"] == 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = decode_attention_plain(q, k, v, lens)
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=DECODE_ATOL[dtype], rtol=0)


# lengths on both sides of the 16-key tiles and of the splits, at hd 256:
# RecurrentGemma's group of 16 over one KV head and over two (a split's K
# rows then not contiguous), groups of 8 and 4; and the RG path's shape
DECODE_EDGE_CASES = [(5, 2048, kvh, g, 256, [1, 63, 65, 2047, 2048])
                     for kvh, g in ((1, 16), (2, 16), (1, 8), (2, 4))] + [
    (4, 2048, 1, 16, 256, [1, 777, 2048, 1500])]


@pytest.mark.parametrize("b,w,kvh,g,hd,lengths", DECODE_EDGE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_edges_nan_past_the_length_and_repeatable(
        dev, b, w, kvh, g, hd, lengths, dtype):
    """Held to the plain version; a second call and a call with NaN in
    every slot at or past the length (never read) are bitwise equal."""
    gen = torch.Generator(device=dev).manual_seed(b * w + hd + g)
    q = torch.randn(b, kvh * g, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, w, kvh, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, w, kvh, hd, generator=gen, device=dev).to(dtype)
    lens = torch.tensor(lengths, device=dev)
    out = ops.decode_attention(q, k, v, lens)
    torch.testing.assert_close(
        out.float(), decode_attention_plain(q, k, v, lens).float(),
        atol=DECODE_ATOL[dtype], rtol=0)
    assert torch.equal(ops.decode_attention(q, k, v, lens), out)
    past = torch.arange(w, device=dev)[None, :] >= lens[:, None]
    k[past], v[past] = float("nan"), float("nan")
    assert torch.equal(ops.decode_attention(q, k, v, lens), out)


@pytest.mark.parametrize("hd,offset", [(48, 0), (64, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_plain_load_path(dev, hd, offset, dtype):
    """A head dim under the tile row (48 of 64), or cache rows that start
    one element past 16 bytes (views into a wider tensor), take the
    kernel's plain loads instead of cp.async."""
    gen = torch.Generator(device=dev).manual_seed(hd + offset)
    q = torch.randn(3, 8, hd, generator=gen, device=dev).to(dtype)
    kv = torch.randn(3, 100, 2, 2, hd + 1, generator=gen,
                     device=dev).to(dtype)
    k = kv[:, :, :, 0, offset:offset + hd]
    v = kv[:, :, :, 1, offset:offset + hd]
    lens = torch.tensor([1, 100, 37], device=dev)
    out = ops.decode_attention(q, k, v, lens)
    torch.testing.assert_close(
        out.float(), decode_attention_plain(q, k, v, lens).float(),
        atol=DECODE_ATOL[dtype], rtol=0)
    past = torch.arange(100, device=dev)[None, :] >= lens[:, None]
    k[past], v[past] = float("nan"), float("nan")
    assert torch.equal(ops.decode_attention(q, k, v, lens), out)


@pytest.mark.parametrize("b,w,kvh,g,hd,lengths",
                         DECODE_CASES + [(3, 100, 2, 4, 48, [1, 100, 37])])
def test_decode_kernel_f32_query_over_bf16_cache(dev, b, w, kvh, g, hd,
                                                 lengths):
    """An f32 model over the JAX package's default bf16 cache: f32 out,
    held to the plain version (f32 math over the widened cache) at the
    f32 gate; the bf16 cache is read as it is, with no f32 copy."""
    gen = torch.Generator(device=dev).manual_seed(b * w + hd + 1)
    q = torch.randn(b, kvh * g, hd, generator=gen, device=dev)
    k, v = (torch.randn(b, w, kvh, hd, generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    lens = torch.tensor(lengths, device=dev) if lengths else \
        torch.randint(1, w + 1, (b,), generator=gen, device=dev)
    ops.reset_launch_counts()
    out = ops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert ops.launch_counts()["decode_attention"] == 1
    assert out.dtype == torch.float32 and out.shape == q.shape
    torch.testing.assert_close(out, decode_attention_plain(q, k, v, lens),
                               atol=DECODE_ATOL[torch.float32], rtol=0)
    assert torch.equal(ops.decode_attention(q, k, v, lens), out)
    past = torch.arange(w, device=dev)[None, :] >= lens[:, None]
    k[past], v[past] = float("nan"), float("nan")
    assert torch.equal(ops.decode_attention(q, k, v, lens), out)


def test_decode_kernel_refuses_other_dtype_mixes(dev):
    q = torch.randn(2, 16, 64, device=dev)
    kv = torch.randn(2, 32, 1, 64, device=dev)
    lens = torch.tensor([32, 5], device=dev)
    for qd, kd, vd in ((torch.bfloat16, torch.float32, torch.float32),
                       (torch.float32, torch.bfloat16, torch.float32),
                       (torch.float16, torch.float16, torch.float16)):
        with pytest.raises(TypeError):
            ops.decode_attention(q.to(qd), kv.to(kd), kv.to(vd), lens)


def test_kernel_wrappers_read_the_sm_count_once(dev, monkeypatch):
    """The grid plans of decode attention and BvSB read the SM count from
    a per-device cache, not from a property query on every call."""
    q = torch.randn(2, 16, 256, device=dev)
    kv = torch.randn(2, 64, 1, 256, device=dev)
    lens = torch.tensor([64, 5], device=dev)
    x = torch.randn(2, 40_000, device=dev)
    ops.decode_attention(q, kv, kv, lens), ops.bvsb(x)

    def refuse(*args, **kw):
        raise AssertionError("device properties queried per call")
    monkeypatch.setattr(torch.cuda, "get_device_properties", refuse)
    ops.decode_attention(q, kv, kv, lens), ops.bvsb(x)


def test_decode_kernel_strided_query_and_masked_slots(dev):
    qkv = torch.randn(2, 3, 8, 64, device=dev)
    q = qkv[:, 0]                                   # (B, H, hd), strided
    k = torch.randn(2, 128, 2, 64, device=dev)
    v = torch.randn(2, 128, 2, 64, device=dev)
    lens = torch.tensor([5, 128], device=dev)
    out = ops.decode_attention(q, k, v, lens)
    k[0, 5:] = float("nan")                         # never read
    v[0, 5:] = float("nan")
    out2 = ops.decode_attention(q, k, v, lens)
    assert torch.equal(out, out2)
    torch.testing.assert_close(
        out[1], decode_attention_plain(q, k, v, lens)[1], atol=1e-4, rtol=0)


def _rglru_inputs(dev, b, s, d, view, dtype, with_h0):
    """a, u (B, S, D) in ``dtype``, cut to ``view`` after the cast: None
    (contiguous), "offset" ([:, :, 1:], the base 4 or 2 bytes off 16) or
    "time" ([:, ::2], strided in time); h0 (B, D') f32 or None."""
    gen = torch.Generator(device=dev).manual_seed(s * d)
    a = torch.rand(b, s, d, generator=gen, device=dev) * 0.5 + 0.499
    a = a.to(dtype)
    u = torch.randn(b, s, d, generator=gen, device=dev).to(dtype)
    if view == "offset":
        a, u = a[:, :, 1:], u[:, :, 1:]
    elif view == "time":
        a, u = a[:, ::2], u[:, ::2]
    h0 = torch.randn(b, a.shape[2], generator=gen, device=dev) \
        if with_h0 else None
    return a, u, h0


@pytest.mark.parametrize("b,s,d,view,ring", [
    (1, 1, 256, None, (True, True)),        # S under one tile
    (1, 7, 256, None, (True, True)),
    (3, 129, 300, None, (True, False)),     # D off a strip; bf16 off 16 B
    (2, 3000, 512, None, (True, True)),     # ragged last tile
    (2, 3000, 4100, None, (True, False)),
    (2, 300, 513, "offset", (False, False)),
    (2, 600, 512, "time", (True, True))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_kernel_matches_plain(dev, b, s, d, view, ring, dtype, with_h0):
    """Both round the product and the sum apart: equal bit for bit, on the
    ring and on the per-element path (``ring``: which one each dtype
    takes)."""
    a, u, h0 = _rglru_inputs(dev, b, s, d, view, dtype, with_h0)
    assert _rglru.is_aligned(a, u) == ring[dtype == torch.bfloat16]
    ops.reset_launch_counts()
    h = ops.rglru_scan(a, u, h0)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rglru_scan"] == 1
    assert h.dtype == torch.float32 and h.shape == a.shape
    assert torch.equal(h, rglru_scan_plain(a, u, h0))


def _scan_plans(elt):
    """Every (steps, stages) the plan gives at S = 3000, over batches,
    widths and SM counts."""
    return sorted({_rglru.tiles(b, 3000, d, elt, sms) for b in range(1, 257)
                   for d in (512, 4096) for sms in (132, 114, 8)})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_rglru_forced_plans_match_plain(dev, dtype):
    """Every ring the plan can give (3 tiles of 2 to 16 KB), four it
    cannot (7 and 24 steps a tile, no power of two; rings of 5 and 8
    tiles), and the per-element path, forced through ``run_entry`` at
    (2, 3000, 512): each bitwise equal to the plain loop, none counted.
    The ring is refused where its copies would be misaligned."""
    a, u, h0 = _rglru_inputs(dev, 2, 3000, 512, None, dtype, True)
    refs = {True: rglru_scan_plain(a, u, h0), False: rglru_scan_plain(a, u)}
    ref = refs[True]
    plans = _scan_plans(a.element_size())
    row = 2 * _rglru.STRIP * a.element_size()      # a and u bytes a step
    assert {(steps * row, stages) for steps, stages in plans} == {
        (2048, 3), (4096, 3), (8192, 3), (16384, 3)}
    ops.reset_launch_counts()
    for steps, stages in plans + [(7, 3), (24, 2), (8, 8), (16, 5)]:
        for with_h0 in (True, False):
            h = _rglru.run_entry(a, u, h0 if with_h0 else None, steps, stages)
            assert torch.equal(h, refs[with_h0]), (steps, stages, with_h0)
    assert torch.equal(_rglru.run_entry(a, u, h0, aligned=False), ref)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rglru_scan"] == 0
    with pytest.raises(RuntimeError, match="rglru_scan"):
        _rglru.run_entry(a[:, :, 1:], u[:, :, 1:], aligned=True)


def test_reduced_recurrentgemma_steps_on_the_card_match_the_cpu(dev):
    """Prefill past the window and 4 decode steps: card kernels against
    the CPU's plain versions on the same weights."""
    cfg = get_config("recurrentgemma-9b").reduced()
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 150),
                           generator=torch.Generator().manual_seed(1))
    runs = []
    for model in (card, cpu):
        ops.reset_launch_counts()
        conf, top1, cache = make_prefill_step(model)(tokens.to(model.device))
        serve, confs = make_serve_step(model), [conf.cpu()]
        for i in range(4):
            pos = torch.full((2,), 150 + i, device=model.device)
            conf, top1, cache = serve(top1[:, None], cache, pos)
            confs.append(conf.cpu())
        runs.append((torch.stack(confs), ops.launch_counts()))
    torch.testing.assert_close(runs[0][0], runs[1][0], atol=1e-5, rtol=0)
    assert runs[0][1] == {"bvsb": 5, "flash_attention": 1,
                          "decode_attention": 4, "rglru_scan": 2}
    assert runs[1][1] == dict.fromkeys(runs[1][1], 0)


def test_kernels_refuse_what_they_do_not_take(dev):
    q = torch.randn(1, 8, 2, 512, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="head dim"):
        ops.decode_attention(q[:, 0], q, q, torch.ones(1, device=dev).int())
    with pytest.raises(ValueError, match="KV heads"):
        qd = torch.randn(1, 32, 64, device=dev)
        kd = torch.randn(1, 16, 1, 64, device=dev)
        ops.decode_attention(qd, kd, kd, torch.ones(1, device=dev).int())
    with pytest.raises(ValueError, match="h0"):
        a = torch.rand(2, 4, 8, device=dev)
        ops.rglru_scan(a, a, torch.zeros(2, 8, device=dev).double())
    with pytest.raises(ValueError, match="channel"):
        a = torch.rand(2, 8, 4, device=dev).transpose(1, 2)
        ops.rglru_scan(a, a)
    q = torch.randn(1, 8, 2, 32, device=dev)
    with pytest.raises(TypeError):
        ops.flash_attention(q, q.half(), q)
    strided_hd = torch.randn(1, 8, 32, 2, device=dev).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(strided_hd, q, q)
    with pytest.raises(ValueError, match="column stride"):
        ops.bvsb(torch.randn(8, 4, device=dev).T)
    with pytest.raises(TypeError):
        ops.bvsb(torch.zeros(2, 8, dtype=torch.int32, device=dev))
    # float32 and bfloat16 only
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):
        ops.bvsb(torch.zeros(2, 8, dtype=torch.float16, device=dev))
