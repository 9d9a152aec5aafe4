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
from repro_torch.kernels import _build, moe_route, ops
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import rglru_scan as _rglru
from repro_torch.kernels.bvsb import bvsb_partials_plain, bvsb_plain, chunks
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import (attention_lse_plain,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_plain)
from repro_torch.kernels.rglru_scan import (rglru_scan_bwd_plain,
                                            rglru_scan_plain)
from repro_torch.launch.distributed import make_prefill_step, make_serve_step
from repro_torch.models import common, moe
from repro_torch.models.model import init_params

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)

F32_CONF_ATOL = 1e-5   # float32 sums taken in another order
BF16_CONF_ATOL = 2e-3  # the repo's kernel gate (NUMERIC_ATOL)
FLASH_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DECODE_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
MOE_ATOL = 1e-4        # float32 expert products in another order
# the backward kernels: max |err| over max |ref|, f32 sums in another
# order; bf16 outputs rounded once each
FLASH_BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LSE_ATOL = 1e-4        # the forward's row log-sum-exp, f32
ROUTE_GAP = 1e-6       # router probabilities closer than this may swap


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


@pytest.mark.parametrize("b,v,offset", [(4, 12320, 36960), (64, 12320, 0),
                                         (3, 130, 7), (4, 65536, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bvsb_partials_kernel_matches_plain(dev, b, v, offset, dtype):
    """The partial entry's tuples against its plain version: m1, m2 and the
    global index exact, z to float32 sums in another order; a second call
    bitwise equal; one counted launch."""
    gen = torch.Generator(device=dev).manual_seed(v + b)
    x = (torch.randn(b, v, generator=gen, device=dev) * 4).to(dtype)
    x[0, v // 2:] = -1e30                # padded columns
    if v >= 65536:
        x[1, :v // 2] = float("-inf")    # whole chunks at -inf
    ops.reset_launch_counts()
    t = ops.bvsb_partials(x, offset)
    torch.cuda.synchronize()
    assert ops.launch_counts()["bvsb_partials"] == 1
    ref = bvsb_partials_plain(x, offset)
    assert torch.equal(t[:, [0, 1, 3]].cpu(), ref[:, [0, 1, 3]].cpu())
    torch.testing.assert_close(t[:, 2], ref[:, 2], rtol=1e-5, atol=0)
    assert torch.equal(t, ops.bvsb_partials(x, offset))


@pytest.mark.parametrize("n", [2, 4, 7])
def test_bvsb_merge_kernel_over_shards_is_one_device_bvsb(dev, n):
    """Rows cut into n shards, the partial entry on each, the merge entry
    over the tuples: one-device BvSB (a maximum tied across shards gives
    margin 0 at the first index), a second call bitwise equal."""
    gen = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(8, 4096, generator=gen, device=dev) * 4
    x[0, [5, 4000]] = 30.0
    per = 4096 // n + 1
    parts = torch.stack([ops.bvsb_partials(x[:, a:a + per].contiguous(), a)
                         for a in range(0, 4096, per)], dim=1)
    ops.reset_launch_counts()
    conf, top1 = ops.bvsb_merge(parts)
    torch.cuda.synchronize()
    assert ops.launch_counts()["bvsb_merge"] == 1
    pconf, ptop1 = bvsb_plain(x)
    torch.testing.assert_close(conf, pconf, atol=F32_CONF_ATOL, rtol=0)
    assert torch.equal(top1, ptop1)
    assert float(conf[0]) == 0.0 and int(top1[0]) == 5
    c2, t2 = ops.bvsb_merge(parts)
    assert torch.equal(conf, c2) and torch.equal(top1, t2)


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


# (B, S, T, H, KV, hd): non-causal attention of S queries over T keys:
# seamless-m4t-medium's cross-attention (512 text positions over 1,024
# frames), both sides of the tensor-core threshold, edges off the tiles
CROSS_CASES = [(4, 512, 1024, 16, 16, 64), (2, 77, 300, 8, 2, 64),
               (2, 300, 77, 8, 2, 64), (1, 16, 40, 4, 4, 32),
               (1, 40, 16, 4, 1, 128), (2, 100, 333, 16, 1, 256)]


@pytest.mark.parametrize("b,s,t,h,kv,hd", CROSS_CASES)
@pytest.mark.parametrize("kernel", [0, 1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_over_other_key_lengths(dev, b, s, t, h, kv, hd, kernel,
                                             dtype):
    """k/v of T != S keys, non-causal: through ``ops`` (kernel 0, the
    shape's pick, one counted launch) and with each kernel forced, against
    the plain version, and a second call bitwise equal."""
    gen = torch.Generator(device=dev).manual_seed(s * 1000 + t)
    q = torch.randn(b, s, h, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, t, kv, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, t, kv, hd, generator=gen, device=dev).to(dtype)

    def run():
        if kernel == 0:
            return ops.flash_attention(q, k, v, causal=False)
        return _flash.run_entry(_build.library().repro_flash_attention_kernel,
                                q, k, v, causal=False, extra=(kernel,))
    ops.reset_launch_counts()
    out = run()
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == int(kernel == 0)
    assert out.dtype == dtype and out.shape == q.shape
    ref = flash_attention_plain(q, k, v, causal=False)
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=FLASH_ATOL[dtype], rtol=0)
    assert torch.equal(run(), out)


def test_flash_kernel_refuses_causal_over_other_key_lengths(dev):
    q = torch.randn(1, 64, 4, 64, device=dev)
    k = torch.randn(1, 100, 4, 64, device=dev)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="causal"):
        ops.flash_attention(q, k, k)
    assert ops.launch_counts()["flash_attention"] == 0
    assert not _flash.uses_tensor_cores(40, 64, 1000)
    assert _flash.uses_tensor_cores(512, 64, 1024)
    assert _flash.uses_tensor_cores(64, 64) == _flash.uses_tensor_cores(
        64, 64, 64)


@pytest.mark.parametrize("arch,inputs", [("xlstm-350m", 0),
                                         ("seamless-m4t-medium", 48)])
def test_reduced_xlstm_and_encdec_steps_on_the_card_match_the_cpu(dev, arch,
                                                                  inputs):
    """Prefill of 2 x 32 tokens (seamless over 48 audio frames) and 4
    decode steps: the card's kernels against the CPU's plain versions on
    the same weights, BvSB within 1e-5; and the launches: BvSB only for
    xLSTM; flash over frames, decoder self and cross for seamless, and
    decode for self and cross."""
    cfg = get_config(arch).reduced()
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen)
    audio = torch.randn(2, inputs, cfg.d_model, generator=gen) \
        if inputs else None
    runs = []
    for model in (card, cpu):
        ops.reset_launch_counts()
        conf, top1, cache = make_prefill_step(model)(
            tokens.to(model.device), audio_embeds=None if audio is None
            else audio.to(model.device))
        serve, confs = make_serve_step(model), [conf.cpu()]
        for i in range(4):
            pos = torch.full((2,), 32 + i, device=model.device)
            conf, top1, cache = serve(top1[:, None], cache, pos)
            confs.append(conf.cpu())
        runs.append((torch.stack(confs), ops.launch_counts()))
    torch.testing.assert_close(runs[0][0], runs[1][0], atol=F32_CONF_ATOL,
                               rtol=0)
    n = cfg.num_layers
    want = {"bvsb": 5, "bvsb_partials": 0, "bvsb_merge": 0,
            "flash_attention": 0, "decode_attention": 0,
            "decode_attention_partials": 0, "decode_attention_merge": 0,
            "rglru_scan": 0,
            "flash_attention_bwd": 0, "rglru_scan_bwd": 0,
            "moe_dispatch": 0, "moe_combine": 0}
    if inputs:
        want.update(flash_attention=cfg.encoder_layers + 2 * n,
                    decode_attention=2 * n * 4)
    assert runs[0][1] == want
    assert runs[1][1] == dict.fromkeys(runs[1][1], 0)


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


# (B, W, KV, G, hd, m, lengths): RecurrentGemma-9B's local-attention ring
# over four ranks, granite's ring of 2,064 slots over four and two, and a
# small ring with empty shards
SHARD_CASES = [
    (4, 2048, 1, 16, 256, 4, [3000, 3007, 1, 700]),
    (4, 2064, 8, 2, 64, 4, [2049, 2056, 2064, 9]),
    (4, 2064, 8, 2, 64, 2, [2049, 2056, 2064, 9]),
    (3, 128, 1, 4, 64, 4, [8, 10, 128]),
]


@pytest.mark.parametrize("b,w,kvh,g,hd,m,lengths", SHARD_CASES)
@pytest.mark.parametrize("qd,cd", [(torch.float32, torch.float32),
                                   (torch.bfloat16, torch.bfloat16),
                                   (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("cap", [None, 50.0])
def test_decode_shard_entries_match_plain(dev, b, w, kvh, g, hd, m, lengths,
                                          qd, cd, cap):
    """The partial entry on each rank's shard against its plain version
    over the kernel's own splits, the sum of the ranks' buffers merged by
    the merge entry against the plain merge and against the whole-ring
    plain decode; every launch twice, bitwise equal."""
    from repro_torch.kernels import decode_attention as _decode
    q = torch.randn(b, kvh * g, hd, device=dev).to(qd) * 2
    k = torch.randn(b, w, kvh, hd, device=dev).to(cd)
    v = torch.randn(b, w, kvh, hd, device=dev).to(cd)
    lens = torch.tensor(lengths, device=dev)
    ws = w // m
    ns, _ = _decode.shard_splits(b, kvh, ws, _build.sm_count(dev), m)
    ops.reset_launch_counts()
    parts = []
    for j in range(m):
        ks, vs = k[:, j * ws:(j + 1) * ws], v[:, j * ws:(j + 1) * ws]
        got = ops.decode_attention_partials(q, ks, vs, lens, j, m, cap)
        assert torch.equal(ops.decode_attention_partials(
            q, ks, vs, lens, j, m, cap), got)
        ref = _decode.decode_attention_partials_plain(q, ks, vs, lens, j, m,
                                                      cap, ns)
        assert got.shape == ref.shape
        torch.testing.assert_close(got, ref, atol=DECODE_ATOL[qd], rtol=1e-4)
        parts.append(got)
    gathered = torch.stack(parts).sum(0)
    out = ops.decode_attention_merge(gathered, q, kvh)
    assert torch.equal(ops.decode_attention_merge(gathered, q, kvh), out)
    torch.cuda.synchronize()
    assert ops.launch_counts()["decode_attention_partials"] == 2 * m
    assert ops.launch_counts()["decode_attention_merge"] == 2
    assert out.dtype == qd and not torch.isnan(out).any()
    for want in (_decode.decode_attention_merge_plain(gathered, q, kvh),
                 decode_attention_plain(q, k, v, lens, soft_cap=cap)):
        torch.testing.assert_close(out.float(), want.float(),
                                   atol=DECODE_ATOL[qd], rtol=0)


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
    assert runs[0][1] == {"bvsb": 5, "bvsb_partials": 0, "bvsb_merge": 0,
                          "flash_attention": 1, "decode_attention": 4,
                          "decode_attention_partials": 0,
                          "decode_attention_merge": 0,
                          "rglru_scan": 2, "flash_attention_bwd": 0,
                          "rglru_scan_bwd": 0, "moe_dispatch": 0,
                          "moe_combine": 0}
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


@pytest.mark.parametrize("pull", [0.0, 4.0])
def test_moe_apply_on_the_card_matches_the_cpu(dev, pull):
    """deepseek-moe-16b's routed and shared experts at a narrower width,
    tokens pulled toward expert 0 (``pull`` 4: past its capacity, so
    assignments drop). The routing ids equal the CPU's wherever the k-th
    and (k+1)-th probabilities lie more than ROUTE_GAP apart, the output
    is within MOE_ATOL on the tokens routed and kept alike, and two card
    calls are bitwise equal."""
    cfg = get_config("deepseek-moe-16b").with_(d_model=512, moe_d_ff=256,
                                               num_experts=16)
    p = moe.MoE(cfg, device="cpu", dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    for t in p.parameters():
        common.trunc_normal_(t, cfg.init_scale, gen)
    toward = p.router[:, 0] / p.router[:, 0].norm()
    x = torch.randn(4, 256, cfg.d_model, generator=gen) + pull * toward
    pc = moe.MoE(cfg, device=dev, dtype=torch.float32)
    pc.load_state_dict(p.state_dict())
    with torch.inference_mode():
        y_cpu = moe.moe_apply(p, x, cfg)
        y = moe.moe_apply(pc, x.to(dev), cfg)
        assert torch.equal(y, moe.moe_apply(pc, x.to(dev), cfg))
        n, k, cap = x.shape[0] * x.shape[1], cfg.num_experts_per_tok, \
            moe.capacity(x.shape[0] * x.shape[1], cfg)
        _, ids, probs = moe.route(x.reshape(n, -1), p.router, cfg)
        ids_c = moe.route(x.to(dev).reshape(n, -1), pc.router, cfg)[1].cpu()
        keep = moe.dispatch(ids, cfg.num_experts, cap)[2].view(n, k)
        keep_c = moe.dispatch(ids_c.to(dev), cfg.num_experts, cap)[2] \
            .cpu().view(n, k)
    if pull:
        assert not keep.all()
    srt = probs.sort(dim=-1, descending=True).values
    clear = srt[:, k - 1] - srt[:, k] > ROUTE_GAP
    assert torch.equal(ids_c.sort(-1).values[clear],
                       ids.sort(-1).values[clear])
    agree = (ids_c == ids).all(-1) & (keep_c == keep).all(-1)
    assert agree.sum() >= n - 2 * int((~clear).sum())
    torch.testing.assert_close(y.reshape(n, -1).cpu()[agree],
                               y_cpu.reshape(n, -1)[agree], atol=MOE_ATOL,
                               rtol=0)


# the MoE route kernels at granite's and deepseek-moe-16b's widths (E, k,
# d), for N = b x 197 tokens at the cascade's buckets b
MOE_WIDTHS = {"granite-moe-1b-a400m": (32, 8, 1024),
              "deepseek-moe-16b": (64, 6, 2048)}
MOE_BUCKETS = (1, 2, 4, 8, 16, 32)
MOE_POSITIONS = 197


def _route_inputs(gen, dev, n, e, k, pull=0.0):
    """ids and renormalised gates of a top-k over random router logits,
    ``pull`` added to expert 0's."""
    logits = torch.randn(n, e, generator=gen, device=dev)
    logits[:, 0] += pull
    gates, ids = torch.topk(torch.softmax(logits, -1), k, dim=-1)
    return ids, gates / gates.sum(-1, keepdim=True)


@pytest.mark.parametrize("case", ["whole", "drops", "slice", "bf16"])
@pytest.mark.parametrize("b", MOE_BUCKETS)
@pytest.mark.parametrize("arch", sorted(MOE_WIDTHS))
def test_moe_route_kernels_equal_plain(dev, arch, b, case):
    """``moe_dispatch`` and ``moe_combine`` on the card equal their plain
    versions run on the card, every output bit for bit: all experts, a
    routing pulled onto expert 0 past its capacity ("drops"), a rank's
    quarter of the experts from e0 = E / 2 ("slice"), bfloat16 rows; one
    counted launch each."""
    e, k, d = MOE_WIDTHS[arch]
    n = b * MOE_POSITIONS
    gen = torch.Generator(device=dev).manual_seed(1000 * b + e)
    ids, gates = _route_inputs(gen, dev, n, e, k,
                               pull=4.0 if case == "drops" else 0.0)
    e_local, e0 = (e // 4, e // 2) if case == "slice" else (e, 0)
    dtype = torch.bfloat16 if case == "bf16" else torch.float32
    cap = max(int(moe.CAPACITY_FACTOR * n * k / e), 8)
    x = torch.randn(n, d, generator=gen, device=dev).to(dtype)
    ops.reset_launch_counts()
    got = ops.moe_dispatch(ids, x, e_local, cap, e0)
    want = moe_route.moe_dispatch_plain(ids, x, e_local, cap, e0)
    out = torch.randn(e_local, cap, d, generator=gen, device=dev).to(dtype)
    y = ops.moe_combine(out, *got[:3], gates)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["moe_dispatch"] == 1 and counts["moe_combine"] == 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)
    if case == "drops":
        assert not want[2].all()
    assert torch.equal(y, moe_route.moe_combine_plain(out, *want[:3], gates))


_MOE_LAYERS = {}


def _moe_layer(arch, dev):
    """The arch's MoE sublayer at full width on the card (kept between
    tests)."""
    if arch not in _MOE_LAYERS:
        cfg = get_config(arch)
        p = moe.MoE(cfg, device=dev, dtype=torch.float32)
        gen = torch.Generator(device=dev).manual_seed(7)
        for t in p.parameters():
            common.trunc_normal_(t, cfg.init_scale, gen)
        _MOE_LAYERS.clear()
        _MOE_LAYERS[arch] = cfg, p
    return _MOE_LAYERS[arch]


@pytest.mark.parametrize("b", MOE_BUCKETS)
@pytest.mark.parametrize("arch", sorted(MOE_WIDTHS))
def test_moe_apply_through_the_route_kernels_equals_the_op_chain(
        dev, arch, b, monkeypatch):
    """The MoE sublayer at the arch's full width on b x 197 tokens: through
    the two kernels bit for bit what the plain ops give on the card."""
    cfg, p = _moe_layer(arch, dev)
    gen = torch.Generator(device=dev).manual_seed(b)
    x = torch.randn(b, MOE_POSITIONS, cfg.d_model, generator=gen, device=dev)
    with torch.inference_mode():
        ops.reset_launch_counts()
        y = moe.moe_apply(p, x, cfg)
        assert ops.launch_counts()["moe_dispatch"] == 1
        monkeypatch.setattr(ops, "moe_dispatch", moe_route.moe_dispatch_plain)
        monkeypatch.setattr(ops, "moe_combine", moe_route.moe_combine_plain)
        assert torch.equal(y, moe.moe_apply(p, x, cfg))


@pytest.mark.parametrize("arch,layers", [("granite-moe-1b-a400m", 2),
                                         ("deepseek-moe-16b", 3)])
def test_a_forward_launches_the_route_kernels_once_a_moe_layer(dev, arch,
                                                               layers):
    """A serving forward (inference mode) of a cut model: one dispatch and
    one combine launch for each MoE layer (deepseek's first layer is
    dense)."""
    cfg = get_config(arch).with_(num_layers=layers)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, MOE_POSITIONS), device=dev)
    moe_layers = layers - cfg.first_dense_layers
    with torch.inference_mode():
        ops.reset_launch_counts()
        model(tokens)
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["moe_dispatch"] == moe_layers
    assert counts["moe_combine"] == moe_layers


def test_moe_route_wrappers_refuse_on_the_card(dev):
    ids = torch.zeros(4, 2, dtype=torch.int64, device=dev)
    x = torch.randn(4, 64, device=dev)
    with pytest.raises(ValueError, match="local experts"):
        ops.moe_dispatch(ids, x, moe_route.MAX_EXPERTS + 1, 8)
    with pytest.raises(TypeError):
        ops.moe_dispatch(ids, x.half(), 4, 8)
    with pytest.raises(TypeError):
        ops.moe_dispatch(ids.int(), x, 4, 8)
    expert, row, keep, buf = ops.moe_dispatch(ids, x, 4, 8)
    with pytest.raises(TypeError):
        ops.moe_combine(buf.half(), expert, row, keep,
                        torch.ones(4, 2, device=dev))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.moe_dispatch(ids, x.requires_grad_(), 4, 8)


@pytest.mark.parametrize("case", ["width", "stride", "base"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_route_wrappers_refuse_rows_not_of_16_byte_units_on_the_card(
        dev, case, dtype):
    """Rows of six elements, rows 66 elements apart, or a base one element
    past a 16-byte unit: the wrappers raise before any launch."""
    def zeros(*shape):
        return torch.zeros(*shape, dtype=dtype, device=dev)
    x = {"width": lambda: zeros(4, 6),
         "stride": lambda: zeros(4, 66)[:, :64],
         "base": lambda: zeros(4 * 64 + 1)[1:].view(4, 64)}[case]()
    ids = torch.zeros(4, 2, dtype=torch.int64, device=dev)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte units"):
        ops.moe_dispatch(ids, x, 4, 8)
    if case == "width":
        flat = torch.zeros(8, dtype=torch.int64, device=dev)
        with pytest.raises(ValueError, match="16-byte units"):
            ops.moe_combine(zeros(4, 8, 6), flat, flat, flat.bool(),
                            torch.zeros(4, 2, device=dev))
    assert ops.launch_counts()["moe_dispatch"] == 0
    assert ops.launch_counts()["moe_combine"] == 0


# ---------------------------------------------------------------------------
# backward kernels and the grad guard
# ---------------------------------------------------------------------------
# (B, S, T, H, KV, hd, causal, window): the tiers' S = 16 (the CUDA-core
# forward), GQA with windows under and over a key tile, hd 48 / 160 padded
# in their tiles, non-causal T = S and T != S both ways; RG-like (hd 256,
# 16 heads over one, a window over more than two 64-key tiles, S off the
# tiles), whose few key tiles make the tensor-core dK/dV grid split
FLASH_BWD_CASES = [(2, 16, None, 8, 8, 48, True, None),
                   (2, 16, None, 4, 4, 32, True, None),
                   (2, 200, None, 8, 2, 64, True, 20),
                   (1, 300, None, 16, 1, 256, True, 100),
                   (2, 333, None, 16, 1, 256, True, 150),
                   (2, 130, None, 32, 8, 160, True, None),
                   (1, 97, None, 16, 16, 128, True, None),
                   (2, 80, None, 8, 2, 64, False, None),
                   (2, 77, 300, 8, 2, 64, False, None),
                   (2, 300, 77, 16, 16, 64, False, None)]


def _rel_err(got, ref):
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


@pytest.mark.parametrize("b,s,t,h,kv,hd,causal,window", FLASH_BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", [0, 1, 2])
def test_flash_backward_kernel_matches_plain(dev, b, s, t, h, kv, hd, causal,
                                             window, dtype, kernel):
    """Kernel 0: a CUDA call under autograd goes through FlashAttentionFn,
    one forward and one backward launch (the entry point picks the
    backward form from the shape); 1 / 2: the FMA / tensor-core backward
    forced through ``run_bwd_entry`` (not counted). The forward's lse and
    output as the plain versions', dq/dk/dv against
    ``flash_attention_bwd_plain`` on the same (q, k, v, o, lse, dO), and a
    second backward bitwise equal."""
    gen = torch.Generator(device=dev).manual_seed(s * 1000 + hd)
    t = t or s
    q, k, v = (torch.randn(b, n, m, hd, generator=gen, device=dev).to(dtype)
               .requires_grad_() for n, m in ((s, h), (t, kv), (t, kv)))
    do = torch.randn(b, s, h, hd, generator=gen, device=dev).to(dtype)
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert out.requires_grad
    if kernel:
        with torch.no_grad():
            _, lse = _flash.run_entry(_build.library().repro_flash_attention,
                                      q, k, v, causal=causal, window=window,
                                      with_lse=True)

        def backward():
            return _flash.run_bwd_entry(q, k, v, out, lse, do, causal=causal,
                                        window=window, kernel=kernel)
    else:
        def backward():
            return torch.autograd.grad(out, (q, k, v), do, retain_graph=True)
    grads = backward()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 1
    assert counts["flash_attention_bwd"] == int(kernel == 0)
    with torch.no_grad():
        torch.testing.assert_close(
            out.float(), flash_attention_plain(q, k, v, causal=causal,
                                               window=window).float(),
            atol=FLASH_ATOL[dtype], rtol=0)
        _, lse = _flash.run_entry(_build.library().repro_flash_attention,
                                  q, k, v, causal=causal, window=window,
                                  with_lse=True)
        torch.testing.assert_close(
            lse, attention_lse_plain(q, k, causal=causal, window=window),
            atol=LSE_ATOL, rtol=0)
        ref = flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal,
                                        window=window)
    for g, r in zip(grads, ref):
        assert g.dtype == dtype and g.shape == r.shape
        assert _rel_err(g, r) <= FLASH_BWD_RTOL[dtype]
    again = backward()
    assert all(torch.equal(a, g) for a, g in zip(again, grads))


@pytest.mark.parametrize("b,s,h,kv,hd,window,dtype",
                         [(2, 333, 16, 1, 256, 150, torch.float32),
                          (1, 200, 8, 2, 64, None, torch.bfloat16),
                          (1, 64, 4, 1, 128, 20, torch.float32)])
def test_flash_backward_split_grid_sums_in_a_fixed_order(dev, b, s, h, kv, hd,
                                                         window, dtype):
    """The tensor-core dK/dV grid split 1 to 16 ways, forced (16: more
    splits than a key tile has row tiles, so some blocks walk none and
    write zero partials): every plan within the gate of the plain
    version, each repeated bitwise, dq the same bits whatever the split."""
    gen = torch.Generator(device=dev).manual_seed(s + hd)
    q = torch.randn(b, s, h, hd, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(b, s, kv, hd, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    do = torch.randn(b, s, h, hd, generator=gen, device=dev).to(dtype)
    out, lse = _flash.run_entry(_build.library().repro_flash_attention, q, k,
                                v, window=window, with_lse=True)
    ref = flash_attention_bwd_plain(q, k, v, out, lse, do, window=window)
    dq0 = None
    for splits in (1, 2, 3, 7, 16):
        def run():
            return _flash.run_bwd_entry(q, k, v, out, lse, do, window=window,
                                        kernel=2, splits=splits)
        grads = run()
        torch.cuda.synchronize()
        for g, r in zip(grads, ref):
            assert _rel_err(g, r) <= FLASH_BWD_RTOL[dtype], splits
        assert all(torch.equal(a, g) for a, g in zip(run(), grads))
        dq0 = grads[0] if dq0 is None else dq0
        assert torch.equal(grads[0], dq0)


def test_flash_backward_refuses_bad_plans(dev):
    q = torch.randn(1, 64, 4, 64, device=dev)
    k = torch.randn(1, 64, 1, 64, device=dev)
    out, lse = _flash.run_entry(_build.library().repro_flash_attention, q, k,
                                k, with_lse=True)
    for kw in (dict(kernel=1, splits=2), dict(kernel=2, splits=0),
               dict(kernel=3)):
        with pytest.raises(ValueError):
            _flash.run_bwd_entry(q, k, k, out, lse, q, **kw)
    assert not _flash.uses_tensor_cores_bwd(16, 64)
    assert _flash.uses_tensor_cores_bwd(2048, 64)


@pytest.mark.parametrize("kernel", [1, 2])
def test_flash_both_forward_kernels_write_the_same_lse(dev, kernel):
    """Each forward kernel, forced, writes lse with one meaning: natural
    log, scale applied."""
    gen = torch.Generator(device=dev).manual_seed(kernel)
    q = torch.randn(2, 90, 8, 64, generator=gen, device=dev)
    k = torch.randn(2, 90, 2, 64, generator=gen, device=dev)
    _, lse = _flash.run_entry(_build.library().repro_flash_attention_kernel,
                              q, k, k, window=30, extra=(kernel,),
                              with_lse=True)
    torch.testing.assert_close(lse, attention_lse_plain(q, k, window=30),
                               atol=LSE_ATOL, rtol=0)


@pytest.mark.parametrize("b,s,d", [(2, 3000, 512), (3, 129, 300), (1, 1, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_backward_kernel_is_plain_bitwise(dev, b, s, d, dtype,
                                                with_h0):
    """A CUDA call under autograd goes through RGLRUScanFn: one forward and
    one backward launch, da / du / dh0 bit for bit the plain reverse loop
    (cast to the inputs' types)."""
    a, u, h0 = _rglru_inputs(dev, b, s, d, None, dtype, with_h0)
    a.requires_grad_()
    u.requires_grad_()
    ins = (a, u) + ((h0.requires_grad_(),) if with_h0 else ())
    dh = torch.randn(b, s, d, device=dev)
    ops.reset_launch_counts()
    h = ops.rglru_scan(a, u, h0)
    grads = torch.autograd.grad(h, ins, dh)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["rglru_scan"] == 1 and counts["rglru_scan_bwd"] == 1
    with torch.no_grad():
        da, du, dh0 = rglru_scan_bwd_plain(a, h, dh, h0)
    assert torch.equal(grads[0], da.to(dtype))
    assert torch.equal(grads[1], du.to(dtype))
    if with_h0:
        assert torch.equal(grads[2], dh0)


def test_kernels_without_backward_refuse_grad(dev):
    """BvSB and decode attention have no backward kernel: a CUDA call that
    autograd would record raises, and launches nothing; under no_grad it
    runs."""
    x = torch.randn(4, 2048, device=dev, requires_grad=True)
    q = torch.randn(2, 8, 64, device=dev, requires_grad=True)
    kc = torch.randn(2, 64, 2, 64, device=dev)
    lengths = torch.tensor([64, 10], dtype=torch.int32, device=dev)
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="no backward"):
        ops.bvsb(x)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.decode_attention(q, kc, kc, lengths)
    assert not any(ops.launch_counts().values())
    with torch.no_grad():
        ops.bvsb(x)
        ops.decode_attention(q, kc, kc, lengths)
    torch.cuda.synchronize()
    assert ops.launch_counts()["bvsb"] == 1
    assert ops.launch_counts()["decode_attention"] == 1


# ---------------------------------------------------------------------------
# soft-capped attention: c tanh(s / c) on the scaled scores, before the
# mask; q and k drawn at CAP_QK times a unit normal so that the scores
# reach the cap's curved part
# ---------------------------------------------------------------------------
CAP_QK = 3.0
# (B, S, T or None, H, KV, hd, causal, window, cap): gemma-7b's heads (16 of
# 256, G = 1), RG-like GQA with windows, both sides of the tensor-core
# thresholds, non-causal T = S and T != S both ways
CAP_CASES = [(2, 300, None, 16, 16, 256, True, None, 50.0),
             (2, 63, None, 16, 1, 256, True, 20, 30.0),
             (2, 47, None, 8, 2, 128, True, None, 50.0),
             (1, 200, None, 16, 1, 256, True, 7, 30.0),
             (64, 16, None, 8, 8, 64, True, None, 50.0),
             (2, 80, None, 8, 2, 64, False, None, 30.0),
             (2, 77, 300, 8, 2, 64, False, None, 50.0),
             (2, 300, 77, 16, 16, 64, False, None, 30.0)]


def _capped_qkv(dev, b, s, t, h, kv, hd, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn(b, s, h, hd, generator=gen, device=dev) * CAP_QK)
    k = (torch.randn(b, t, kv, hd, generator=gen, device=dev) * CAP_QK)
    v = torch.randn(b, t, kv, hd, generator=gen, device=dev)
    do = torch.randn(b, s, h, hd, generator=gen, device=dev)
    return tuple(x.to(dtype) for x in (q, k, v, do))


@pytest.mark.parametrize("b,s,t,h,kv,hd,causal,window,cap", CAP_CASES)
@pytest.mark.parametrize("kernel", [0, 1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_capped_flash_forward_matches_plain(dev, b, s, t, h, kv, hd, causal,
                                            window, cap, kernel, dtype):
    """The capped forward, picked from the shape (0, counted) or each
    kernel forced (1, 2), against ``flash_attention_plain`` with the cap,
    its lse against ``attention_lse_plain``, a second call bitwise equal;
    and the cap moves the output by more than the gate."""
    t = t or s
    q, k, v, _ = _capped_qkv(dev, b, s, t, h, kv, hd, dtype, s + hd)
    lib = _build.library()

    def run():
        if kernel == 0:
            return ops.flash_attention(q, k, v, causal=causal, window=window,
                                       soft_cap=cap)
        return _flash.run_entry(lib.repro_flash_attention_kernel, q, k, v,
                                causal=causal, window=window, soft_cap=cap,
                                extra=(kernel,))
    ops.reset_launch_counts()
    out = run()
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == int(kernel == 0)
    ref = flash_attention_plain(q, k, v, causal=causal, window=window,
                                soft_cap=cap)
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=FLASH_ATOL[dtype], rtol=0)
    assert torch.equal(run(), out)
    free = flash_attention_plain(q, k, v, causal=causal, window=window)
    assert float((free.float() - ref.float()).abs().max()) > FLASH_ATOL[dtype]
    entry = lib.repro_flash_attention if kernel == 0 else \
        lib.repro_flash_attention_kernel
    _, lse = _flash.run_entry(entry, q, k, v, causal=causal, window=window,
                              soft_cap=cap, with_lse=True,
                              extra=() if kernel == 0 else (kernel,))
    torch.testing.assert_close(
        lse, attention_lse_plain(q, k, causal=causal, window=window,
                                 soft_cap=cap), atol=LSE_ATOL, rtol=0)


@pytest.mark.parametrize("b,s,t,h,kv,hd,causal,window,cap", CAP_CASES)
@pytest.mark.parametrize("kernel", [0, 1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_capped_flash_backward_matches_plain(dev, b, s, t, h, kv, hd, causal,
                                             window, cap, kernel, dtype):
    """Kernel 0: under autograd through FlashAttentionFn with the cap (one
    forward, one backward launch); 1 / 2: each backward form forced. dq /
    dk / dv against ``flash_attention_bwd_plain`` with the cap on the same
    (q, k, v, o, lse, dO), a second backward bitwise equal."""
    t = t or s
    q, k, v, do = _capped_qkv(dev, b, s, t, h, kv, hd, dtype, s * 7 + hd)
    for x in (q, k, v):
        x.requires_grad_()
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              soft_cap=cap)
    with torch.no_grad():
        _, lse = _flash.run_entry(_build.library().repro_flash_attention, q,
                                  k, v, causal=causal, window=window,
                                  soft_cap=cap, with_lse=True)
    if kernel:
        def backward():
            return _flash.run_bwd_entry(q, k, v, out, lse, do, causal=causal,
                                        window=window, soft_cap=cap,
                                        kernel=kernel)
    else:
        def backward():
            return torch.autograd.grad(out, (q, k, v), do, retain_graph=True)
    grads = backward()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 1
    assert counts["flash_attention_bwd"] == int(kernel == 0)
    with torch.no_grad():
        ref = flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal,
                                        window=window, soft_cap=cap)
    for g, r in zip(grads, ref):
        assert g.dtype == dtype and g.shape == r.shape
        assert _rel_err(g, r) <= FLASH_BWD_RTOL[dtype]
    assert all(torch.equal(a, g) for a, g in zip(backward(), grads))


CAP_DECODE_CASES = [(4, 2048, 16, 1, 256, [1, 777, 2048, 1500], 50.0),
                    (4, 2048, 1, 16, 256, [2048] * 4, 30.0),
                    (3, 100, 2, 4, 64, [1, 100, 37], 50.0),
                    (2, 100, 2, 4, 128, [99, 64], 30.0),
                    (3, 100, 2, 4, 48, [1, 100, 37], 50.0)]


@pytest.mark.parametrize("b,w,kvh,g,hd,lengths,cap", CAP_DECODE_CASES)
@pytest.mark.parametrize("dtype,cache_dtype",
                         [(torch.float32, torch.float32),
                          (torch.bfloat16, torch.bfloat16),
                          (torch.float32, torch.bfloat16)],
                         ids=["f32", "bf16", "f32-over-bf16"])
def test_capped_decode_kernel_matches_plain(dev, b, w, kvh, g, hd, lengths,
                                            cap, dtype, cache_dtype):
    """The capped split-K partial, in the three dtype pairs, against
    ``decode_attention_plain`` with the cap (gemma-7b's 16 KV heads of 256
    among the cases), a second call and one with NaN past the lengths
    bitwise equal to the first."""
    gen = torch.Generator(device=dev).manual_seed(b * w + hd)
    q = (torch.randn(b, kvh * g, hd, generator=gen, device=dev)
         * CAP_QK).to(dtype)
    k = (torch.randn(b, w, kvh, hd, generator=gen, device=dev)
         * CAP_QK).to(cache_dtype)
    v = torch.randn(b, w, kvh, hd, generator=gen, device=dev).to(cache_dtype)
    lens = torch.tensor(lengths, device=dev)
    ops.reset_launch_counts()
    out = ops.decode_attention(q, k, v, lens, soft_cap=cap)
    torch.cuda.synchronize()
    assert ops.launch_counts()["decode_attention"] == 1
    ref = decode_attention_plain(q, k, v, lens, soft_cap=cap)
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=DECODE_ATOL[dtype], rtol=0)
    again = ops.decode_attention(q, k, v, lens, soft_cap=cap)
    past = torch.arange(w, device=dev)[None, :] >= lens[:, None]
    k[past], v[past] = float("nan"), float("nan")
    poisoned = ops.decode_attention(q, k, v, lens, soft_cap=cap)
    assert torch.equal(again, out) and torch.equal(poisoned, out)


# ---------------------------------------------------------------------------
# the RG-LRU scan's backward: its cp.async ring and its per-element path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,s,d,view,ring", [
    (2, 3000, 512, None, (True, True)),     # S no multiple of the steps
    (1, 1, 256, None, (True, True)),
    (3, 129, 300, None, (True, False)),     # D off a strip; bf16 off 16 B
    (2, 101, 40, None, (True, True)),
    (2, 300, 513, "offset", (False, False)),
    (2, 600, 512, "time", (True, True))])   # a strided in time
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_backward_paths_are_plain_bitwise(dev, b, s, d, view, ring,
                                                dtype, with_h0):
    """``run_bwd_entry`` with the planned path (``ring``: the ring for each
    dtype, by ``is_aligned_bwd``), then the per-element path forced, and
    the ring forced where it can serve: (da, du, dh0) each bit for bit
    ``rglru_scan_bwd_plain``, none counted."""
    a, u, h0 = _rglru_inputs(dev, b, s, d, view, dtype, with_h0)
    h = _rglru.run_entry(a, u, h0)
    dh = torch.randn(h.shape, device=dev)
    assert _rglru.is_aligned_bwd(a, h, dh, h0) == ring[dtype ==
                                                       torch.bfloat16]
    ref = rglru_scan_bwd_plain(a, h, dh, h0)
    ops.reset_launch_counts()
    forced = [None, False] + ([True] if ring[dtype == torch.bfloat16] else [])
    for aligned in forced:
        got = _rglru.run_bwd_entry(a, h, dh, h0, aligned=aligned)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        assert (got[2] is None) == (ref[2] is None)
        if with_h0:
            assert torch.equal(got[2], ref[2])
    assert ops.launch_counts()["rglru_scan_bwd"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_rglru_backward_forced_rings_match_plain(dev, dtype):
    """Every ring the plan gives at S = 3000 over batches, widths and SM
    counts, and rings it does not (7 and 24 steps, 8 and 5 tiles), forced
    at (2, 3000, 512): bitwise the plain reverse loop, with and without
    h0; the ring refused where its copies would be misaligned."""
    a, u, h0 = _rglru_inputs(dev, 2, 3000, 512, None, dtype, True)
    dh = torch.randn(2, 3000, 512, device=dev)
    hs = {True: _rglru.run_entry(a, u, h0), False: _rglru.run_entry(a, u)}
    refs = {w: rglru_scan_bwd_plain(a, hs[w], dh, h0 if w else None)
            for w in (True, False)}
    plans = sorted({_rglru.bwd_tiles(b, 3000, d, a.element_size(), sms)
                    for b in range(1, 65) for d in (512, 4096)
                    for sms in (132, 114, 8)})
    for steps, stages in plans + [(7, 3), (24, 2), (8, 8), (16, 5)]:
        for w in (True, False):
            got = _rglru.run_bwd_entry(a, hs[w], dh, h0 if w else None,
                                       steps, stages, aligned=True)
            assert torch.equal(got[0], refs[w][0]), (steps, stages, w)
            assert torch.equal(got[1], refs[w][1]), (steps, stages, w)
            if w:
                assert torch.equal(got[2], refs[w][2])
    off = a[:, :, 1:]
    with pytest.raises(RuntimeError, match="rglru_scan backward"):
        _rglru.run_bwd_entry(off, hs[True][:, :, 1:].contiguous(),
                             dh[:, :, 1:].contiguous(), aligned=True)
