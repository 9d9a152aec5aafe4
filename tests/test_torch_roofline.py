"""The port's roofline (``repro_torch.roofline.analysis``) and the kernels'
``meta`` branches.

* Each bound function reproduces PERF.md §6's bound column at its shape,
  to the 4 decimals shown (us at the H100 SXM's data-sheet rates; flash's
  tensor-core rows at TF32 beside the FP32 CUDA-core bound, picked by
  ``flash_attention.tensor_core_rule``).
* The rule equals the C sources' thresholds.
* ``model_flops`` equals the JAX package's for every (arch, shape), with
  the config's estimate and with a given active count.
* ``compute_roofline``'s terms and dominance at the H100's rates (the JAX
  package's ``test_roofline_terms_and_dominance`` recast).
* A ``meta`` call of every kernel wrapper (the partial and merge entries
  and both backward kernels, under autograd through the kernels'
  ``autograd.Function``) launches and counts nothing, returns its
  kernel's shapes and dtypes, and books exactly the work of its bound
  function.
"""
import pathlib
import re

import pytest
import torch

from repro.configs import INPUT_SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.roofline.analysis import model_flops as jmodel_flops
from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config
from repro_torch.kernels import _build, ops
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.roofline import analysis as ra

RATES = ra.rates_for("NVIDIA H100 80GB HBM3")
BW, FLOPS = RATES.hbm, RATES.fp32
F32, BF16 = torch.float32, torch.bfloat16
META = torch.device("meta")
CSRC = pathlib.Path(_build.__file__).resolve().parent / "csrc"


def _us(bound):
    return round(bound[0] * 1e3, 4)


def _t(*shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device=META)


# (B, V) f32 logits -> PERF.md's BvSB bound us
BVSB_ROWS = [((4, 256000), 1.2227), ((64, 256000), 19.5631),
             ((8, 2048), 0.0196), ((4, 50304), 0.2403),
             ((4, 256256), 1.2239)]


@pytest.mark.parametrize("shape,want", BVSB_ROWS)
def test_bvsb_bound_reproduces_perf_md(shape, want):
    assert _us(ra.bvsb_bound_ms(*shape, 4, BW, FLOPS)) == want


# (B, W, KV, G, hd, q dtype, cache dtype), rings full -> bound us
DECODE_ROWS = [((4, 2048, 1, 16, 256, F32, F32), 5.0473),
               ((64, 2048, 1, 16, 256, F32, F32), 80.7561),
               ((4, 2048, 1, 16, 256, F32, BF16), 2.5432),
               ((4, 2048, 1, 16, 256, BF16, BF16), 2.5236),
               ((4, 2048, 8, 2, 64, F32, F32), 10.0260),
               ((4, 2048, 16, 1, 128, F32, F32), 40.0846),
               ((4, 2048, 8, 4, 160, F32, F32), 25.0895),
               ((4, 2048, 4, 7, 128, F32, F32), 10.0505),
               ((4, 520, 16, 1, 64, F32, F32), 5.0962),
               ((4, 1024, 16, 1, 64, F32, F32), 10.0260),
               ((4, 1024, 16, 1, 64, F32, BF16), 5.0179),
               ((4, 2056, 16, 1, 256, F32, F32), 80.4821)]


@pytest.mark.parametrize("shape,want", DECODE_ROWS)
def test_decode_bound_reproduces_perf_md(shape, want):
    b, w, kv, g, hd, qd, cd = shape
    lens = torch.full((b,), w)
    got = ra.decode_bound_ms(torch.empty(b, kv * g, hd, dtype=qd),
                             torch.empty(b, w, kv, hd, dtype=cd), lens, BW,
                             FLOPS)
    assert _us(got) == want


# (B, S, T, H, KV, hd, causal, window) f32 -> (bound us, FP32 bound us)
FLASH_ROWS = [((4, 3000, 3000, 16, 1, 256, True, 2048), (1607.7657, 3959.4230)),
              ((8, 16, 16, 8, 8, 48, True, None), (0.2348, 0.2348)),
              ((1, 16, 16, 4, 4, 32, True, None), (0.0098, 0.0098)),
              ((64, 16, 16, 8, 8, 64, True, None), (2.5041, 2.5041)),
              ((4, 2048, 2048, 16, 8, 64, True, None), (208.3425, 513.0823)),
              ((4, 2048, 2048, 16, 16, 128, True, None), (416.6850,
                                                          1026.1646)),
              ((4, 2048, 2048, 32, 8, 160, True, None), (1041.7126,
                                                         2565.4116)),
              ((4, 2048, 2048, 28, 4, 128, True, None), (729.1988,
                                                         1795.7881)),
              ((4, 1024, 1024, 16, 16, 64, False, None), (104.1204,
                                                          256.4160)),
              ((4, 512, 512, 16, 16, 64, True, None), (13.0405, 32.1146)),
              ((4, 512, 1024, 16, 16, 64, False, None), (52.0602, 128.2080)),
              ((4, 2048, 2048, 16, 16, 256, True, None), (833.3701,
                                                          2052.3293))]


@pytest.mark.parametrize("shape,want", FLASH_ROWS)
def test_flash_bounds_reproduce_perf_md(shape, want):
    b, s, t, h, kv, hd, causal, window = shape
    got = ra.flash_bounds_ms(
        _t(b, s, h, hd), _t(b, t, kv, hd), BW, FLOPS, RATES.tensor_peak(F32),
        window, causal, tensor_cores=_flash.tensor_core_rule(s, hd, t))
    assert (_us(got[0]), _us(got[1])) == want


FLASH_BWD_ROWS = [((2, 3000, 3000, 16, 1, 256, True, 2048), (669.9024,
                                                             4949.2787)),
                  ((4, 2048, 2048, 16, 8, 64, True, None), (173.6188,
                                                            1282.7058)),
                  ((64, 16, 16, 8, 8, 48, True, None), (3.7659, None)),
                  ((4, 2048, 2048, 16, 16, 128, True, None), (347.2375,
                                                              2565.4116)),
                  ((4, 1024, 1024, 16, 16, 64, False, None), (86.7670,
                                                              641.0399)),
                  ((4, 512, 1024, 16, 16, 64, False, None), (43.3835,
                                                             320.5199)),
                  ((4, 2048, 2048, 16, 16, 256, True, None), (694.4751,
                                                              5130.8232))]


@pytest.mark.parametrize("shape,want", FLASH_BWD_ROWS)
def test_flash_bwd_bounds_reproduce_perf_md(shape, want):
    b, s, t, h, kv, hd, causal, window = shape
    tc, fp32 = ra.flash_bwd_bounds_ms(_t(b, s, h, hd), _t(b, t, kv, hd), BW,
                                      FLOPS, RATES.tensor_peak(F32), window,
                                      causal)
    assert _us(tc) == want[0]
    if want[1] is None:       # PERF.md shows the byte bound alone
        assert tc[1] == "bytes"
    else:
        assert _us(fp32) == want[1]


SCAN_ROWS = [((4, 3000, 4096, F32), 176.0669, 0),
             ((4, 3000, 4096, BF16), 117.3779, 0),
             ((1, 3000, 4096, F32), 44.0167, 0),
             ((2, 3000, 4096, F32), 146.7224, 1),
             ((2, 3000, 4096, BF16), 132.0501, 1),
             ((1, 3000, 4096, F32), 73.3612, 1)]


@pytest.mark.parametrize("shape,want,bwd", SCAN_ROWS)
def test_scan_bounds_reproduce_perf_md(shape, want, bwd):
    a = _t(*shape[:3], dtype=shape[3])
    fn = ra.rglru_bwd_bound_ms if bwd else ra.rglru_bound_ms
    assert _us(fn(a, BW, FLOPS)) == want


def test_partial_and_merge_bounds_reproduce_perf_md():
    assert _us(ra.bvsb_partials_bound_ms(4, 12320, 4, BW, FLOPS)) == 0.0589
    assert _us(ra.bvsb_partials_bound_ms(64, 12320, 4, BW, FLOPS)) == 0.9418
    assert _us(ra.bvsb_merge_bound_ms(4, 4, BW, FLOPS)) == 0.0001
    assert _us(ra.bvsb_merge_bound_ms(64, 4, BW, FLOPS)) == 0.0014
    # decode: (B, W/m, KV, G, hd) shards of rings cut in 4, full, the
    # splits of the plan on an H100's 132 SMs; the merges over all ranks'
    for (b, w, kv, g, hd), part, merge in (
            ((4, 2048, 1, 16, 256), 1.4293, 0.6505),
            ((64, 2048, 1, 16, 256), 20.9765, 2.8366),
            ((4, 2064, 8, 2, 64), 2.5487, 0.0856)):
        ws = w // 4
        ns = _decode.shard_splits(b, kv, ws, 132, 4)[0]
        q = torch.empty(b, kv * g, hd)
        lens = torch.full((b,), w)
        shard = torch.empty(b, ws, kv, hd)
        assert _us(ra.decode_partials_bound_ms(q, shard, lens, 0, ns, BW,
                                               FLOPS)) == part
        parts = torch.empty(_decode.partials_rows(b, kv, g, 4 * ns)
                            * (2 + hd))
        assert _us(ra.decode_merge_bound_ms(parts, q, kv, BW, FLOPS)) == merge


def test_tensor_core_rule_is_the_c_sources():
    for src, want in (("flash_attention.cu", _flash.TC_MIN_SEQ),
                      ("flash_attention_bwd.cu", _flash.TC_MIN_SEQ_BWD)):
        m = re.search(r"kTensorCoreMinSeq = (\d+), kTensorCoreMinSeqWide = "
                      r"(\d+);", (CSRC / src).read_text())
        assert tuple(map(int, m.groups())) == want, src
    assert not _flash.tensor_core_rule(47, 128)
    assert _flash.tensor_core_rule(48, 128)
    assert not _flash.tensor_core_rule(79, 160)
    assert _flash.tensor_core_rule(80, 160)
    assert not _flash.tensor_core_rule(512, 64, t=16)
    assert _flash.tensor_core_rule(16, 256, backward=True)


def test_rates_by_card_name():
    assert ra.rates_for("NVIDIA H100 80GB HBM3") is ra.H100_SXM
    assert ra.rates_for("NVIDIA H100 PCIe") is ra.H100_PCIE
    assert (ra.H100_SXM.hbm, ra.H100_SXM.fp32, ra.H100_SXM.tf32,
            ra.H100_SXM.bf16) == (3.35e12, 67e12, 495e12, 989e12)
    assert BW == 3.35e12 and RATES.tensor_peak(F32) == 495e12 and \
        RATES.tensor_peak(BF16) == 989e12


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_equal_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name, shape in INPUT_SHAPES.items():
        assert ra.model_flops(cfg, shape) == jmodel_flops(jcfg,
                                                          JSHAPES[name])
        assert ra.model_flops(cfg, shape, 1.5e9) == \
            jmodel_flops(jcfg, JSHAPES[name], 1.5e9)


def test_roofline_terms_and_dominance():
    cfg = get_config("qwen3-32b")
    shape = INPUT_SHAPES["train_4k"]
    stats = ra.StepStats(dot_flops=1e15, dot_bytes=1e12,
                         collective_bytes=1e11, collectives={})
    r = ra.compute_roofline(cfg, shape, stats, 256)
    assert r.compute_s == pytest.approx(1e15 / 989e12)
    assert r.memory_s == pytest.approx(1e12 / 3.35e12)
    assert r.collective_s == pytest.approx(1e11 / 450e9)
    assert r.dominant == "compute"
    assert r.model_flops == pytest.approx(
        6 * cfg.active_param_count() * 256 * 4096)
    assert r.useful_ratio == pytest.approx(r.model_flops / (1e15 * 256))
    f32 = ra.compute_roofline(cfg, shape, stats, 256, dtype=F32)
    assert f32.compute_s == pytest.approx(1e15 / 495e12)
    stats.collective_bytes = 1e12
    assert ra.compute_roofline(cfg, shape, stats, 256).dominant == \
        "collective"
    heavy = ra.compute_roofline(cfg, shape, stats, 256,
                                param_bytes_per_device=1e13)
    assert heavy.per_device_hbm_bytes == 1e13 and heavy.dominant == "memory"
    assert set(r.as_dict()) == {
        "compute_s", "memory_s", "collective_s", "dominant", "model_flops",
        "hlo_flops_per_device", "useful_ratio", "collectives",
        "per_device_hbm_bytes"}


def test_roofline_charges_kernel_flops_at_their_rate():
    cfg = get_config("recurrentgemma-9b")
    shape = INPUT_SHAPES["decode_32k"]
    kernels = {"fp32": 6.7e12, "bf16": 9.89e12}
    stats = ra.StepStats(dot_flops=1e15 + sum(kernels.values()),
                         dot_bytes=0.0, collective_bytes=0.0, collectives={},
                         kernel_flops=kernels)
    r = ra.compute_roofline(cfg, shape, stats, 256)
    assert r.compute_s == pytest.approx(1e15 / 989e12 + 0.1 + 0.01)
    assert r.hlo_flops_per_device == stats.dot_flops
    f32 = ra.compute_roofline(cfg, shape, stats, 256, dtype=F32)
    assert f32.compute_s == pytest.approx(1e15 / 495e12 + 0.1 + 0.01)
    with ra.counting_work() as tally:
        ra.record("a", ra.Work(1.0, 2.0))
        ra.record("b", ra.Work(1.0, 3.0, "bf16"))
        ra.record("a", ra.Work(1.0, 4.0))
    assert tally.flops_by_rate == {"fp32": 6.0, "bf16": 3.0}


def _booked(fn):
    """(fn's result, the work booked, by kernel) with the launch counters
    held at zero."""
    ops.reset_launch_counts()
    with ra.counting_work() as tally:
        out = fn()
    assert not any(ops.launch_counts().values())
    return out, tally.kernels


def _one(work):
    return {"calls": 1, "bytes": work.bytes, "flops": {work.rate: work.flops}}


def _like(meta_out, cpu_out):
    pairs = zip(meta_out, cpu_out) if isinstance(cpu_out, tuple) else \
        [(meta_out, cpu_out)]
    for m, c in pairs:
        assert m.device == META and m.shape == c.shape and m.dtype == c.dtype


@pytest.mark.parametrize("dt", [F32, BF16])
def test_meta_bvsb_entries_book_their_bounds(dt):
    out, k = _booked(lambda: ops.bvsb(_t(4, 50304, dtype=dt)))
    _like(out, ops.bvsb(torch.zeros(4, 50304, dtype=dt)))
    assert k == {"bvsb": _one(ra.bvsb_work(4, 50304, dt.itemsize))}
    assert ra.bound(ra.bvsb_work(4, 50304, 4), BW, FLOPS) == \
        ra.bvsb_bound_ms(4, 50304, 4, BW, FLOPS)
    out, k = _booked(lambda: ops.bvsb_partials(_t(4, 12320, dtype=dt), 0))
    _like(out, ops.bvsb_partials(torch.zeros(4, 12320, dtype=dt), 0))
    assert k == {"bvsb_partials": _one(ra.bvsb_partials_work(
        4, 12320, dt.itemsize))}
    out, k = _booked(lambda: ops.bvsb_merge(_t(4, 4, 4)))
    _like(out, ops.bvsb_merge(torch.zeros(4, 4, 4)))
    assert k == {"bvsb_merge": _one(ra.bvsb_merge_work(4, 4))}


@pytest.mark.parametrize("shape", [(2, 64, 64, 8, 2, 32, True, None),
                                   (2, 24, 24, 4, 4, 160, True, 8),
                                   (1, 16, 40, 4, 1, 64, False, None)])
def test_meta_flash_books_forward_and_backward(shape):
    b, s, t, h, kv, hd, causal, window = shape
    kw = dict(causal=causal, window=window)
    q, k, v = _t(b, s, h, hd), _t(b, t, kv, hd), _t(b, t, kv, hd)
    out, got = _booked(lambda: ops.flash_attention(q, k, v, **kw))
    _like(out, ops.flash_attention(torch.zeros(b, s, h, hd),
                                   torch.zeros(b, t, kv, hd),
                                   torch.zeros(b, t, kv, hd), **kw))
    tcf = _flash.tensor_core_rule(s, hd, t)
    fwd = ra.flash_work(b, s, t, h, kv, hd, 4, tensor_cores=tcf, **kw)
    assert got == {"flash_attention": _one(fwd)}
    bound = ra.flash_bounds_ms(q, k, BW, FLOPS, RATES.tensor_peak(F32),
                               window, causal, tensor_cores=tcf)[0]
    assert ra.bound(fwd, BW, ra.H100_SXM.peak(fwd.rate)) == bound
    qg, kg, vg = (x.requires_grad_() for x in (_t(b, s, h, hd),
                                               _t(b, t, kv, hd),
                                               _t(b, t, kv, hd)))

    def train():
        o = ops.flash_attention(qg, kg, vg, **kw)
        return torch.autograd.grad(o.sum(), (qg, kg, vg))
    grads, got = _booked(train)
    assert [g.shape for g in grads] == [qg.shape, kg.shape, vg.shape]
    bwd = ra.flash_bwd_work(b, s, t, h, kv, hd, 4, **kw,
                            tensor_cores=_flash.tensor_core_rule(
                                s, hd, t, backward=True))
    assert got == {"flash_attention": _one(fwd),
                   "flash_attention_bwd": _one(bwd)}


def test_meta_decode_entries_book_their_bounds():
    b, w, kv, g, hd = 4, 2064, 8, 2, 64
    q, kc = _t(b, kv * g, hd), _t(b, w, kv, hd, dtype=BF16)
    lens = _t(b, dtype=torch.int32)
    out, got = _booked(lambda: ops.decode_attention(q, kc, kc, lens))
    assert out.shape == (b, kv * g, hd) and out.dtype == F32
    work = ra.decode_work(b, kv * g, hd, kv, b * w, 4, 2)
    assert got == {"decode_attention": _one(work)}
    full = torch.full((b,), w)
    assert ra.bound(work, BW, FLOPS) == ra.decode_bound_ms(
        torch.empty(b, kv * g, hd), torch.empty(b, w, kv, hd,
                                                dtype=BF16), full, BW, FLOPS)
    ws = w // 4
    ns = _decode.shard_splits(b, kv, ws, _build.META_SMS, 4)[0]
    shard = _t(b, ws, kv, hd)
    parts, got = _booked(lambda: ops.decode_attention_partials(
        q, shard, shard, lens, 1, 4))
    assert parts.shape == (_decode.partials_rows(b, kv, g, 4 * ns)
                           * (2 + hd),)
    work = ra.decode_partials_work(b, kv * g, hd, kv, b * ws, ns, 4, 4)
    assert got == {"decode_attention_partials": _one(work)}
    assert ra.bound(work, BW, FLOPS) == ra.decode_partials_bound_ms(
        torch.empty(b, kv * g, hd), torch.empty(b, ws, kv, hd), full, 1, ns,
        BW, FLOPS)
    out, got = _booked(lambda: ops.decode_attention_merge(parts, q, kv))
    assert out.shape == (b, kv * g, hd)
    work = ra.decode_merge_work(b, kv * g, hd, kv, 4 * ns, 4)
    assert got == {"decode_attention_merge": _one(work)}
    assert ra.bound(work, BW, FLOPS) == ra.decode_merge_bound_ms(
        torch.empty(parts.shape), torch.empty(b, kv * g, hd), kv, BW, FLOPS)


@pytest.mark.parametrize("dt", [F32, BF16])
def test_meta_scan_books_forward_and_backward(dt):
    a, u, h0 = _t(2, 48, 64, dtype=dt), _t(2, 48, 64, dtype=dt), _t(2, 64)
    h, got = _booked(lambda: ops.rglru_scan(a, u, h0))
    assert h.shape == a.shape and h.dtype == F32
    fwd = ra.rglru_work(2, 48, 64, dt.itemsize)
    assert got == {"rglru_scan": _one(fwd)}
    assert ra.bound(fwd, BW, FLOPS) == ra.rglru_bound_ms(a, BW, FLOPS)
    ag, ug, hg = (x.clone().requires_grad_() for x in (a, u, h0))

    def train():
        return torch.autograd.grad(ops.rglru_scan(ag, ug, hg).sum(),
                                   (ag, ug, hg))
    grads, got = _booked(train)
    assert [(g.shape, g.dtype) for g in grads] == \
        [(a.shape, dt), (u.shape, dt), (h0.shape, F32)]
    bwd = ra.rglru_bwd_work(2, 48, 64, dt.itemsize)
    assert got == {"rglru_scan": _one(fwd), "rglru_scan_bwd": _one(bwd)}
    assert ra.bound(bwd, BW, FLOPS) == ra.rglru_bwd_bound_ms(a, BW, FLOPS)


def test_meta_calls_check_their_inputs_and_refuse_grad():
    with pytest.raises(ValueError):
        ops.flash_attention(_t(1, 8, 3, 16), _t(1, 8, 2, 16), _t(1, 8, 2, 16))
    with pytest.raises(TypeError):
        ops.bvsb(_t(2, 8, dtype=torch.float16))
    with pytest.raises(RuntimeError):
        ops.bvsb(_t(2, 8).requires_grad_())
    with pytest.raises(ValueError):
        ops.bvsb_partials(_t(2, 8), 1 << 24)
