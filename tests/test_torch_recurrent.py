"""The port's RG-LRU scan, RG-LRU block and RecurrentGemma decoder held to
the JAX package on the CPU.

The same numpy inputs and the JAX package's own weights (carried across by
``params_from_jax``) go through both sides. Tolerances:

* scan: 1e-6 relative to max|h| against the sequential forms (the same
  float32 recurrence; XLA may fuse a * h + u into one rounding), 1e-5
  against the associative scan (products taken in another order);
* block pieces and the reduced model's logits: 1e-4 (float32 matmuls
  and sums in another order);
* decode past the window: 5e-3, the tolerance of the JAX package's own
  prefill/decode test (tests/test_models.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ref as jref
from repro.kernels.rglru_scan import rglru_scan as jrglru_scan
from repro.models import recurrent as jrec
from repro.models.common import KeyGen
from repro.models.model import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as _scan
from repro_torch.kernels.rglru_scan import rglru_scan_plain
from repro_torch.models import recurrent
from repro_torch.models.model import init_params, params_from_jax

torch.set_num_threads(2)

SCAN_RTOL_SEQ = 1e-6
SCAN_RTOL_ASSOC = 1e-5
TOL = dict(atol=1e-4, rtol=1e-4)
DECODE_ATOL = 5e-3


def _au(b, s, d, seed, with_h0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (b, s, d)).astype(np.float32)
    u = rng.standard_normal((b, s, d)).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32) if with_h0 else None
    return a, u, h0


def _plain(a, u, h0):
    return rglru_scan_plain(torch.from_numpy(a), torch.from_numpy(u),
                            None if h0 is None else torch.from_numpy(h0)).numpy()


def _close(h, ref, rtol):
    ref = np.asarray(ref)
    assert h.shape == ref.shape and h.dtype == np.float32
    np.testing.assert_allclose(h, ref, atol=rtol * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,s,d", [(2, 256, 256), (1, 128, 512)])
def test_rglru_scan_plain_matches_jax_kernel(b, s, d, with_h0):
    """S a multiple of the Pallas kernel's 128-step tile (its assert)."""
    a, u, h0 = _au(b, s, d, s + d, with_h0)
    h = _plain(a, u, h0)
    kern = jrglru_scan(jnp.asarray(a), jnp.asarray(u),
                       None if h0 is None else jnp.asarray(h0),
                       interpret=True)
    _close(h, kern, SCAN_RTOL_SEQ)
    _close(h, jref.rglru_scan_ref(a, u, h0), SCAN_RTOL_SEQ)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,s,d", [(3, 129, 300), (1, 1, 256), (2, 77, 64)])
def test_rglru_scan_plain_matches_refs_at_ragged_lengths(b, s, d, with_h0):
    a, u, h0 = _au(b, s, d, 7 * s + d, with_h0)
    h = _plain(a, u, h0)
    _close(h, jref.rglru_scan_ref(a, u, h0), SCAN_RTOL_SEQ)
    assoc = jrec.rglru_scan_ref(jnp.asarray(a), jnp.asarray(u),
                                None if h0 is None else jnp.asarray(h0))
    _close(h, assoc, SCAN_RTOL_ASSOC)


def test_rglru_scan_cpu_takes_the_plain_loop():
    a, u, h0 = _au(2, 9, 16, 0, True)
    ops.reset_launch_counts()
    h = ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(u),
                       torch.from_numpy(h0))
    assert torch.equal(h, torch.from_numpy(_plain(a, u, h0)))
    assert ops.launch_counts()["rglru_scan"] == 0
    # bf16 inputs still give a float32 state
    hb = ops.rglru_scan(torch.from_numpy(a).bfloat16(),
                        torch.from_numpy(u).bfloat16())
    assert hb.dtype == torch.float32


# ---------------------------------------------------------------------------
# the CUDA scan's plan (kernels/rglru_scan.py tiles, is_aligned) and its
# ring's index arithmetic (csrc/rglru_scan.cu rglru_ring_kernel) on the CPU
# ---------------------------------------------------------------------------
PLAN_SHAPES = [(4, 3000, 4096), (1, 3000, 4096), (64, 3000, 4096),
               (2, 3000, 512), (1, 1, 256), (3, 7, 300), (2, 3000, 4100),
               (65535, 2, 32)]
PLAN_SMS = [132, 114, 8]
DTYPES = [torch.float32, torch.bfloat16]
# an H100 SM: shared memory, the most one block may use, what the card
# keeps per resident block, resident blocks at most
SM_SMEM, BLOCK_SMEM, BLOCK_RESERVE, MAX_BLOCKS = 228 * 1024, 227 * 1024, \
    1024, 32


@pytest.mark.parametrize("sms", PLAN_SMS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,d", PLAN_SHAPES)
def test_rglru_tiles_fit_the_sm(b, s, d, dtype, sms):
    """At least one step a tile and two tiles a ring; one warp's ring fits
    the 227 KB a block may use, and the warps a wave puts on an SM (one
    block each, with the card's 1 KB per block) fit its 228 KB."""
    elt = torch.tensor([], dtype=dtype).element_size()
    steps, stages = _scan.tiles(b, s, d, elt, sms)
    assert 1 <= steps <= s and 2 <= stages <= _scan.MAX_STAGES
    ring = stages * steps * 2 * _scan.STRIP * elt
    assert ring <= BLOCK_SMEM
    warps = b * -(-d // _scan.STRIP)
    wave = min(-(-warps // sms), MAX_BLOCKS)
    assert wave * (ring + BLOCK_RESERVE) <= SM_SMEM
    # no tile more than S needs; whole powers of two of steps below S
    assert stages <= -(-s // steps) + 1
    assert steps == s or steps & (steps - 1) == 0


def _ring_scan(a, u, h0, steps, stages):
    """rglru_ring_kernel's index arithmetic in PyTorch on the CPU, all
    warps at once: warp (block) w owns strip w % strips of row w //
    strips, copies tile k of its strip into ring slot k mod stages (the
    slot read at iteration k - 1) in 16-byte chunks, chunk c = lane + 32 j
    at row c // cpr, zero-filling chunks past D and copying no row past S,
    then steps through the tile's rows in order. A slot is poisoned with
    NaN once read, so a read of a row no copy wrote shows in h. Returns h,
    and how many times each element of a was copied and each element of h
    written."""
    b, s, d = a.shape
    e = 16 // a.element_size()
    cpr = _scan.STRIP // e
    strips = -(-d // _scan.STRIP)
    n_tiles = -(-s // steps)
    h = torch.full((b, s, d), float("nan"))
    copied = torch.zeros(b, s, d, dtype=torch.int64)
    written = torch.zeros(b, s, d, dtype=torch.int64)
    a32, u32 = a.float(), u.float()
    w = torch.arange(b * strips)
    bi, d0 = w // strips, (w % strips) * _scan.STRIP          # (W,)
    ring = torch.full((len(w), stages, 2, steps, _scan.STRIP), float("nan"))
    lanes = d0[:, None] + torch.arange(_scan.STRIP)            # (W, 32)
    live = lanes < d
    hv = torch.zeros(len(w), _scan.STRIP)
    if h0 is not None:
        hv[live] = h0[bi[:, None].expand_as(lanes)[live], lanes[live]]

    def issue(k, slot):
        if k >= n_tiles:
            return
        t0 = k * steps
        c = torch.arange(min(steps, s - t0) * cpr)
        r, col = c // cpr, (c % cpr) * e                       # (n,)
        cols = col[:, None] + torch.arange(e)                  # (n, e)
        rows = r[:, None].expand_as(cols)
        src = d0[:, None, None] + cols                         # (W, n, e)
        inside = (d0[:, None] + col < d)[:, :, None].expand_as(src)
        assert (src[inside] < d).all()                  # whole chunks in D
        tb = bi[:, None, None].expand_as(src)
        tt = (t0 + rows).expand_as(src)
        for arr, half in ((a32, 0), (u32, 1)):
            vals = arr[tb, tt, src.clamp(max=d - 1)]
            ring[:, slot, half, rows, cols] = torch.where(inside, vals, 0.0)
        copied.index_put_((tb[inside], tt[inside], src[inside]),
                          torch.ones(int(inside.sum()), dtype=torch.int64),
                          accumulate=True)

    for k in range(stages - 1):
        issue(k, k)
    slot = 0
    for k in range(n_tiles):
        issue(k + stages - 1, stages - 1 if slot == 0 else slot - 1)
        for r in range(min(steps, s - k * steps)):
            hv = ring[:, slot, 0, r] * hv + ring[:, slot, 1, r]
            t = k * steps + r
            h[bi[:, None].expand_as(lanes)[live], t, lanes[live]] = hv[live]
            written[bi[:, None].expand_as(lanes)[live], t, lanes[live]] += 1
        ring[:, slot] = float("nan")
        slot = 0 if slot + 1 == stages else slot + 1
    return h, copied, written


RING_SHAPES = [(2, 700, 64), (3, 129, 296), (1, 7, 40), (1, 1, 8)]


@pytest.mark.parametrize("sms", PLAN_SMS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,d", RING_SHAPES)
def test_rglru_ring_plan_covers_every_channel_once(b, s, d, dtype, sms):
    """Under the plan, every (b, t, channel) of a and u is copied once and
    every element of h written once, and the ring's h is bitwise the
    plain loop's, with and without h0."""
    a, u, h0 = _au(b, s, d, s * d, True)
    at, ut = (torch.from_numpy(x).to(dtype) for x in (a, u))
    assert _scan.is_aligned(at, ut)
    steps, stages = _scan.tiles(b, s, d, at.element_size(), sms)
    for h0t in (None, torch.from_numpy(h0)):
        h, copied, written = _ring_scan(at, ut, h0t, steps, stages)
        assert (copied == 1).all() and (written == 1).all()
        assert torch.equal(h, rglru_scan_plain(at, ut, h0t))


@pytest.mark.parametrize("steps,stages", [(1, 2), (3, 2), (3, 3), (5, 8),
                                          (64, 2)])
def test_rglru_ring_forced_plans_wrap_the_ring(steps, stages):
    """Forced rings (run_entry's steps and stages) that wrap many times,
    on a ragged last tile and a strip past D."""
    a, u, h0 = _au(2, 101, 40, steps * stages, True)
    at, ut, h0t = (torch.from_numpy(x) for x in (a, u, h0))
    h, copied, written = _ring_scan(at, ut, h0t, steps, stages)
    assert (copied == 1).all() and (written == 1).all()
    assert torch.equal(h, rglru_scan_plain(at, ut, h0t))


def _ring_scan_bwd(a, h, dh, h0, steps, stages):
    """rglru_bwd_ring_kernel's index arithmetic in PyTorch on the CPU, all
    warps at once: warp w owns strip w % strips of row w // strips and
    walks its tiles from the last down, tile n_tiles - 1 - j copied into
    ring slot j mod stages (the slot read at iteration j - 1): chunk c =
    lane + 32 i of a (row c // cpr), of dh and of h_{t-1} (row c // 8; row
    t = 0 from h0, or zero-filled), chunks past D zero-filled, no row past
    S; then the tile's rows from the last down. A slot is poisoned with NaN
    once read. Returns (da, du, dh0 or None) and how many times each
    element of a, dh, h and h0 was copied and each of da and du written."""
    b, s, d = a.shape
    e = 16 // a.element_size()
    strip = _scan.STRIP
    strips = -(-d // strip)
    n_tiles = -(-s // steps)
    da = torch.full((b, s, d), float("nan"))
    du = torch.full((b, s, d), float("nan"))
    counts = {n: torch.zeros(b, s, d, dtype=torch.int64)
              for n in ("a", "dh", "h", "da", "du")}
    h0_copied = torch.zeros(b, d, dtype=torch.int64)
    a32 = a.float()
    w = torch.arange(b * strips)
    bi, d0 = w // strips, (w % strips) * strip
    ring = torch.full((len(w), stages, 3, steps, strip), float("nan"))
    lanes = d0[:, None] + torch.arange(strip)
    live = lanes < d
    bl = bi[:, None].expand_as(lanes)

    def copy(slot, part, src, t0, rows, per):
        """Chunks of ``per`` elements, row c // (strip / per), of the
        (B, S, D) ``src`` at time t0 + row + shift into ring part ``part``;
        returns the (b, t, channel) copied."""
        cpr = strip // per
        c = torch.arange(rows * cpr)
        r, col = c // cpr, (c % cpr) * per
        cols = col[:, None] + torch.arange(per)
        rr = r[:, None].expand_as(cols)
        chan = d0[:, None, None] + cols
        inside = (d0[:, None] + col < d)[:, :, None].expand_as(chan)
        assert (chan[inside] < d).all()                   # whole chunks in D
        tb = bi[:, None, None].expand_as(chan)
        tt = (t0 + rr).expand_as(chan)
        vals = src(tb, tt, chan.clamp(max=d - 1))
        ring[:, slot, part, rr, cols] = torch.where(inside, vals, 0.0)
        return tb[inside], tt[inside], chan[inside]

    def mark(name, idx):
        counts[name].index_put_(idx, torch.ones(len(idx[0]),
                                                dtype=torch.int64),
                                accumulate=True)

    def h_prev(tb, tt, chan):
        first = tt == 0
        prev = h[tb, (tt - 1).clamp(min=0), chan]
        init = torch.zeros_like(prev) if h0 is None else h0[tb, chan]
        return torch.where(first, init, prev)

    def issue(j, slot):
        if j >= n_tiles:
            return
        t0 = (n_tiles - 1 - j) * steps
        rows = min(steps, s - t0)
        mark("a", copy(slot, 0, lambda tb, tt, c: a32[tb, tt, c], t0, rows,
                       e))
        mark("dh", copy(slot, 1, lambda tb, tt, c: dh[tb, tt, c], t0, rows,
                        4))
        tb, tt, chan = copy(slot, 2, h_prev, t0, rows, 4)
        later = tt > 0
        mark("h", (tb[later], tt[later] - 1, chan[later]))
        if h0 is not None:
            h0_copied.index_put_((tb[~later], chan[~later]),
                                 torch.ones(int((~later).sum()),
                                            dtype=torch.int64),
                                 accumulate=True)

    for j in range(stages - 1):
        issue(j, j)
    carry = torch.zeros(len(w), strip)
    slot = 0
    for j in range(n_tiles):
        issue(j + stages - 1, stages - 1 if slot == 0 else slot - 1)
        t0 = (n_tiles - 1 - j) * steps
        for r in range(min(steps, s - t0) - 1, -1, -1):
            g = ring[:, slot, 1, r] + carry
            t = t0 + r
            idx = (bl[live], torch.full_like(bl[live], t), lanes[live])
            du[idx] = g[live]
            da[idx] = (g * ring[:, slot, 2, r])[live]
            mark("du", idx)
            mark("da", idx)
            carry = ring[:, slot, 0, r] * g
        ring[:, slot] = float("nan")
        slot = 0 if slot + 1 == stages else slot + 1
    dh0 = None
    if h0 is not None:
        dh0 = torch.zeros(b, d)
        dh0[bl[live], lanes[live]] = carry[live]
    return (da, du, dh0), counts, h0_copied


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,d,steps,stages", [
    (2, 700, 64, None, None), (3, 129, 296, None, None), (1, 7, 40, None, None),
    (1, 1, 8, None, None), (2, 101, 40, 3, 2), (2, 101, 40, 5, 8),
    (1, 50, 72, 64, 2), (2, 33, 16, 1, 3)])
def test_rglru_bwd_ring_is_the_plain_reverse_loop(b, s, d, steps, stages,
                                                  dtype):
    """Under the plan (``bwd_tiles`` at 132 SMs) or a forced ring that
    wraps many times: every element of a, dh, h (but the last step's) and
    h0 copied once, every element of da and du written once, and (da, du,
    dh0) bitwise the plain reverse loop's, with and without h0."""
    a, u, h0 = _au(b, s, d, s * d + 1, True)
    at, ut = (torch.from_numpy(x).to(dtype) for x in (a, u))
    if steps is None:
        steps, stages = _scan.bwd_tiles(b, s, d, at.element_size(), 132)
    dh = torch.from_numpy(np.random.default_rng(s).standard_normal(
        (b, s, d)).astype(np.float32))
    for h0t in (None, torch.from_numpy(h0)):
        h = rglru_scan_plain(at, ut, h0t)
        got, counts, h0_copied = _ring_scan_bwd(at, h, dh, h0t, steps,
                                                stages)
        for name in ("a", "dh", "da", "du"):
            assert (counts[name] == 1).all(), name
        assert (counts["h"][:, :-1] == 1).all()
        assert (counts["h"][:, -1] == 0).all()
        assert (h0_copied == (0 if h0t is None else 1)).all()
        ref = _scan.rglru_scan_bwd_plain(at, h, dh, h0t)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        assert (got[2] is None) == (ref[2] is None)
        if ref[2] is not None:
            assert torch.equal(got[2], ref[2])


def test_rglru_is_aligned_bwd_adds_the_gradient_streams():
    """The backward's copies also need h, dh and h0 on 16 bytes."""
    a = torch.zeros(2, 8, 64)
    h, dh, h0 = torch.zeros(2, 8, 64), torch.zeros(2, 8, 64), \
        torch.zeros(2, 64)
    assert _scan.is_aligned_bwd(a, h, dh, h0) and \
        _scan.is_aligned_bwd(a, h, dh)
    off = torch.zeros(2 * 8 * 64 + 1)[1:].view(2, 8, 64)
    assert not _scan.is_aligned_bwd(a, off, dh, h0)
    assert not _scan.is_aligned_bwd(a, h, off, h0)
    assert not _scan.is_aligned_bwd(a, h, dh, torch.zeros(129)[1:].view(2,
                                                                       64))
    assert not _scan.is_aligned_bwd(a[:, :, 1:], h[:, :, 1:], dh[:, :, 1:])


def _aligned_cases():
    """(name, a, u, aligned): what the 16-byte copies can serve."""
    x = torch.zeros(2, 64, 520)
    xb = x.bfloat16()
    return [
        ("f32 contiguous", x[:, :, :512], x[:, :, :512], True),
        ("f32 D 300", x[:, :, :300], x[:, :, :300], True),
        ("f32 D 301", x[:, :, :301], x[:, :, :301], False),
        ("f32 [:, :, 1:]", x[:, :, 1:], x[:, :, 1:], False),
        ("f32 [:, :, 4:] (16 bytes in)", x[:, :, 4:], x[:, :, 4:], True),
        ("f32 time-strided", x[:, ::2, :512], x[:, ::2, :512], True),
        ("f32 u off", x[:, :, :512], x[:, :, 1:513], False),
        ("f32 odd row stride", torch.zeros(2, 64, 301)[:, :, :300],
         torch.zeros(2, 64, 301)[:, :, :300], False),
        ("f32 batch stride off", torch.zeros(2, 64 * 512 + 1)[:, :-1]
         .reshape(2, 64, 512), torch.zeros(2, 64, 512), False),
        ("bf16 D 300", xb[:, :, :300], xb[:, :, :300], False),
        ("bf16 D 4100", torch.zeros(1, 4, 4100).bfloat16(),
         torch.zeros(1, 4, 4100).bfloat16(), False),
        ("bf16 D 296", xb[:, :, :296], xb[:, :, :296], True),
        ("bf16 [:, :, 8:]", xb[:, :, 8:], xb[:, :, 8:], True),
        ("bf16 [:, :, 1:]", xb[:, :, 1:], xb[:, :, 1:], False),
    ]


@pytest.mark.parametrize("name,a,u,want", _aligned_cases(),
                         ids=[c[0] for c in _aligned_cases()])
def test_rglru_is_aligned_exactly_when_every_pointer_and_stride_is(
        name, a, u, want):
    elt = a.element_size()
    assert all(t.data_ptr() % 16 == 0 for t in (a, u)) or not want
    assert _scan.is_aligned(a, u) == want
    # the predicate is the conjunction of the stated conditions
    conds = [a.shape[2] * elt % 16 == 0] + [
        v % 16 == 0 for t in (a, u)
        for v in (t.data_ptr(), t.stride(0) * elt, t.stride(1) * elt)]
    assert all(conds) == want


# ---------------------------------------------------------------------------
# the RG-LRU block
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=[256, 72], ids=["d256", "d72"])
def block(request):
    """(jax params, port RGLRU, cfg); d = 72 has no 16 gate blocks."""
    d = request.param
    cfg = get_config("recurrentgemma-9b").reduced().with_(d_model=d)
    jp = jrec.rglru_init(KeyGen(jax.random.key(d)), cfg, jnp.float32)
    # non-zero biases and conv bias, so the test sees them
    rng = np.random.default_rng(d)
    jp = {k: np.array(v) for k, v in jp.items()}
    for k in recurrent.ZERO_INIT:
        jp[k] = (rng.standard_normal(d) * 0.1).astype(np.float32)
    jp["w_a"] = jp["w_a"] * 20     # gates away from 0.5
    p = recurrent.RGLRU(cfg, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for name, t in p.named_parameters():
            t.copy_(torch.from_numpy(jp[name]))
    return jp, p, cfg


def test_rglru_params_match_jax_names_and_shapes(block):
    jp, p, cfg = block
    assert {n: tuple(t.shape) for n, t in p.named_parameters()} == \
        {k: v.shape for k, v in jp.items()}
    nb = 16 if cfg.d_model % 16 == 0 else 1
    assert p.w_a.shape[0] == nb and p.lam.dtype == torch.float32


def test_rglru_block_pieces_match_jax(block):
    jp, p, cfg = block
    d = cfg.d_model
    rng = np.random.default_rng(1)
    xr = rng.standard_normal((2, 11, d)).astype(np.float32)
    tail = rng.standard_normal((2, 3, d)).astype(np.float32)
    txr, ttail = torch.from_numpy(xr), torch.from_numpy(tail)
    np.testing.assert_allclose(
        recurrent._block_proj(txr, p.w_a).numpy(),
        np.asarray(jrec._block_proj(xr, jp["w_a"])), **TOL)
    for tl, jtl in ((None, None), (ttail, tail)):
        out, new_tail = recurrent._causal_conv(txr, p.conv_w, p.conv_b, tl)
        jout, jnew = jrec._causal_conv(xr, jp["conv_w"], jp["conv_b"], jtl)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
        assert np.array_equal(new_tail.numpy(), np.asarray(jnew))
    a, u = recurrent._gates(p, txr)
    ja, ju = jrec._gates(jp, xr)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), **TOL)
    assert a.min() > 0 and a.max() < 1


@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_block_and_decode_match_jax(block, with_state):
    jp, p, cfg = block
    d = cfg.d_model
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 13, d)).astype(np.float32)
    state = jstate = None
    if with_state:
        jstate = {"h": rng.standard_normal((2, d)).astype(np.float32),
                  "conv_tail": rng.standard_normal((2, 3, d)).astype(np.float32)}
        state = {k: torch.from_numpy(v) for k, v in jstate.items()}
    out, st = recurrent.rglru_block(p, torch.from_numpy(x), state)
    jout, jst = jrec.rglru_block(jp, jnp.asarray(x), jstate)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    for k in ("h", "conv_tail"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]), **TOL)
    # one decode step from the block's state, on both sides
    x1 = rng.standard_normal((2, 1, d)).astype(np.float32)
    out1, st1 = recurrent.rglru_decode(p, torch.from_numpy(x1), st)
    jout1, jst1 = jrec.rglru_decode(jp, jnp.asarray(x1), jst)
    np.testing.assert_allclose(out1.numpy(), np.asarray(jout1), **TOL)
    np.testing.assert_allclose(st1["h"].numpy(), np.asarray(jst1["h"]), **TOL)
    # decode of a token == the block over the sequence extended by it
    full, _ = recurrent.rglru_block(
        p, torch.from_numpy(np.concatenate([x, x1], axis=1)), state)
    np.testing.assert_allclose(out1.numpy()[:, 0], full.numpy()[:, -1], **TOL)


def test_rglru_init_state_shapes_and_types():
    st = recurrent.rglru_init_state(3, 8, torch.bfloat16)
    assert st["h"].shape == (3, 8) and st["h"].dtype == torch.float32
    assert st["conv_tail"].shape == (3, 3, 8)
    assert st["conv_tail"].dtype == torch.bfloat16
    assert not st["h"].any() and not st["conv_tail"].any()


# ---------------------------------------------------------------------------
# the reduced RecurrentGemma decoder
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reduced():
    """(jax model, jax params (numpy), port model, cfg) for the reduced
    RecurrentGemma: 3 layers (rglru, rglru, lattn), d 256, 4 heads over 1
    KV head of 64, window 128, vocab 1024."""
    jcfg = jget_config("recurrentgemma-9b").reduced()
    cfg = get_config("recurrentgemma-9b").reduced()
    assert repr(cfg) == repr(jcfg)
    jm = jbuild_model(jcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    # non-zero RG-LRU biases, so the converter's mapping of them shows
    rng = np.random.default_rng(0)
    for k in range(2):
        for name in recurrent.ZERO_INIT:
            leaf = tree["blocks"][k]["rglru"][name]
            tree["blocks"][k]["rglru"][name] = \
                (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)
    return jm, tree, params_from_jax(tree, cfg, device="cpu"), cfg


def test_reduced_config_shape():
    cfg = get_config("recurrentgemma-9b").reduced()
    assert cfg.pattern == ("rglru", "rglru", "lattn")
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.local_attn_window, cfg.vocab_size) \
        == (256, 4, 1, 64, 128, 1024)
    full = get_config("recurrentgemma-9b")
    assert full.pattern.count("rglru") == 26 and full.pattern.count("lattn") == 12


def test_converter_maps_the_stacked_super_block(reduced):
    _, tree, model, _ = reduced
    rg = tree["blocks"][0]["rglru"]
    assert rg["w_a"].shape == (1, 16, 16, 16) and rg["conv_w"].shape == (1, 4, 256)
    assert np.array_equal(model.layers[0].rglru.w_a.numpy(), rg["w_a"][0])
    assert np.array_equal(model.layers[1].rglru.b_x.numpy(),
                          tree["blocks"][1]["rglru"]["b_x"][0])
    assert np.array_equal(model.layers[2].attn.wk.numpy(),
                          tree["blocks"][2]["attn"]["wk"][0])
    assert (model.layers[0].rglru.lam == np.float32(0.65)).all()


@pytest.mark.parametrize("s", [16, 150])
def test_reduced_forward_matches_jax(reduced, s):
    jm, tree, model, cfg = reduced
    tokens = np.random.default_rng(s).integers(
        0, cfg.vocab_size, (2, s)).astype(np.int32)
    jlogits, _, _ = jax.jit(lambda p, t: jm.forward(p, {"tokens": t}))(
        tree, tokens)
    with torch.inference_mode():
        logits, cache = model(torch.from_numpy(tokens))
    assert cache is None
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


@pytest.mark.parametrize("s,cache_len", [(150, None), (100, None), (40, 60)])
def test_reduced_prefill_cache_matches_jax(reduced, s, cache_len):
    """S = 150 lies past the window of 128, so the ring keeps positions
    22..149 at slot pos % 128; S = 100 fills slots 0..99."""
    jm, tree, model, cfg = reduced
    tokens = np.random.default_rng(s).integers(
        0, cfg.vocab_size, (2, s)).astype(np.int32)
    _, jcache, _ = jax.jit(lambda p, t: jm.forward(
        p, {"tokens": t}, collect_cache=True, cache_len=cache_len))(
            tree, tokens)
    with torch.inference_mode():
        hidden, cache = model(torch.from_numpy(tokens), collect_cache=True,
                              cache_len=cache_len, return_hidden=True)
    assert hidden.shape == (2, s, cfg.d_model)
    for i, (kind, entry) in enumerate(zip(cfg.pattern, cache)):
        jentry = jcache["blocks"][i]
        for key, value in entry.items():
            np.testing.assert_allclose(value.numpy(),
                                       np.asarray(jentry[key])[0], **TOL)
    ring = cache[2]["k"]
    assert ring.shape[1] == min(cache_len or s, cfg.local_attn_window)


def test_reduced_decode_past_the_window_matches_jax(reduced):
    """40 tokens one at a time over a ring of 16 slots (window 16), as the
    JAX package's test_ring_cache_beyond_window does: each step against
    JAX's decode step and against the full-sequence forward."""
    jm0, tree, _, cfg = reduced
    cfg2 = cfg.with_(local_attn_window=16)
    jm = jbuild_model(jget_config("recurrentgemma-9b").reduced().with_(
        local_attn_window=16))
    model = params_from_jax(tree, cfg2, device="cpu")
    b, s = 2, 40
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)
    jdec = jax.jit(jm.decode_step)
    jcache = jm.init_cache(tree, b, s, jnp.float32)
    with torch.inference_mode():
        full, _ = model(torch.from_numpy(toks))
        cache = model.init_cache(b, s, torch.float32)
        assert cache[2]["k"].shape == (b, 16, 1, 64)
        for t in range(s):
            pos = np.full((b,), t, np.int32)
            lg, cache = model.decode_step(torch.from_numpy(toks[:, t:t + 1]),
                                          cache, torch.from_numpy(pos).long())
            jlg, jcache = jdec(tree, toks[:, t:t + 1], jcache, pos)
            np.testing.assert_allclose(lg.numpy(), np.asarray(jlg),
                                       atol=DECODE_ATOL)
            np.testing.assert_allclose(lg.numpy()[:, 0], full.numpy()[:, t],
                                       atol=DECODE_ATOL)


def test_reduced_decode_over_the_default_bf16_cache_matches_jax(reduced):
    """Both sides' default caches (bf16 rings and conv tails, f32 h) under
    the f32 model, 40 steps past a window of 16: each step's logits
    against JAX's decode step at the decode gate. The rings stay bf16 on
    both sides; the conv tails come back f32 after the first step on
    both sides."""
    jm0, tree, _, cfg = reduced
    cfg2 = cfg.with_(local_attn_window=16)
    jm = jbuild_model(jget_config("recurrentgemma-9b").reduced().with_(
        local_attn_window=16))
    model = params_from_jax(tree, cfg2, device="cpu")
    b, s = 2, 40
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)
    jdec = jax.jit(jm.decode_step)
    jcache = jm.init_cache(tree, b, s)
    assert jcache["blocks"][2]["k"].dtype == jnp.bfloat16
    with torch.inference_mode():
        cache = model.init_cache(b, s)
        assert cache[2]["k"].dtype == torch.bfloat16
        assert cache[0]["conv_tail"].dtype == torch.bfloat16
        assert cache[0]["h"].dtype == torch.float32
        for t in range(s):
            pos = np.full((b,), t, np.int32)
            lg, cache = model.decode_step(torch.from_numpy(toks[:, t:t + 1]),
                                          cache, torch.from_numpy(pos).long())
            jlg, jcache = jdec(tree, toks[:, t:t + 1], jcache, pos)
            assert lg.dtype == torch.float32
            np.testing.assert_allclose(lg.numpy(), np.asarray(jlg),
                                       atol=DECODE_ATOL)
        for i, (entry, jentry) in enumerate(zip(cache, jcache["blocks"])):
            for key, value in entry.items():
                jv = np.asarray(jentry[key])[0]
                assert str(value.dtype).split(".")[1] == str(jv.dtype), \
                    (i, key)
                np.testing.assert_allclose(value.float().numpy(),
                                           jv.astype(np.float32),
                                           atol=DECODE_ATOL)


def test_init_params_rglru_leaves():
    cfg = get_config("recurrentgemma-9b").reduced()
    m = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for name, p in m.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "lam":
            assert p.dtype == torch.float32 and (p == 0.65).all(), name
        elif leaf in ("conv_b", "b_a", "b_x"):
            assert not p.any(), name
        elif leaf == "scale":
            assert (p == 1).all(), name
        else:
            assert p.std() > 0 and p.abs().max() <= 2 * cfg.init_scale, name
    assert m.layers[0].rglru.w_a.shape == (16, 16, 16)
