"""The MoE route (``kernels/moe_route.py``) on the CPU: the plain
dispatch and combine against the op chain ``models/moe.py`` ran before
them, the CUDA kernels' indexing emulated step by step, the choice of
path by grad state, and the ``meta`` path (shapes, booked work,
refusals). The kernels themselves are held to the plain versions on the
card in ``tests/test_torch_cuda_kernels.py``."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import moe_route, ops
from repro_torch.models import common, moe
from repro_torch.roofline import analysis as ra

torch.set_num_threads(2)

META = torch.device("meta")


def _former_dispatch(ids, num_experts, cap, e0=0):
    """``models.moe.dispatch`` as it was written before the kernels."""
    flat = ids.reshape(-1) - e0
    local = (flat >= 0) & (flat < num_experts)
    flat = torch.where(local, flat, 0)
    experts = torch.arange(num_experts, device=flat.device)
    hot = (flat[None, :] == experts[:, None]) & local[None, :]
    row = torch.gather(hot.cumsum(1), 0, flat[None, :])[0] - 1
    keep = local & (row < cap)
    return (torch.where(keep, flat, num_experts), torch.where(keep, row, 0),
            keep)


def _former_buffer(ids, x_flat, e, cap, e0):
    n, d = x_flat.shape
    expert, row, keep = _former_dispatch(ids, e, cap, e0)
    tok = torch.arange(n).repeat_interleave(ids.shape[1])
    buf = x_flat.new_zeros(e + 1, cap, d)
    buf[expert, row] = torch.where(keep[:, None], x_flat[tok], 0)
    return expert, row, keep, buf[:e]


def _former_local_expert_compute(x_flat, w_gate, w_up, w_down, gates, ids,
                                 act, cap, e0=0):
    """``models.moe.local_expert_compute`` as it was written before the
    kernels."""
    n, d = x_flat.shape
    e, k = w_gate.shape[0], ids.shape[1]
    expert, row, keep, buf = _former_buffer(ids, x_flat, e, cap, e0)
    h = act(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    out = torch.cat([torch.bmm(h, w_down), buf.new_zeros(1, cap, d)])
    contrib = out[expert, row] * (gates.reshape(-1) * keep).to(
        out.dtype)[:, None]
    contrib = contrib.view(n, k, d)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return y


def _routing(gen, n, e, k, pull=0.0):
    logits = torch.randn(n, e, generator=gen)
    logits[:, 0] += pull
    gates, ids = torch.topk(torch.softmax(logits, -1), k, dim=-1)
    return ids, gates / gates.sum(-1, keepdim=True)


def _case(e, k, case, n=96, d=48, f=32):
    """Inputs of one case: all experts, a routing pulled onto expert 0 past
    its capacity ("drops"), a rank's quarter of the experts from e0 = E / 2
    ("slice", E >= 8), bfloat16 rows and weights ("bf16")."""
    gen = torch.Generator().manual_seed(100 * e + k)
    ids, gates = _routing(gen, n, e, k, pull=4.0 if case == "drops" else 0)
    e_local, e0 = (max(e // 4, 1), e // 2) if case == "slice" else (e, 0)
    dtype = torch.bfloat16 if case == "bf16" else torch.float32
    x = torch.randn(n, d, generator=gen).to(dtype)
    w = [(torch.randn(e_local, *s, generator=gen) * 0.2).to(dtype)
         for s in ((d, f), (d, f), (f, d))]
    cap = max(int(moe.CAPACITY_FACTOR * n * k / e), 8)
    return ids, gates, x, w, e_local, e0, cap


ROUTE_CASES = [(4, 2), (32, 2), (32, 8), (64, 6), (64, 8)]


@pytest.mark.parametrize("case", ["whole", "drops", "slice", "bf16"])
@pytest.mark.parametrize("e,k", ROUTE_CASES)
def test_plain_route_equals_the_former_op_chain(e, k, case):
    """``moe.dispatch``, ``ops.moe_dispatch`` and ``ops.moe_combine`` on
    CPU tensors, and ``local_expert_compute`` through them, equal the op
    chain before the kernels bit for bit; the drops case drops."""
    ids, gates, x, (wg, wu, wd), e_local, e0, cap = _case(e, k, case)
    act = common.activation("silu")
    want = _former_buffer(ids, x, e_local, cap, e0)
    for got in (moe.dispatch(ids, e_local, cap, e0),
                ops.moe_dispatch(ids, x, e_local, cap, e0)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    if case == "drops":
        assert not want[2].all()
    out = torch.randn(e_local, cap, x.shape[1],
                      generator=torch.Generator().manual_seed(1)).to(x.dtype)
    expert, row, keep, _ = want
    former = torch.cat([out, out.new_zeros(1, *out.shape[1:])])
    contrib = (former[expert, row] * (gates.reshape(-1) * keep).to(
        out.dtype)[:, None]).view(*gates.shape, -1)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    assert torch.equal(ops.moe_combine(out, expert, row, keep, gates), y)
    assert torch.equal(
        moe.local_expert_compute(x, wg, wu, wd, gates, ids, act, cap, e0),
        _former_local_expert_compute(x, wg, wu, wd, gates, ids, act, cap,
                                     e0))


@pytest.mark.parametrize("e,k", ROUTE_CASES[:3])
def test_autograd_path_is_the_former_op_chain(e, k, monkeypatch):
    """Under autograd ``local_expert_compute`` runs the plain (differentiable)
    ops and never the ``ops`` entries: output and gradients in x, the gates
    and the weights equal the former chain's bit for bit. Outside autograd
    it calls the ``ops`` entries."""
    ids, gates, x, w, e_local, e0, cap = _case(e, k, "drops")
    act = common.activation("silu")
    called = []
    for name in ("moe_dispatch", "moe_combine"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _r=real, _n=name, **kw: (
            called.append(_n), _r(*a, **kw))[1])
    grads = []
    for fn in (moe.local_expert_compute, _former_local_expert_compute):
        leaves = [t.clone().requires_grad_() for t in (x, gates, *w)]
        xg, gg, *wg = leaves
        y = fn(xg, *wg, gg, ids, act, cap, e0)
        grads.append((y, torch.autograd.grad(y.square().sum(), leaves)))
    assert not called
    assert torch.equal(grads[0][0], grads[1][0])
    for a, b in zip(grads[0][1], grads[1][1]):
        assert torch.equal(a, b)
    with torch.no_grad():
        moe.local_expert_compute(x, *w, gates, ids, act, cap, e0)
    assert called == ["moe_dispatch", "moe_combine"]


def _emulate_dispatch(ids, e_local, cap, e0):
    """The dispatch kernels' indexing, step by step (``csrc/moe_route.cu``):
    the rank kernel's chunks (``plan``) walked a round of THREADS at a
    time, a lane's rank in its warp among the lanes of its expert, the
    8 warps' counts scanned on top of the chunk's running count; then each
    place block's first rows from the counts of the chunks before its
    own, its (expert, row, keep) and copy targets, and its share of the
    buffer rows zeroed past each expert's count. Returns the triple and
    how many times each buffer row is written."""
    flat = ids.reshape(-1).numpy() - e0
    nk = flat.size
    chunk, n_chunks, n_slices = moe_route.plan(nk)
    assert chunk % moe_route.SLICE == 0 and n_chunks <= moe_route.MAX_CHUNKS
    assert n_chunks * chunk >= nk and n_slices * moe_route.SLICE >= nk
    local = np.where((flat >= 0) & (flat < e_local), flat, -1)
    rank = np.full(nk, -1)
    counts = np.zeros((n_chunks, e_local), dtype=np.int64)
    for c in range(n_chunks):
        running = np.zeros(e_local, dtype=np.int64)
        for start in range(c * chunk, min((c + 1) * chunk, nk),
                           moe_route.THREADS):
            e = np.full(moe_route.THREADS, -2)
            part = local[start:start + moe_route.THREADS]
            e[:part.size] = part
            warps = e.reshape(-1, 32)
            first = np.zeros((len(warps), e_local), dtype=np.int64)
            run = running.copy()
            for w, lanes in enumerate(warps):
                first[w] = run
                for x in lanes[lanes >= 0]:
                    run[x] += 1
            running = run
            for t in range(part.size):
                if e[t] >= 0:
                    lanes = warps[t // 32]
                    below = int(np.sum(lanes[:t % 32] == e[t]))
                    rank[start + t] = first[t // 32, e[t]] + below
        counts[c] = running
    expert = np.full(nk, e_local)
    row = np.zeros(nk, dtype=np.int64)
    keep = np.zeros(nk, dtype=bool)
    written = np.zeros(e_local * cap, dtype=np.int64)
    filled = np.minimum(counts.sum(0), cap)
    zero_rows = -(-e_local * cap // n_slices)
    for blk in range(n_slices):
        a0 = blk * moe_route.SLICE
        base = counts[:min(a0, max(nk - 1, 0)) // chunk].sum(0)
        for a in range(a0, min(a0 + moe_route.SLICE, nk)):
            if rank[a] >= 0 and base[local[a]] + rank[a] < cap:
                expert[a], row[a], keep[a] = local[a], base[local[a]] + \
                    rank[a], True
                written[expert[a] * cap + row[a]] += 1
        for z in range(blk * zero_rows, min((blk + 1) * zero_rows,
                                            e_local * cap)):
            if z % cap >= filled[z // cap]:
                written[z] += 1
    return expert, row, keep, written


@pytest.mark.parametrize("n,e,k,e_local,e0,pull", [
    (197, 32, 8, 32, 0, 0.0),       # granite's bucket 1: 7 chunks
    (1000, 64, 6, 64, 0, 3.0),      # chunks of 256, drops
    (3152, 32, 8, 8, 16, 0.0),      # chunks of 512, a rank's slice
    (2900, 64, 6, 64, 0, 2.0),      # a last chunk and slice cut short
    (5, 4, 2, 4, 0, 0.0)])          # one chunk, one slice
def test_emulated_dispatch_kernels_equal_plain(n, e, k, e_local, e0, pull):
    """The kernels' indexing gives ``dispatch_plain``'s (expert, row, keep)
    and writes every row of the buffer exactly once (a copy or a zero)."""
    ids, _ = _routing(torch.Generator().manual_seed(n), n, e, k, pull)
    cap = max(int(moe.CAPACITY_FACTOR * n * k / e), 8)
    expert, row, keep, written = _emulate_dispatch(ids, e_local, cap, e0)
    want = moe_route.dispatch_plain(ids, e_local, cap, e0)
    np.testing.assert_array_equal(expert, want[0].numpy())
    np.testing.assert_array_equal(row, want[1].numpy())
    np.testing.assert_array_equal(keep, want[2].numpy())
    assert (written == 1).all()
    if pull:
        assert not keep.all()


@pytest.mark.parametrize("nk", [0, 1, 256, 257, 16384, 16385, 50432,
                                 1 << 20])
def test_plan_cuts_the_assignments(nk):
    chunk, n_chunks, n_slices = moe_route.plan(nk)
    assert chunk % (2 * moe_route.SLICE) == 0
    assert 1 <= n_chunks <= moe_route.MAX_CHUNKS and n_chunks * chunk >= nk
    assert (n_chunks - 1) * chunk < max(nk, 1)
    assert n_slices == max(1, -(-nk // moe_route.SLICE))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_route_books_its_work(dtype):
    """On ``meta`` the two entries return the CPU's shapes and dtypes, book
    their work and launch nothing."""
    n, k, d, e, cap = 64, 6, 32, 16, 30
    ids, gates = _routing(torch.Generator().manual_seed(0), n, e, k)
    x = torch.randn(n, d).to(dtype)
    out = torch.randn(e, cap, d).to(dtype)
    ops.reset_launch_counts()
    with ra.counting_work() as tally:
        got = ops.moe_dispatch(ids.to(META), x.to(META), e, cap)
        y = ops.moe_combine(out.to(META), *got[:3], gates.to(META))
    assert not any(ops.launch_counts().values())
    cpu = ops.moe_dispatch(ids, x, e, cap)
    for m, c in zip((*got, y), (*cpu, ops.moe_combine(out, *cpu[:3],
                                                      gates))):
        assert m.device == META and m.shape == c.shape and m.dtype == c.dtype
    elt = dtype.itemsize
    assert tally.kernels == {
        "moe_dispatch": {"calls": 1, "bytes": ra.moe_dispatch_work(
            n, k, d, e, cap, elt).bytes, "flops": {"fp32": 0.0}},
        "moe_combine": {"calls": 1, "bytes": ra.moe_combine_work(
            n, k, d, e, cap, elt).bytes,
            "flops": {"fp32": n * d * (2 * k - 1)}}}
    # the combine reads at most the buffer's rows and each kept one
    assert ra.moe_combine_work(n, k, d, e, 4, elt).bytes < \
        ra.moe_combine_work(n, k, d, e, cap, elt).bytes


def test_route_wrappers_refuse_what_the_kernels_do_not_take():
    """As for the card: more local experts than MAX_EXPERTS, rows other
    than float32 and bfloat16, int32 ids, gates other than float32, a
    top-k above MAX_TOP_K."""
    ids = torch.zeros(4, 2, dtype=torch.int64, device=META)
    x = torch.zeros(4, 64, device=META)
    with pytest.raises(ValueError, match="local experts"):
        ops.moe_dispatch(ids, x, moe_route.MAX_EXPERTS + 1, 8)
    for bad in (x.half(), x.double()):
        with pytest.raises(TypeError, match="dtype"):
            ops.moe_dispatch(ids, bad, 4, 8)
    with pytest.raises(TypeError, match="int64"):
        ops.moe_dispatch(ids.int(), x, 4, 8)
    expert, row, keep, buf = ops.moe_dispatch(ids, x, 4, 8)
    gates = torch.zeros(4, 2, device=META)
    with pytest.raises(TypeError, match="dtype"):
        ops.moe_combine(buf.half(), expert, row, keep, gates)
    with pytest.raises(ValueError, match="local experts"):
        ops.moe_combine(torch.zeros(moe_route.MAX_EXPERTS + 1, 8, 64,
                                    device=META), expert, row, keep, gates)
    with pytest.raises(TypeError, match="float32"):
        ops.moe_combine(buf, expert, row, keep, gates.bfloat16())
    k = moe_route.MAX_TOP_K + 1
    flat = torch.zeros(4 * k, dtype=torch.int64, device=META)
    with pytest.raises(ValueError, match="top-"):
        ops.moe_combine(buf, flat, flat, flat.bool(),
                        torch.zeros(4, k, device=META))


def _unaligned_rows(dev, dtype):
    """(case, x_flat) of rows the kernels do not take: a width of six
    elements, rows 66 elements apart, a base one element past a 16-byte
    unit."""
    def zeros(*shape):
        return torch.zeros(*shape, dtype=dtype, device=dev)
    return (("width", zeros(4, 6)), ("stride", zeros(4, 66)[:, :64]),
            ("base", zeros(4 * 64 + 1)[1:].view(4, 64)))


@pytest.mark.parametrize("case", ["width", "stride", "base"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_wrappers_refuse_rows_not_of_16_byte_units(case, dtype):
    """As for the card: the dispatch refuses rows that are not whole
    16-byte units 16 bytes apart from an aligned base, the combine an
    expert output of such a width; the plain versions on the CPU take
    them."""
    x = dict(_unaligned_rows(META, dtype))[case]
    ids = torch.zeros(4, 2, dtype=torch.int64, device=META)
    with pytest.raises(ValueError, match="16-byte units"):
        ops.moe_dispatch(ids, x, 4, 8)
    if case == "width":
        flat = torch.zeros(8, dtype=torch.int64, device=META)
        with pytest.raises(ValueError, match="16-byte units"):
            ops.moe_combine(torch.zeros(4, 8, 6, dtype=dtype, device=META),
                            flat, flat, flat.bool(),
                            torch.zeros(4, 2, device=META))
    cpu = dict(_unaligned_rows("cpu", dtype))[case]
    ids = torch.zeros(4, 2, dtype=torch.int64)
    expert, row, keep, buf = ops.moe_dispatch(ids, cpu, 4, 8)
    assert buf.shape == (4, 8, cpu.shape[1])
