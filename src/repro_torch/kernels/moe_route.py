"""The MoE sublayer's way into and out of its experts' capacity buffer.

``moe_dispatch(ids, x_flat, num_experts, cap, e0)`` gives each of the N k
assignments ``ids`` (N, k), token-major then top-k slot, its (expert,
row, keep) among the local experts [e0, e0 + num_experts), as
``dispatch_plain`` (``models.moe.dispatch``) does, and the (num_experts,
cap, d) buffer: each kept assignment's token row of ``x_flat`` (N, d) in
its row, zeros in every row past an expert's count.
``moe_combine(out, expert, row, keep, gates)`` sums each token's k
expert outputs (``out`` (num_experts, cap, d)) weighted by its gates, in
slot order: y (N, d).

A CPU tensor runs the plain versions (``moe_dispatch_plain``,
``moe_combine_plain``: the PyTorch ops ``models.moe`` ran before the
kernels, and still runs under autograd); a CUDA tensor (float32 or
bfloat16 rows of whole 16-byte units, 16-byte aligned, at most
MAX_EXPERTS local experts, top-k at most MAX_TOP_K) launches the kernels of ``csrc/moe_route.cu``, bit for bit
the plain versions, or raises. Neither has a backward: a CUDA call that
autograd would record raises. ``plan`` cuts the assignments for the
dispatch's two kernels.

On ``meta`` tensors (the dry-run) each wrapper checks its inputs as for
the card, launches and counts nothing, returns outputs of the kernels'
shapes and books their work (``roofline.analysis``).
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _build
from repro_torch.roofline import analysis as ra

THREADS = 256       # csrc/moe_route.cu kThreads: a thread an assignment
MAX_EXPERTS = 256   # kMaxExperts: a scan thread a local expert
MAX_CHUNKS = 64     # kMaxChunks: the rank kernel's blocks, at most
SLICE = 128         # kSlice: assignments a place block owns
MAX_TOP_K = 32      # kMaxTopK: a lane a slot in the combine

# kernel launches since the last ops.reset_launch_counts(); incremented
# under the lock, since worker threads launch too
dispatch_launches = 0
combine_launches = 0
COUNT_LOCK = threading.Lock()


def dispatch_plain(ids, num_experts: int, cap: int, e0: int = 0):
    """Buffer slots of the N * k assignments ``ids`` (N, k), token-major
    then top-k slot, among experts [e0, e0 + num_experts): (local expert
    (N k,), row (N k,), kept (N k,) bool). The p-th assignment to an
    expert takes row p; those at p >= ``cap``, and those to an expert
    outside the range, are dropped to (num_experts, 0), the dummy bucket.

    p is the JAX package's cumsum of a one-hot over the assignments, taken
    along rows of the transposed (E, N k) one-hot: the same integers, but
    a scan along the contiguous dim, where CUDA's scan down the N k rows
    of an (N k, E) one-hot runs one thread a column (14.6 ms a layer at
    granite's 65,536 assignments on an H100)."""
    flat = ids.reshape(-1) - e0
    local = (flat >= 0) & (flat < num_experts)
    flat = torch.where(local, flat, 0)
    experts = torch.arange(num_experts, device=flat.device)
    hot = (flat[None, :] == experts[:, None]) & local[None, :]
    row = torch.gather(hot.cumsum(1), 0, flat[None, :])[0] - 1
    keep = local & (row < cap)
    return (torch.where(keep, flat, num_experts), torch.where(keep, row, 0),
            keep)


def moe_dispatch_plain(ids, x_flat, num_experts: int, cap: int, e0: int = 0):
    """(expert, row, keep, buf (num_experts, cap, d)): ``dispatch_plain``'s
    slots and the kept assignments' token rows scattered into a zeroed
    buffer whose dummy bucket (row num_experts) takes the dropped ones and
    is cut off. Differentiable in ``x_flat``."""
    n, d = x_flat.shape
    expert, row, keep = dispatch_plain(ids, num_experts, cap, e0)
    tok = torch.arange(n, device=x_flat.device).repeat_interleave(
        ids.shape[-1])
    # kept assignments own distinct rows; dropped ones all land in the
    # dummy bucket, which is cut off before the products
    buf = x_flat.new_zeros(num_experts + 1, cap, d)
    buf[expert, row] = torch.where(keep[:, None], x_flat[tok], 0)
    return expert, row, keep, buf[:num_experts]


def moe_combine_plain(out, expert, row, keep, gates):
    """y (N, d): each assignment's output row (a zero row where dropped)
    times its gate (0 where dropped), rounded in ``out``'s dtype, and a
    token's k contributions summed in slot order, one add after another.
    Differentiable in ``out`` and ``gates``."""
    n, k = gates.shape
    _, cap, d = out.shape
    out = torch.cat([out, out.new_zeros(1, cap, d)])
    contrib = out[expert, row] * (gates.reshape(-1) * keep).to(
        out.dtype)[:, None]
    contrib = contrib.view(n, k, d)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return y


def plan(nk: int):
    """(chunk, n_chunks, n_slices) for N k assignments: the rank kernel's
    chunks, whole rounds of THREADS and at most MAX_CHUNKS of them (the
    place kernel sums their counts), and the place kernel's blocks of
    SLICE assignments, each inside one chunk."""
    rounds = max(1, -(-nk // (THREADS * MAX_CHUNKS)))
    chunk = THREADS * rounds
    return chunk, max(1, -(-nk // chunk)), max(1, -(-nk // SLICE))


def _check_rows(name, t):
    if t.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: unsupported dtype {t.dtype}")


def _check_units(name, t, rows_apart):
    """The kernels move rows in 16-byte units: ``t``'s rows, and the
    distance ``rows_apart`` between them, whole units from a 16-byte
    aligned base."""
    unit = 16 // t.element_size()
    if t.shape[-1] % unit or rows_apart % unit or t.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be whole 16-byte units ({unit} "
                         f"elements of {t.dtype}) from a 16-byte aligned "
                         f"base, got width {t.shape[-1]}, {rows_apart} "
                         f"elements apart, base {t.data_ptr() % 16} bytes "
                         f"past a unit")


def _check_dispatch(ids, x_flat, num_experts, cap):
    if ids.dim() != 2 or x_flat.dim() != 2 or \
            ids.shape[0] != x_flat.shape[0]:
        raise ValueError(f"moe_dispatch: ids must be (N, k) and x_flat (N, "
                         f"d), got {tuple(ids.shape)}, "
                         f"{tuple(x_flat.shape)}")
    if ids.dtype != torch.int64:
        raise TypeError(f"moe_dispatch: ids must be int64, got {ids.dtype}")
    _check_rows("moe_dispatch", x_flat)
    if not 0 < num_experts <= MAX_EXPERTS:
        raise ValueError(f"moe_dispatch: {num_experts} local experts, the "
                         f"kernel takes 1 to {MAX_EXPERTS}")
    if cap <= 0 or ids.numel() >= 2 ** 31 or x_flat.shape[1] == 0:
        raise ValueError(f"moe_dispatch: unsupported capacity {cap} or "
                         f"shape {tuple(x_flat.shape)}")
    if x_flat.stride(1) != 1:
        raise ValueError("moe_dispatch: x_flat needs a unit column stride")
    _check_units("moe_dispatch", x_flat, x_flat.stride(0))


def _check_combine(out, expert, row, keep, gates):
    _check_rows("moe_combine", out)
    if gates.dtype != torch.float32:
        raise TypeError(f"moe_combine: gates must be float32, got "
                        f"{gates.dtype}")
    if out.dim() != 3 or gates.dim() != 2 or gates.shape[1] == 0:
        raise ValueError(f"moe_combine: out must be (E, cap, d) and gates "
                         f"(N, k), got {tuple(out.shape)}, "
                         f"{tuple(gates.shape)}")
    if not 0 < out.shape[0] <= MAX_EXPERTS or gates.shape[1] > MAX_TOP_K:
        raise ValueError(f"moe_combine: {out.shape[0]} local experts and "
                         f"top-{gates.shape[1]}, the kernel takes 1 to "
                         f"{MAX_EXPERTS} and at most {MAX_TOP_K}")
    nk = gates.numel()
    if expert.shape != (nk,) or row.shape != (nk,) or keep.shape != (nk,) \
            or expert.dtype != torch.int64 or row.dtype != torch.int64 \
            or keep.dtype != torch.bool:
        raise ValueError("moe_combine: expert, row (N k,) int64 and keep "
                         "(N k,) bool, as moe_dispatch gives them")
    _check_units("moe_combine", out, out.shape[-1])


def run_dispatch_entry(ids, x_flat, num_experts: int, cap: int, e0: int):
    """``moe_dispatch``'s two kernels on CUDA tensors, uncounted."""
    _check_dispatch(ids, x_flat, num_experts, cap)
    ids = ids.contiguous()
    (n, d), k = x_flat.shape, ids.shape[1]
    nk = n * k
    chunk, n_chunks, n_slices = plan(nk)
    dev = x_flat.device
    slots = torch.empty(2, nk, dtype=torch.int64, device=dev)
    keep = torch.empty(nk, dtype=torch.bool, device=dev)
    buf = torch.empty(num_experts, cap, d, dtype=x_flat.dtype, device=dev)
    # the rank kernel's ranks (N k) and counts (n_chunks, num_experts)
    scratch = torch.empty(nk + n_chunks * num_experts, dtype=torch.int32,
                          device=dev)
    _build.check(_build.library().repro_moe_dispatch(
        ids.data_ptr(), x_flat.data_ptr(), x_flat.element_size(), n, k, d,
        x_flat.stride(0), num_experts, e0, cap, chunk, n_chunks, n_slices,
        scratch.data_ptr(), slots[0].data_ptr(), slots[1].data_ptr(),
        keep.data_ptr(), buf.data_ptr(), _build.stream_ptr(x_flat)),
        "moe_dispatch")
    return slots[0], slots[1], keep, buf


def run_combine_entry(out, expert, row, keep, gates):
    """``moe_combine``'s kernel on CUDA tensors, uncounted."""
    out, gates = out.contiguous(), gates.contiguous()
    expert, row, keep = expert.contiguous(), row.contiguous(), \
        keep.contiguous()
    _check_combine(out, expert, row, keep, gates)
    (n, k), (_, cap, d) = gates.shape, out.shape
    y = torch.empty(n, d, dtype=out.dtype, device=out.device)
    if n == 0:
        return y
    _build.check(_build.library().repro_moe_combine(
        out.data_ptr(), _build.DTYPE_CODES[out.dtype], expert.data_ptr(),
        row.data_ptr(), keep.data_ptr(), gates.data_ptr(), y.data_ptr(), n,
        k, d, cap, _build.stream_ptr(out)), "moe_combine")
    return y


def moe_dispatch(ids, x_flat, num_experts: int, cap: int, e0: int = 0):
    """(expert (N k,) int64, row (N k,) int64, keep (N k,) bool, buf
    (num_experts, cap, d)) of ``x_flat``'s dtype. CPU tensor:
    ``moe_dispatch_plain``; CUDA tensor: the rank and place kernels on the
    current stream, counted once a call."""
    global dispatch_launches
    kind = _build.device_kind("moe_dispatch", x_flat)
    if kind == "cpu":
        return moe_dispatch_plain(ids, x_flat, num_experts, cap, e0)
    _build.refuse_grad("moe_dispatch", x_flat)
    if kind == "meta":
        _check_dispatch(ids, x_flat, num_experts, cap)
        (n, d), k = x_flat.shape, ids.shape[1]
        ra.record("moe_dispatch", ra.moe_dispatch_work(
            n, k, d, num_experts, cap, x_flat.element_size()))
        slots = torch.empty(2, n * k, dtype=torch.int64, device="meta")
        return (slots[0], slots[1],
                torch.empty(n * k, dtype=torch.bool, device="meta"),
                torch.empty(num_experts, cap, d, dtype=x_flat.dtype,
                            device="meta"))
    out = run_dispatch_entry(ids, x_flat, num_experts, cap, e0)
    with COUNT_LOCK:
        dispatch_launches += 1
    return out


def moe_combine(out, expert, row, keep, gates):
    """y (N, d) of ``out``'s dtype. CPU tensor: ``moe_combine_plain``; CUDA
    tensor: the combine kernel on the current stream, counted."""
    global combine_launches
    kind = _build.device_kind("moe_combine", out)
    if kind == "cpu":
        return moe_combine_plain(out, expert, row, keep, gates)
    _build.refuse_grad("moe_combine", out, gates)
    if kind == "meta":
        _check_combine(out, expert, row, keep, gates)
        (n, k), (e, cap, d) = gates.shape, out.shape
        ra.record("moe_combine", ra.moe_combine_work(
            n, k, d, e, cap, out.element_size()))
        return torch.empty(n, d, dtype=out.dtype, device="meta")
    y = run_combine_entry(out, expert, row, keep, gates)
    with COUNT_LOCK:
        combine_launches += 1
    return y
