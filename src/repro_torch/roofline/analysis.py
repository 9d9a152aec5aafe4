"""Roofline terms on an NVIDIA H100, from the dry-run's counts and from
each kernel's work.

    compute term    = the products' FLOPs a rank / the tensor-core rate of
                      the dtype + each kernel's FLOPs / the rate of its type
    memory term     = bytes a rank / HBM bandwidth
    collective term = collective bytes a rank (on a ring) / NVLink bandwidth

Counterpart of the JAX package's ``roofline/analysis.py`` with the
H100's data-sheet rates in place of v5e's. The port has no HLO: the
dry-run (``launch/dryrun.py``) counts the aten products' FLOPs with
``torch.utils.flop_counter.FlopCounterMode`` and their operand bytes, and
every hand-written kernel's call books its work (``record``) from its
shapes alone, so that a step on ``meta`` tensors is counted without a
card; together they take the place of ``roofline/hlo.py``'s scan-corrected
HLO parse. ``model_flops`` = 6·N·D (train), 2·N·D (prefill), 2·N·B (one
decode step), N the active parameters for MoE; MODEL_FLOPS / counted FLOPs
says how much of the counted compute is useful (remat's recompute and the
dense (S, S) products a mask throws away lower it).

The rates are the data sheet's, not measured. A 16 x 16 mesh is 256 cards,
32 nodes of 8: a model group of 16 spans two nodes, so its collectives
cross InfiniBand as well as NVLink, and the collective term at the NVLink
rate is a lower bound.

Each kernel's bound (the ``*_bound_ms`` functions, the bound column of
PERF.md and of ``chip_smoke.py``'s kernels line) is the larger of the
bytes its function must move (each input read once, each output written
once) over the HBM rate and its operations over the peak rate of their
type. ``*_work`` counts the bytes and operations from shapes and dtypes
alone, so it runs on ``meta`` tensors; ``bound`` turns a ``Work`` into
milliseconds at given rates.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, InputShape


@dataclasses.dataclass(frozen=True)
class Rates:
    """A card's data-sheet rates: HBM bytes/s, FP32 FLOP/s on the CUDA
    cores, dense tensor-core FLOP/s by input type (TF32 for float32, bf16),
    NVLink bytes/s a direction."""
    name: str
    hbm: float
    fp32: float
    tf32: float
    bf16: float
    link: float

    def peak(self, rate: str) -> float:
        """FLOP/s of an operation type: "fp32", "tf32" or "bf16"."""
        return {"fp32": self.fp32, "tf32": self.tf32, "bf16": self.bf16}[rate]

    def tensor_rate(self, dtype) -> str:
        """The tensor-core type that products of ``dtype`` run at."""
        return "bf16" if dtype == torch.bfloat16 else "tf32"

    def tensor_peak(self, dtype) -> float:
        """Dense tensor-core FLOP/s of products of ``dtype``."""
        return self.peak(self.tensor_rate(dtype))


# H100 SXM5 80 GB: 3.35 TB/s HBM3, 67 TFLOP/s FP32, 495 / 989 TFLOP/s dense
# TF32 / bf16, NVLink 4 at 900 GB/s both directions together
H100_SXM = Rates("H100 SXM", 3.35e12, 67e12, 495e12, 989e12, 450e9)
# H100 PCIe 80 GB: 2.0 TB/s, 51, 378 / 756 TFLOP/s, an NVLink bridge of
# 600 GB/s both directions together
H100_PCIE = Rates("H100 PCIe", 2.0e12, 51e12, 378e12, 756e12, 300e9)


def rates_for(name: str) -> Rates:
    """The rates of the H100 part ``nvidia-smi`` names (the PCIe part by
    "PCIe" in its name, else SXM)."""
    return H100_PCIE if "PCIe" in name else H100_SXM


# ---------------------------------------------------------------------------
# kernel work and bounds
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Work:
    """What a kernel call must do: ``bytes`` moved (each input read once,
    each output written once) and ``flops`` operations of type ``rate``
    ("fp32" on the CUDA cores, "tf32" or "bf16" on the tensor cores)."""
    bytes: float
    flops: float
    rate: str = "fp32"


def bound(work: Work, bw: float, peak: float):
    """(ms, "bytes" or "operations"): the larger of the bytes over ``bw``
    and the operations over ``peak``, and which one it is."""
    by_bytes, by_ops = work.bytes / bw, work.flops / peak
    return max(by_bytes, by_ops) * 1e3, \
        "bytes" if by_bytes >= by_ops else "operations"


def bvsb_work(b: int, v: int, elt: int) -> Work:
    """(B, V) logits of ``elt`` bytes read, conf and top-1 written; a
    compare, subtract, exp and add an element."""
    return Work(b * v * elt + b * 8, 4 * b * v)


def bvsb_partials_work(b: int, v: int, elt: int) -> Work:
    """The partial entry: a rank's (B, V) columns read, a 16-byte tuple a
    row written, four operations an element."""
    return Work(b * v * elt + b * 16, 4 * b * v)


def bvsb_merge_work(b: int, n: int) -> Work:
    """The merge entry: (B, n, 4) f32 tuples read, conf and top-1 written,
    about 12 operations a tuple."""
    return Work(b * n * 16 + b * 8, 12 * b * n)


def moe_dispatch_work(n, k, d, e, cap, elt) -> Work:
    """The MoE dispatch: ids (N, k) int64 and x (N, d) read, the (E, cap,
    d) buffer and each assignment's expert, row (int64) and keep written;
    no arithmetic."""
    return Work(n * k * 8 + n * d * elt + e * cap * d * elt + n * k * 17,
                0.0)


def moe_combine_work(n, k, d, e, cap, elt, kept=None) -> Work:
    """The MoE combine: each kept assignment's output row read (``kept``
    of them; from shapes alone at most min(N k, E cap)), the triples and
    gates (N, k) read, y (N, d) written; a multiply an element and slot,
    an add an element and slot after the first."""
    rows = min(n * k, e * cap) if kept is None else kept
    return Work(rows * d * elt + n * k * 21 + n * d * elt,
                n * d * (2 * k - 1))


def flash_pairs(s, t, causal=True, window=None):
    """(query, key) pairs attention keeps: min(i + 1, window) keys for
    query i when causal, every one of S x T otherwise."""
    w = window or s
    if not causal:
        return s * t
    if s > w:
        return w * (w + 1) // 2 + (s - w) * w
    return s * (s + 1) // 2


def flash_work(b, s, t, h, kv, hd, elt, *, causal=True, window=None,
               tensor_cores=True) -> Work:
    """The forward: q, k, v read, out written in their type; a q.k and a
    p.v FMA (2 FLOP each) per kept (query, key) pair, head and head dim.
    On the tensor cores f32 is 3xTF32 (three TF32 products an FMA pair) at
    the TF32 rate, bf16 one product at the bf16 rate; on the CUDA cores
    (``tensor_cores`` False) one at the FP32 rate."""
    moved = (2 * b * s * h * hd + 2 * b * t * kv * hd) * elt
    ops_ = 4 * hd * flash_pairs(s, t, causal, window) * b * h
    if not tensor_cores:
        return Work(moved, ops_)
    if elt == 4:
        return Work(moved, 3 * ops_, "tf32")
    return Work(moved, ops_, "bf16")


def flash_bwd_work(b, s, t, h, kv, hd, elt, *, causal=True, window=None,
                   tensor_cores=True) -> Work:
    """The backward: 2.5 times the forward's products (the recomputed q.k
    and dO.v, and dV, dK and dQ, against the forward's two), over q, k, v,
    o, dO and lse read and dq, dk, dv written once; one product an FMA
    pair at the tensor-core rate of the type, or at the FP32 rate on the
    CUDA cores."""
    moved = (4 * b * s * h * hd + 4 * b * t * kv * hd) * elt + b * h * s * 4
    ops_ = 2.5 * 4 * hd * flash_pairs(s, t, causal, window) * b * h
    rate = ("tf32" if elt == 4 else "bf16") if tensor_cores else "fp32"
    return Work(moved, ops_, rate)


def decode_work(b, h, hd, kv, slots, q_elt, cache_elt) -> Work:
    """Each of ``slots`` valid cache slots (summed over the batch) read
    once, K and V in the cache's type; q read and out written in q's type,
    the lengths read; a q.k and a p.v FMA per (query head, valid slot, head
    dim)."""
    return Work(2 * b * h * hd * q_elt + 2 * slots * kv * hd * cache_elt
                + b * 4, 4 * hd * slots * h)


def decode_partials_work(b, h, hd, kv, slots, n_splits, q_elt,
                         cache_elt) -> Work:
    """The partial entry on a rank's shard: q, the shard's ``slots`` valid
    slots and the lengths read, this rank's ``n_splits`` splits of the
    buffer (m, l and hd floats a row) written (the zeros written over the
    other ranks' splits, for the gather, are not the function's work); a
    q.k and a p.v FMA per (query head, slot, head dim)."""
    own = b * kv * n_splits * (h // kv) * (2 + hd)
    return Work(b * h * hd * q_elt + 2 * slots * kv * hd * cache_elt
                + own * 4 + b * 4, 4 * hd * slots * h)


def decode_merge_work(b, h, hd, kv, n_splits, q_elt) -> Work:
    """The merge entry over every rank's ``n_splits`` splits: the buffer
    read, out written; a multiply-add of l and of acc and an exp per
    (split, query head, head dim)."""
    rows = b * kv * n_splits * (h // kv)
    return Work(rows * (2 + hd) * 4 + b * h * hd * q_elt, 5 * rows * hd)


def rglru_work(b, s, d, elt) -> Work:
    """a and u read once, h written once (f32); a multiply and an add an
    element."""
    return Work(b * s * d * (2 * elt + 4), 2 * b * s * d)


def rglru_bwd_work(b, s, d, elt) -> Work:
    """a read in its type; h and dh read, da and du written in f32 (5 B S D
    4 bytes in f32); a multiply, an add and a multiply an element."""
    return Work(b * s * d * (elt + 16), 3 * b * s * d)


def bvsb_bound_ms(b, v, elt, bw, flops):
    return bound(bvsb_work(b, v, elt), bw, flops)


def bvsb_partials_bound_ms(b, v, elt, bw, flops):
    return bound(bvsb_partials_work(b, v, elt), bw, flops)


def bvsb_merge_bound_ms(b, n, bw, flops):
    return bound(bvsb_merge_work(b, n), bw, flops)


def _flash_shape(q, k):
    b, s, h, hd = q.shape
    return b, s, k.shape[1], h, k.shape[2], hd, q.element_size()


def flash_bounds_ms(q, k, bw, flops, tc, window=None, causal=True, *,
                    tensor_cores):
    """(the bound at the rate of the kernel the shape picks, the bound at
    the FP32 CUDA-core rate) of the forward on q (B, S, H, hd) over k (B,
    T, KV, hd). ``tensor_cores``: whether the shape runs the tensor-core
    kernel (``flash_attention.tensor_core_rule``); ``tc`` the tensor-core
    FLOP/s of q's dtype (``Rates.tensor_peak``)."""
    shape = _flash_shape(q, k)
    kw = dict(causal=causal, window=window)
    fp32 = bound(flash_work(*shape, tensor_cores=False, **kw), bw, flops)
    if not tensor_cores:
        return fp32, fp32
    return bound(flash_work(*shape, **kw), bw, tc), fp32


def flash_bwd_bounds_ms(q, k, bw, flops, tc, window=None, causal=True):
    """(the bound at the tensor-core rate ``tc`` of the inputs' type, the
    bound at the FP32 CUDA-core rate) of the backward
    (``flash_bwd_work``)."""
    shape = _flash_shape(q, k)
    kw = dict(causal=causal, window=window)
    return (bound(flash_bwd_work(*shape, **kw), bw, tc),
            bound(flash_bwd_work(*shape, tensor_cores=False, **kw), bw,
                  flops))


def valid_slots(lengths, w: int, start: int = 0) -> int:
    """Valid slots of a ring's slots [start, start + w) summed over the
    batch, for ``lengths`` (B,) of the whole ring (data-dependent: counted
    on the run's lengths)."""
    return int((lengths.long() - start).clamp(0, w).sum())


def decode_bound_ms(q, k, lengths, bw, flops):
    b, h, hd = q.shape
    return bound(decode_work(b, h, hd, k.shape[2],
                             valid_slots(lengths, k.shape[1]),
                             q.element_size(), k.element_size()), bw, flops)


def decode_partials_bound_ms(q, k_shard, lengths, rank, n_splits, bw,
                             flops):
    """The partial entry on rank ``rank``'s shard ``k_shard`` (B, W/m, KV,
    hd) of a ring whose lengths are ``lengths``, over ``n_splits`` splits."""
    b, h, hd = q.shape
    ws, kv = k_shard.shape[1], k_shard.shape[2]
    return bound(decode_partials_work(
        b, h, hd, kv, valid_slots(lengths, ws, rank * ws), n_splits,
        q.element_size(), k_shard.element_size()), bw, flops)


def decode_merge_bound_ms(parts, q, kv, bw, flops):
    """The merge entry over the gathered buffer ``parts`` of q (B, H, hd)
    over ``kv`` KV heads."""
    b, h, hd = q.shape
    n_splits = parts.numel() // (2 + hd) // (b * h)
    return bound(decode_merge_work(b, h, hd, kv, n_splits,
                                   q.element_size()), bw, flops)


def rglru_bound_ms(a, bw, flops):
    return bound(rglru_work(*a.shape, a.element_size()), bw, flops)


def rglru_bwd_bound_ms(a, bw, flops):
    return bound(rglru_bwd_work(*a.shape, a.element_size()), bw, flops)


# ---------------------------------------------------------------------------
# the kernels' booked work
# ---------------------------------------------------------------------------
class WorkTally:
    """The work the kernel wrappers booked while a ``counting_work`` block
    ran: by kernel, its calls, bytes and FLOPs by operation type."""

    def __init__(self):
        self.kernels: Dict[str, dict] = {}

    def add(self, name: str, work: Work) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "bytes": 0.0,
                                           "flops": {}})
        k["calls"] += 1
        k["bytes"] += work.bytes
        k["flops"][work.rate] = k["flops"].get(work.rate, 0.0) + work.flops

    @property
    def flops(self) -> float:
        return sum(sum(k["flops"].values()) for k in self.kernels.values())

    @property
    def bytes(self) -> float:
        return sum(k["bytes"] for k in self.kernels.values())

    @property
    def flops_by_rate(self) -> Dict[str, float]:
        """The FLOPs of every kernel summed by operation type."""
        out: Dict[str, float] = {}
        for k in self.kernels.values():
            for rate, flops in k["flops"].items():
                out[rate] = out.get(rate, 0.0) + flops
        return out


_TALLIES = []
_TALLY_LOCK = threading.Lock()


@contextlib.contextmanager
def counting_work():
    """Collect the work every kernel call books (``record``) while the
    block runs: yields a ``WorkTally``."""
    tally = WorkTally()
    with _TALLY_LOCK:
        _TALLIES.append(tally)
    try:
        yield tally
    finally:
        with _TALLY_LOCK:
            _TALLIES.remove(tally)


def record(name: str, work: Work) -> None:
    """Book a kernel call's work into every open ``counting_work`` tally."""
    with _TALLY_LOCK:
        for tally in _TALLIES:
            tally.add(name, work)


# ---------------------------------------------------------------------------
# the step's roofline
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class StepStats:
    """A step's counts a rank, under the names of the JAX package's
    ``HloStats``: the products' and kernels' FLOPs and bytes, the
    collective bytes on a ring and the collectives by kind;
    ``kernel_flops`` the part of ``dot_flops`` that the hand-written
    kernels do, by operation type ("fp32", "tf32", "bf16")."""
    dot_flops: float
    dot_bytes: float
    collective_bytes: float
    collectives: Dict[str, float]
    kernel_flops: Dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops_per_device: float   # the counted FLOPs a rank (no HLO here)
    useful_ratio: float
    collectives: Dict[str, float]
    per_device_hbm_bytes: float

    def as_dict(self):
        return dataclasses.asdict(self)


def model_flops(cfg: ArchConfig, shape: InputShape,
                n_active: Optional[float] = None) -> float:
    """6·N·D with N = active params; D = processed tokens.

    train: fwd+bwd = 6·N·D; prefill: 2·N·D; decode: 2·N per token·B.
    n_active, when given, is the exact count from the instantiated params
    (minus inactive experts); else the config estimate."""
    if n_active is None:
        n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # one decode step


def compute_roofline(cfg: ArchConfig, shape: InputShape, stats: StepStats,
                     n_chips: int, *, param_bytes_per_device: float = 0.0,
                     n_active: Optional[float] = None,
                     dtype=torch.bfloat16, rates: Rates = H100_SXM
                     ) -> Roofline:
    """The three terms a rank: the aten products' FLOPs at the tensor-core
    rate of ``dtype`` plus each kernel's FLOPs at the rate of its type
    (``stats.kernel_flops``), max(the products' and kernels' bytes, the
    parameters read once) at the HBM rate, the collective bytes at the
    NVLink rate."""
    flops_dev = stats.dot_flops
    # memory: the products' operand traffic is the dominant HBM term; the
    # parameters are read at least once a step however the products fuse
    mem_bytes_dev = max(stats.dot_bytes, param_bytes_per_device)
    product_flops = flops_dev - sum(stats.kernel_flops.values())
    compute_s = product_flops / rates.tensor_peak(dtype) + sum(
        flops / rates.peak(rate) for rate, flops in stats.kernel_flops.items())
    memory_s = mem_bytes_dev / rates.hbm
    coll_s = stats.collective_bytes / rates.link
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": coll_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape, n_active)
    total = flops_dev * n_chips
    return Roofline(
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=coll_s,
        dominant=dominant,
        model_flops=mf,
        hlo_flops_per_device=flops_dev,
        useful_ratio=mf / total if total else 0.0,
        collectives=dict(stats.collectives),
        per_device_hbm_bytes=mem_bytes_dev,
    )
