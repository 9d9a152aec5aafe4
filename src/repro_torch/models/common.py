"""Shared building blocks: init, RMSNorm, group norm, RoPE and M-RoPE,
gated MLP, embeddings, the LM loss, and the mesh context threaded
through the model.

Plain functions on tensors, in the JAX package's layout: activations
(B, S, d), heads (B, S, H, hd), weights applied as ``x @ W`` with W of
shape (d_in, d_out). The small modules here, in ``attention.py`` and in
``transformer.py`` hold the parameters, named as the JAX parameter tree
names them, and call these.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layout


# the label that takes no part in the loss
IGNORE = -100


# ---------------------------------------------------------------------------
# mesh context: how the model sees the (data, model) mesh
# ---------------------------------------------------------------------------
class _IntoRegion(torch.autograd.Function):
    """Forward the identity, backward a sum over ``group``: the transpose
    of a model-replicated input entering a region whose ranks each
    compute a part of what follows (shard_map's psum over the axes an
    input's spec leaves out)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _OutOfRegion(torch.autograd.Function):
    """Forward a sum over ``group``, backward the identity: the ranks'
    parts of a result added, each rank then holding the whole, so the
    cotangent of the whole is each part's. (``torch.distributed.nn``'s
    all_reduce sums again in the backward, m times the cotangent.)"""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """Forward the ranks' parts of ``x`` along ``dim`` in rank order on
    every rank of ``group``: a zeroed buffer with this rank's part in its
    place, summed over the group (exact; gloo gathers no CUDA tensors).
    Backward the cotangent summed over the group, this rank's slice of it
    kept (a reduce-scatter through an all_reduce): each rank's cotangent
    of the whole is its own rows' or heads' part."""

    @staticmethod
    def forward(ctx, x, dim, group, size, rank):
        ctx.args = dim, group, rank, x.shape[dim]
        shape = list(x.shape)
        shape[dim] *= size
        buf = x.new_zeros(shape)
        buf.narrow(dim, rank * x.shape[dim], x.shape[dim]).copy_(x)
        dist.all_reduce(buf, group=group)
        return buf

    @staticmethod
    def backward(ctx, g):
        dim, group, rank, n = ctx.args
        g = g.contiguous().clone()
        dist.all_reduce(g, group=group)
        part = g.narrow(dim, rank * n, n).clone(
            memory_format=torch.contiguous_format)
        return part, None, None, None, None


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """How the model sees the mesh: the JAX package's ``MeshContext`` over
    ``torch.distributed`` process groups.

    ``data_group`` (size ``data_size``, this rank at ``data_rank``) holds
    the ranks that split the batch, ``model_group`` (``model_size``,
    ``model_rank``) the ranks that split the model's layers (heads,
    features, channels, experts, vocabulary rows: ``models.layout``)
    and hold the same rows. A group is None where its size is 1:
    ``LOCAL`` is one card, where every function below is the identity.
    ``mesh_context`` builds one from a mesh.

    A region of a layer that the model ranks split takes its replicated
    input through ``into_model`` (a replicated weight that each rank uses
    only a part of too, so that its gradient is summed over the ranks)
    and hands its result out through ``out_of_model``.

    ``fsdp``: the model built in this context stores each matrix's other
    dim cut over the data ranks (``layout.data_dim``, ``cut_param``);
    each layer gathers those leaves (``gathered``) when it runs, through
    the model's own context, whatever context splits the batch.
    """
    data_group: Optional[Any] = None
    model_group: Optional[Any] = None
    data_size: int = 1
    model_size: int = 1
    data_rank: int = 0
    model_rank: int = 0
    fsdp: bool = False

    def into_model(self, x):
        """A model-replicated input of a model region: the identity, its
        gradient summed over the model group."""
        if self.model_group is None:
            return x
        return _IntoRegion.apply(x, self.model_group)

    def out_of_model(self, x):
        """The model ranks' parts summed; the gradient passes unchanged."""
        if self.model_group is None:
            return x
        return _OutOfRegion.apply(x, self.model_group)

    def sum_data(self, x):
        """The data ranks' values summed (a loss over the global batch);
        the gradient passes unchanged, each rank differentiating its own
        rows, and the trainer sums the gradients over the data group."""
        if self.data_group is None:
            return x
        return _OutOfRegion.apply(x, self.data_group)

    def all_reduce_data(self, x, op=dist.ReduceOp.SUM):
        """``x`` reduced over the data group in place, outside autograd."""
        if self.data_group is not None:
            dist.all_reduce(x, op=op, group=self.data_group)
        return x

    def all_reduce_model(self, x, op=dist.ReduceOp.SUM):
        """``x`` reduced over the model group in place, outside autograd."""
        if self.model_group is not None:
            dist.all_reduce(x, op=op, group=self.model_group)
        return x

    def gather_model(self, x, dim: int):
        """The model ranks' parts of ``x`` along ``dim``, in rank order, on
        every rank; the gradient summed over the model group, this rank's
        part of it kept (``_Gather``)."""
        if self.model_group is None:
            return x
        return _Gather.apply(x, dim, self.model_group, self.model_size,
                             self.model_rank)

    def gather_data(self, x, dim: int):
        """The data ranks' parts of an FSDP leaf ``x`` along ``dim``, in
        rank order, on every rank: ZeRO-3's gather; its backward sums the
        gradient over the data group and keeps this rank's part, ZeRO-3's
        reduce-scatter (``_Gather``)."""
        if self.data_group is None:
            return x
        return _Gather.apply(x, dim, self.data_group, self.data_size,
                             self.data_rank)

    def part(self, n: int, what: str = "a dim"):
        """(start, size) of this rank's part of ``n`` cut over the model
        ranks: model rank j holds [j n/m, (j + 1) n/m)."""
        if n % self.model_size:
            raise ValueError(f"{what} of {n} does not split over "
                             f"{self.model_size} model ranks")
        size = n // self.model_size
        return self.model_rank * size, size

    def data_part(self, n: int, what: str = "a dim"):
        """(start, size) of this rank's part of ``n`` cut over the data
        ranks (FSDP storage): data rank r holds [r n/d, (r + 1) n/d)."""
        if n % self.data_size:
            raise ValueError(f"{what} of {n} does not split over "
                             f"{self.data_size} data ranks")
        size = n // self.data_size
        return self.data_rank * size, size

    def expert_range(self, num_experts: int):
        """(first expert, number of experts) this rank holds: model rank
        j holds experts [j E/m, (j + 1) E/m)."""
        return self.part(num_experts, "an expert axis")

    def data_rows(self, b: int) -> slice:
        """This rank's rows of a global batch of ``b``: the data rank r's
        [r b / n, (r + 1) b / n)."""
        if b % self.data_size:
            raise ValueError(f"a batch of {b} does not split over "
                             f"{self.data_size} data ranks")
        n = b // self.data_size
        return slice(self.data_rank * n, (self.data_rank + 1) * n)

    def replicated(self) -> "MeshContext":
        """The same model group with the batch replicated over the data
        axis (the serve step's ``eff_batch_axes = ()``)."""
        return dataclasses.replace(self, data_group=None, data_size=1,
                                   data_rank=0)


LOCAL = MeshContext()


def _axis(mesh, name):
    """(group or None where the axis has one rank, size, this rank's
    position) of a mesh axis."""
    size = mesh.size(mesh.mesh_dim_names.index(name))
    if size == 1:
        return None, 1, 0
    return mesh.get_group(name), size, mesh.get_local_rank(name)


def mesh_context(mesh, fsdp: bool = False) -> MeshContext:
    """The ``MeshContext`` of a ("data", "model") ``DeviceMesh``
    (``launch.mesh.make_model_mesh``) for this rank, ``LOCAL`` for None:
    each axis's group, size and this rank's position; ``fsdp`` for a
    model stored FSDP over the data ranks."""
    if mesh is None:
        return LOCAL
    mg, ms, mr = _axis(mesh, "model")
    dg, ds, dr = _axis(mesh, "data")
    return MeshContext(data_group=dg, model_group=mg, data_size=ds,
                       model_size=ms, data_rank=dr, model_rank=mr,
                       fsdp=fsdp)


def param(*shape, device, dtype) -> nn.Parameter:
    """An uninitialised parameter that does not require grad (serving
    needs none); the model's init or the weight converter fills it, and
    the trainers turn gradients on for what they train."""
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


def cut_param(module: nn.Module, path, whole, cfg=None, *, mctx, device,
              dtype) -> None:
    """Set the parameter ``path[-1]`` of ``module``, of whole shape
    ``whole``: this rank's part of it where the model ranks cut it
    (``layout.model_dim`` of ``path``, the block's names and the leaf's),
    the dim recorded in ``module.model_cuts`` (``model.model_parts``
    reads it), and where the model is stored FSDP (``mctx.fsdp``) its
    data rank's part of the dim the data ranks cut (``layout.data_dim``),
    recorded in ``module.data_cuts`` (``model.data_parts``, ``gathered``);
    else the whole leaf."""
    dim = layout.model_dim(path, whole, mctx.model_size, cfg)
    ddim = layout.data_dim(path, whole, mctx.data_size) if mctx.fsdp \
        else None
    shape = list(whole)
    what = ".".join(path)
    if dim is not None:
        shape[dim] = mctx.part(whole[dim], what)[1]
        module.__dict__.setdefault("model_cuts", {})[path[-1]] = dim
    if ddim is not None:
        shape[ddim] = mctx.data_part(whole[ddim], what)[1]
        module.__dict__.setdefault("data_cuts", {})[path[-1]] = ddim
    setattr(module, path[-1], param(*shape, device=device, dtype=dtype))


def _fsdp_leaves(module: nn.Module):
    """(owner module, leaf, data dim) of every FSDP leaf of ``module`` and
    its submodules, found once."""
    found = module.__dict__.get("_fsdp_leaves")
    if found is None:
        found = [(sub, leaf, dim) for sub in module.modules()
                 for leaf, dim in sub.__dict__.get("data_cuts", {}).items()]
        module.__dict__["_fsdp_leaves"] = found
    return found


@contextlib.contextmanager
def gathered(module: nn.Module, store):
    """Run the block with every FSDP leaf of ``module`` gathered whole over
    the data ranks (``store``: the model's own ``MeshContext``), its
    gradient reduce-scattered back to the shard; the shards are put back,
    and the gathered leaves freed, when the block ends. A layer's forward
    runs in it, inside its remat region, so that remat gathers again in
    the backward rather than keeping every layer's gathered weights."""
    leaves = _fsdp_leaves(module)
    saved = []
    try:
        for sub, leaf, dim in leaves:
            shard = sub._parameters[leaf]
            saved.append((sub, leaf, shard))
            sub._parameters[leaf] = store.gather_data(shard, dim)
        yield
    finally:
        for sub, leaf, shard in saved:
            sub._parameters[leaf] = shard


def stored(module: nn.Module, leaf: str, store):
    """The parameter ``leaf`` of ``module`` whole over the data ranks:
    gathered (``MeshContext.gather_data``) where the model stores it
    FSDP, else itself."""
    p = getattr(module, leaf)
    dim = module.__dict__.get("data_cuts", {}).get(leaf)
    return p if dim is None else store.gather_data(p, dim)


class RMSNorm(nn.Module):
    def __init__(self, d, *, device, dtype):
        super().__init__()
        self.scale = param(d, device=device, dtype=dtype)

    def forward(self, x, eps):
        return rmsnorm(self.scale, x, eps)


class MLP(nn.Module):
    """Gated MLP. Where the layout cuts it (``layout.model_dim`` of the
    ``block`` it sits in: a dense MLP whose width f the model ranks
    divide, the shared experts) it is tensor-parallel: w_gate / w_up hold
    the rank's f/m columns, w_down its f/m rows, the input enters through
    ``into_model`` and the rows' partial products leave summed through
    ``out_of_model`` (``tp``); else every rank holds it whole."""

    def __init__(self, d, f, *, device, dtype, mctx=LOCAL, block=("mlp",)):
        super().__init__()
        kw = dict(mctx=mctx, device=device, dtype=dtype)
        cut_param(self, block + ("w_gate",), (d, f), **kw)
        cut_param(self, block + ("w_up",), (d, f), **kw)
        cut_param(self, block + ("w_down",), (f, d), **kw)
        self.tp = bool(getattr(self, "model_cuts", None))

    def partial(self, x, act):
        """This rank's partial output of an input already in the region."""
        return mlp_apply(self.w_gate, self.w_up, self.w_down, x, act)

    def forward(self, x, act, mctx=LOCAL):
        if not self.tp:
            return self.partial(x, act)
        return mctx.out_of_model(self.partial(mctx.into_model(x), act))


class Embedding(nn.Module):
    """Embedding table over the padded vocab, shared with the LM head
    when the config ties them. Over model ranks its rows are cut: rank j
    holds rows [j PV/m, (j + 1) PV/m)."""

    def __init__(self, vocab, d, *, device, dtype, mctx=LOCAL):
        super().__init__()
        cut_param(self, ("table",), (padded_vocab(vocab), d), mctx=mctx,
                  device=device, dtype=dtype)


def trunc_normal_(t: torch.Tensor, scale: float,
                  generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` with a normal truncated to [-2, 2], times ``scale``.

    The distribution of the JAX package's ``dense_init``, not its bits.
    Drawn on the generator's device: in place when that is ``t``'s
    device, else drawn there and copied (a CPU generator gives the same
    weights on every device). A generator made for "cuda" names no
    index: it draws on the current card.
    """
    with torch.no_grad():
        gen_dev = torch.device(generator.device)
        if gen_dev.type == "cuda" and gen_dev.index is None:
            gen_dev = torch.device("cuda", torch.cuda.current_device())
        if gen_dev == t.device and t.dtype == torch.float32:
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                        generator=generator)
            return t.mul_(scale)
        draw = torch.empty(t.shape, dtype=torch.float32,
                           device=generator.device)
        torch.nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        t.copy_(draw * scale)
    return t


def rmsnorm(scale, x, eps=1e-6):
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dt)


def groupnorm(x, eps=1e-6):
    """Headwise group norm of the xLSTM cells, x: (..., H, hd): each head
    normalised over hd in float32, with the population variance (JAX's
    ``jnp.var``), no scale; out in x's dtype."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exponent)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, hd); positions: (B, S) int. Rotates split halves
    (``x1, x2 = split(x, 2)``), not interleaved pairs."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    ang = positions.float()[..., None] * freqs              # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions3, theta: float, sections):
    """Qwen2-VL multimodal RoPE [arXiv:2409.12191]. x: (B, S, H, hd);
    positions3: (3, B, S) int (t, h, w) position ids; sections: the
    per-axis frequency blocks, summing to hd / 2. Frequency block i takes
    its angle from axis i; the halves rotate as in ``apply_rope``."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"head_dim / 2 = {half}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # (hd/2,)
    ang_axes = positions3.float()[..., None] * freqs        # (3, B, S, hd/2)
    parts, off = [], 0
    for ax, sec in enumerate(sections):
        parts.append(ang_axes[ax, :, :, off:off + sec])
        off += sec
    ang = torch.cat(parts, dim=-1)                          # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def activation(act: str):
    """The gated MLP's activation: SiLU, or tanh GELU (jax.nn.gelu's
    default) for ``gelu``."""
    if act == "silu":
        return F.silu
    return functools.partial(F.gelu, approximate="tanh")


def mlp_apply(w_gate, w_up, w_down, x, act: str = "silu"):
    """Gated MLP: SwiGLU for ``silu``, GeGLU (tanh GELU, as jax.nn.gelu)
    for ``gelu``."""
    return (activation(act)(x @ w_gate) * (x @ w_up)) @ w_down


def padded_vocab(vocab_size: int, multiple: int = 128) -> int:
    return ((vocab_size + multiple - 1) // multiple) * multiple


def embed_apply(table, tokens, mctx=LOCAL):
    """The table's rows at ``tokens``. ``F.embedding``, whose backward adds
    a token's rows in a fixed order on the CPU too (indexing's
    accumulating backward there adds repeated tokens in an order that
    varies from run to run). Over model ranks ``table`` is this rank's
    rows: each rank looks up the tokens among them, zeros elsewhere, and
    the ranks' results are summed (``out_of_model``), exact since one rank
    gives each token's row."""
    if mctx.model_size == 1:
        return F.embedding(tokens.long(), table)
    rows = table.shape[0]
    local = tokens.long() - mctx.model_rank * rows
    mine = (local >= 0) & (local < rows)
    x = F.embedding(torch.where(mine, local, 0), table)
    return mctx.out_of_model(torch.where(mine[..., None], x, 0.0))


def lm_head_apply(table, x, vocab_size: int):
    """Logits over the PADDED vocab, padding columns set to finfo.min, so
    softmax/BvSB see them and give them exactly zero mass."""
    logits = x @ table.T
    pv = table.shape[0]
    if pv != vocab_size:
        pad = torch.arange(pv, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, torch.finfo(logits.dtype).min)
    return logits


def cross_entropy(logits, labels, vocab_size: int):
    """Mean cross-entropy over the positions whose label is not IGNORE
    (JAX ``models.model.cross_entropy``); ``logits`` may be vocab-padded,
    the padding at finfo.min (``lm_head_apply``), so it takes no mass."""
    logits = logits.float()
    mask = labels != IGNORE
    safe = torch.where(mask, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1)
