"""The port's layout over the mesh: which dim of each parameter a model
rank holds a part of, which dim the data ranks cut where the parameters
are stored FSDP, and which KV rings are cut on their slots.

``model_dim`` and ``data_dim`` are the rules. The modules allocate their
parameters through them (``common.cut_param``), ``model.model_parts`` and
``model.data_parts`` read what they recorded, and the tests hold them
against the JAX package's ``param_spec`` (``launch.shardings`` ports it).
``data_dim`` is its FSDP entry, leaf by leaf. ``model_dim`` is its model
part but for two departures:

  * an attention projection (``wq``, ``wk``, ``wv``, ``wo``) whose head
    count "model" does not divide stays whole. ``param_spec`` cuts wk /
    wv on output features wherever "model" divides KV hd: one KV head of
    256 over four ranks becomes four 64-feature pieces, a cut GSPMD
    reshards but a hand-written layout could use only by summing every
    score over the model group. A rank then computes the KV heads its
    query heads read whole; the values are JAX's, only these small
    leaves' storage differs;
  * an xLSTM block (``mlstm``, ``slstm``) whose head count "model" does
    not divide stays whole (xlstm-350m's four heads over 16 ranks), where
    ``param_spec`` would cut its projections into pieces of a head. Where
    "model" divides the heads the block is cut by heads, as ``param_spec``
    cuts it: every output feature is head-major, and so is the sLSTM's
    ``w_in`` (d, 4d), whose gate pre-activations the cell reshapes to (B,
    H, p, 4), so a contiguous quarter of its columns is one head's four
    gates. The mLSTM's ``w_up`` (d, 3d) is [cell input 2d | output gate
    d]: it is cut on its columns, the same count as ``param_spec``'s cut,
    but model rank j holds cell-input columns [j 2d/m, (j+1) 2d/m) and
    output-gate columns 2d + [j d/m, (j+1) d/m) (``mlstm_up_columns``), a
    permutation at load time; the values are JAX's.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

# the parameters of an attention projection, cut by heads
HEAD_LEAVES = ("wq", "wk", "wv", "wo")
# the xLSTM blocks, cut by heads where the model ranks divide them
XLSTM_BLOCKS = ("mlstm", "slstm")


def heads_split(cfg, model_size: int, kv: bool = False) -> bool:
    """Whether the model ranks cut an attention projection by heads: they
    divide its head count (the KV heads for ``kv``)."""
    n = cfg.num_kv_heads if kv else cfg.num_heads
    return model_size > 1 and n % model_size == 0


def xlstm_heads(cfg, block: str) -> int:
    """The head count of an xLSTM block: the mLSTM's ``num_heads``, the
    sLSTM's ``slstm_num_heads``."""
    return cfg.num_heads if block == "mlstm" else cfg.slstm_num_heads


def xlstm_split(cfg, block: str, model_size: int) -> bool:
    """Whether the model ranks cut an xLSTM block by heads: they divide
    its head count."""
    return model_size > 1 and xlstm_heads(cfg, block) % model_size == 0


def ring_split(w: int, model_size: int) -> bool:
    """Whether a KV ring of ``w`` slots is cut over the model ranks on its
    slots (``cache_shardings``' rule); else every rank holds it whole."""
    return model_size > 1 and w % model_size == 0


def mlstm_up_columns(d: int, model_size: int, rank: int) -> np.ndarray:
    """The columns of the mLSTM's whole ``w_up`` (d, 3d) that model rank
    ``rank`` holds, in its order: its cell-input columns, then its
    output-gate columns."""
    c, g = 2 * d // model_size, d // model_size
    return np.concatenate([np.arange(rank * c, (rank + 1) * c),
                           2 * d + np.arange(rank * g, (rank + 1) * g)])


def model_dim(names: Sequence[str], shape: Sequence[int], model_size: int,
              cfg=None) -> Optional[int]:
    """The dim of the parameter at ``names`` (its JAX leaf path, or the
    path's tail from its block on, e.g. ("attn", "wq")) of whole shape
    ``shape`` (a stacked layer dim included) that ``model_size`` ranks
    cut, None where every rank holds it whole. ``cfg`` gives an attention
    projection's and an xLSTM block's head counts."""
    names = [str(n) for n in names]
    if model_size == 1:
        return None
    block = next((b for b in XLSTM_BLOCKS if b in names), None)
    if block is not None and not xlstm_split(cfg, block, model_size):
        return None
    name, nd = names[-1], len(shape)
    if "table" in name:                       # embeddings / lm head (V, d)
        return nd - 2
    if name in HEAD_LEAVES and ("attn" in names or "xattn" in names):
        if not heads_split(cfg, model_size, kv=name in ("wk", "wv")):
            return None
        return nd - 2 if name == "wo" else nd - 1
    if "shared" in names:                     # shared experts: dense TP
        return {"w_gate": nd - 1, "w_up": nd - 1, "w_down": nd - 2}.get(name)
    if "moe" in names:                        # routed experts: their dim
        return nd - 3 if name in ("w_gate", "w_up", "w_down") else None
    if name in ("w_gate", "w_up", "w_rnn", "wq", "wk", "wv", "w_in",
                "w_ff1") and nd >= 2:
        return nd - 1 if shape[-1] % model_size == 0 else None
    if name in ("w_down", "w_out", "w_ff2") and nd >= 2:
        return nd - 2 if shape[-2] % model_size == 0 else None
    if name in ("w_a", "w_x") and nd >= 3:    # block-diagonal RG-LRU gates
        return nd - 3
    return None


def data_dim(names: Sequence[str], shape: Sequence[int],
             data_size: int) -> Optional[int]:
    """The dim of the parameter at ``names`` (as ``model_dim`` takes it) of
    whole shape ``shape`` that ``data_size`` data ranks cut where the
    parameters are stored FSDP: ``param_spec``'s FSDP entry, the dim of a
    matrix that "model" does not cut, where the data ranks divide it; None
    where every data rank holds it whole."""
    names = [str(n) for n in names]
    if data_size == 1:
        return None
    name, nd = names[-1], len(shape)

    def ok(dim):
        return dim if shape[dim] % data_size == 0 else None

    if "table" in name:                       # embeddings / lm head (V, d)
        return ok(1)
    if "shared" in names:
        if name in ("w_gate", "w_up") and nd >= 2:
            return ok(nd - 2)
        return ok(nd - 1) if name == "w_down" and nd >= 2 else None
    if name in ("w_gate", "w_up", "w_down") and nd >= 3 and "moe" in names:
        return ok(nd - 2)
    if name in ("wq", "wk", "wv", "w_gate", "w_up", "w_in", "w_ff1",
                "w_rnn") and nd >= 2:
        return ok(nd - 2)
    if name in ("wo", "w_down", "w_ff2", "w_out") and nd >= 2:
        return ok(nd - 1)
    return None
