"""The port's layout over the model ranks: which dim of each parameter a
model rank holds a part of, and which KV rings are cut on their slots.

``model_dim`` is the one rule. The modules allocate their parameters
through it (``common.cut_param``), ``model.model_parts`` reads what they
recorded, and the tests hold it against the JAX package's ``param_spec``
(``launch.shardings`` ports it), whose model part it is but for two
departures:

  * an attention projection (``wq``, ``wk``, ``wv``, ``wo``) whose head
    count "model" does not divide stays whole. ``param_spec`` cuts wk /
    wv on output features wherever "model" divides KV hd: one KV head of
    256 over four ranks becomes four 64-feature pieces, a cut GSPMD
    reshards but a hand-written layout could use only by summing every
    score over the model group. A rank then computes the KV heads its
    query heads read whole; the values are JAX's, only these small
    leaves' storage differs;
  * the xLSTM blocks (``mlstm``, ``slstm``) stay whole: their ``w_up``
    (d, 3d) and ``w_in`` (d, 4d) pack several gates along the features
    ``param_spec`` cuts, so a column cut would hand a rank a mix of gates
    it cannot use without a gather.
"""
from __future__ import annotations

from typing import Optional, Sequence

# the parameters of an attention projection, cut by heads
HEAD_LEAVES = ("wq", "wk", "wv", "wo")
# the blocks the port keeps whole on every model rank
REPLICATED_BLOCKS = ("mlstm", "slstm")


def heads_split(cfg, model_size: int, kv: bool = False) -> bool:
    """Whether the model ranks cut an attention projection by heads: they
    divide its head count (the KV heads for ``kv``)."""
    n = cfg.num_kv_heads if kv else cfg.num_heads
    return model_size > 1 and n % model_size == 0


def ring_split(w: int, model_size: int) -> bool:
    """Whether a KV ring of ``w`` slots is cut over the model ranks on its
    slots (``cache_shardings``' rule); else every rank holds it whole."""
    return model_size > 1 and w % model_size == 0


def model_dim(names: Sequence[str], shape: Sequence[int], model_size: int,
              cfg=None) -> Optional[int]:
    """The dim of the parameter at ``names`` (its JAX leaf path, or the
    path's tail from its block on, e.g. ("attn", "wq")) of whole shape
    ``shape`` (a stacked layer dim included) that ``model_size`` ranks
    cut, None where every rank holds it whole. ``cfg`` gives an attention
    projection's head counts."""
    names = [str(n) for n in names]
    if model_size == 1 or any(b in names for b in REPLICATED_BLOCKS):
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
    if name in ("w_gate", "w_up", "w_rnn") and nd >= 2:
        return nd - 1 if shape[-1] % model_size == 0 else None
    if name in ("w_down", "w_out") and nd >= 2:
        return nd - 2 if shape[-2] % model_size == 0 else None
    if name in ("w_a", "w_x") and nd >= 3:    # block-diagonal RG-LRU gates
        return nd - 3
    return None
