"""Sharding rules over the ("data", "model") mesh: parameters, the batch,
the decode cache.

Counterpart of the JAX package's ``launch/shardings.py``, as pure
functions of names and shapes: a spec is a tuple with one entry a dim,
None (replicated), an axis name, or a tuple of axis names, as
``tuple(jax.sharding.PartitionSpec(...))`` reads.

  * ``param_spec``: the JAX package's rule for one parameter leaf, named by
    its JAX path (``models.model._jax_location`` maps a port parameter to
    it), with the FSDP axes over the data axes where training asks for
    them.
  * ``cache_spec``: ``cache_shardings``' rule for one cache leaf: a KV ring
    (B, W, KV, hd) cut on W over "model" where "model" divides W (decode
    context parallelism), the batch over the data axes.
  * ``batch_spec``: the batch dim over the data axes where they divide it.

The port stores and computes the "model" part of these specs (the models
take it through ``models.common.MeshContext``) by its own rule,
``models.layout.model_dim``: ``param_spec``'s model part but for the two
departures that module names (attention projections whose head count
"model" does not divide, and the xLSTM blocks, stay whole). FSDP
storage, the data part of a parameter's spec, is not ported yet.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

MODEL = "model"


def _axes(axes):
    """A spec entry for mesh axes: None for none, the name for one (as
    ``PartitionSpec`` normalises it), else the tuple."""
    axes = tuple(axes or ())
    return None if not axes else axes[0] if len(axes) == 1 else axes


def param_spec(names: Sequence[str], shape: Sequence[int], *,
               fsdp_axes: Tuple[str, ...] = (), fsdp_size: int = 1,
               model_size: int = 16) -> tuple:
    """The JAX package's ``param_spec`` for the leaf at path ``names`` (the
    JAX leaf path's keys, as strings) of shape ``shape``."""
    names = [str(n) for n in names]
    name = names[-1] if names else ""
    nd = len(shape)
    fa = _axes(fsdp_axes)

    def lead(tail: tuple) -> tuple:
        return (None,) * (nd - len(tail)) + tuple(tail)

    def fsdp_ok(dim_size: int):
        return fa if fsdp_size > 1 and dim_size % fsdp_size == 0 else None

    if "table" in name:                       # embeddings / lm head (V, d)
        return (MODEL, fsdp_ok(shape[1]))
    if "shared" in names:                     # shared experts: dense TP
        if name in ("w_gate", "w_up") and nd >= 2:
            return lead((fsdp_ok(shape[-2]), MODEL))
        if name == "w_down" and nd >= 2:
            return lead((MODEL, fsdp_ok(shape[-1])))
        return ()
    if name in ("w_gate", "w_up", "w_down") and nd >= 3 and "moe" in names:
        return lead((MODEL, fsdp_ok(shape[-2]), None))  # expert dim TP
    if name in ("wq", "wk", "wv", "w_gate", "w_up", "w_in", "w_ff1",
                "w_rnn") and nd >= 2:
        if shape[-1] % model_size == 0:
            return lead((fsdp_ok(shape[-2]), MODEL))
        return lead((fsdp_ok(shape[-2]), None))
    if name in ("wo", "w_down", "w_ff2", "w_out") and nd >= 2:
        if shape[-2] % model_size == 0:
            return lead((MODEL, fsdp_ok(shape[-1])))
        return lead((None, fsdp_ok(shape[-1])))
    if name in ("w_a", "w_x") and nd >= 3:    # block-diagonal RG-LRU gates
        return lead((MODEL, None, None))
    if name == "r" and nd >= 3:               # sLSTM per-head recurrent
        return lead((None, None, None))
    if name == "router":
        return lead((None, None))
    return ()                                  # norms, biases, scalars


def spec_model_dim(spec: tuple) -> Optional[int]:
    """The dim a spec cuts over "model", or None."""
    for i, entry in enumerate(spec):
        if entry == MODEL or (isinstance(entry, tuple) and MODEL in entry):
            return i
    return None


def cache_spec(names: Sequence[str], shape: Sequence[int], global_batch: int,
               *, batch_axes: Tuple[str, ...] = ("data",),
               data_size: int = 1, model_size: int = 16) -> tuple:
    """``cache_shardings``' spec for the cache leaf at ``names`` (its
    pytree path's keys) of shape ``shape``, over data axes ``batch_axes``
    of ``data_size`` ranks and ``model_size`` model ranks."""
    names = [str(n) for n in names]
    nd = len(shape)
    ba = _axes(batch_axes) if (global_batch % data_size == 0
                               and global_batch >= data_size) else None
    spec = [None] * nd
    last = names[-1] if names else ""
    if last in ("k", "v") and nd >= 4:           # KV rings (L?, B, W, KV, hd)
        spec[nd - 4] = ba
        spec[nd - 3] = MODEL if shape[nd - 3] % model_size == 0 else None
        return tuple(spec)
    if "cross" in names and nd >= 4:             # cross K/V (B, F, KV, hd)
        spec[nd - 4] = ba
        return tuple(spec)
    if last == "C" and nd >= 4:                  # mLSTM memory (L?, B, H, p, p)
        spec[nd - 4] = ba
        spec[nd - 2] = MODEL if shape[nd - 2] % model_size == 0 else None
        return tuple(spec)
    if nd >= 2:
        for i, d in enumerate(shape):
            if d == global_batch:
                spec[i] = ba
                break
    if last in ("h", "conv_tail") and nd >= 2 and shape[-1] % model_size == 0:
        spec[-1] = MODEL
    return tuple(spec)


def batch_spec(global_batch: int, *, batch_axes: Tuple[str, ...] = ("data",),
               data_size: int = 1) -> tuple:
    """``batch_spec``: the batch dim over the data axes where they divide
    it (and it is at least their size), else replicated (an empty spec)."""
    if global_batch % data_size == 0 and global_batch >= data_size:
        return (_axes(batch_axes),)
    return ()
