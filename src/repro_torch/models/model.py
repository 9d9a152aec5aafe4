"""Model API: build the model on a device, initialise it from a
``torch.Generator``, or carry the JAX package's weights across.

    model = init_params(cfg, torch.Generator().manual_seed(0))   # on the card
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg, device="cpu")
    logits, _ = model(tokens)                                    # (B, S, V_pad)
    logits, _ = model(tokens, vision_embeds=v)   # VLM: (B, V + S, V_pad)
    logits, _ = model(tokens, audio_embeds=a)    # enc-dec: (B, S, V_pad)
    hidden, cache = model(tokens, collect_cache=True, return_hidden=True)
    logits, cache = model.decode_step(tokens1, cache, pos)
    loss, metrics = model.loss(tokens, labels)   # decoder-only: ce + aux

A decoder-only config builds a ``transformer.Model``, an
encoder-decoder config an ``encdec.EncDecModel``. ``mesh=`` (a
("data", "model") ``DeviceMesh`` from ``launch.mesh.make_model_mesh``)
builds the model of this rank: every parameter that the model ranks cut
(``models.layout``: heads, MLP features, RG-LRU channels, experts,
vocabulary rows) holds only the rank's part, whose values are the
one-card model's drawn from the same generator (or the JAX leaves),
sliced (``model_parts``). ``fsdp=True`` (training) also stores each
matrix's other dim cut over the data ranks (``models.layout.data_dim``,
``data_parts``); each layer gathers those leaves when it runs.

    model = init_params(cfg, gen, mesh=mesh)     # on every rank
    model = init_params(cfg, gen, mesh=mesh, fsdp=True)   # to train

Every entry point defaults to ``device="cuda"`` and raises when no card
is present: nothing moves quietly to the CPU.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.models import common, layout, recurrent, xlstm
from repro_torch.models.common import IGNORE, cross_entropy, mesh_context
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.transformer import Model

__all__ = ["EncDecModel", "IGNORE", "Model", "build_model", "cross_entropy",
           "data_parts", "init_params", "model_parts", "params_from_jax"]


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "present; pass device='cpu' to run the plain versions on the CPU")
    return dev


def build_model(cfg, *, device="cuda", dtype=torch.float32, mesh=None,
                fsdp=False):
    """The model for ``cfg`` on ``device``, parameters allocated but not
    yet filled (``init_params`` or ``params_from_jax`` fill them): an
    ``EncDecModel`` for an encoder-decoder config, else the decoder
    (``Model``) of ``attn``, ``lattn``, ``rglru``, ``mlstm`` and ``slstm``
    layers. The MoE router, the xLSTM gates' weights and biases and the
    sLSTM's recurrent weights are float32 whatever ``dtype`` is, as in
    the JAX package. ``mesh``: a (data, model) ``DeviceMesh``, None for
    one card; ``fsdp``: store each matrix's other dim over the mesh's data
    ranks (``param_shardings(fsdp=True)``, for training; serving keeps the
    default, the weights resident)."""
    cls = EncDecModel if cfg.is_encoder_decoder else Model
    return cls(cfg, device=resolve_device(device), dtype=dtype,
               mctx=mesh_context(mesh, fsdp))


def model_parts(model) -> Dict[str, Tuple[int, object]]:
    """Parameter name -> (dim, this rank's part of it) for every parameter
    the model ranks cut: the dims the modules recorded as they allocated
    their parts (``common.cut_param``, the rule ``layout.model_dim``),
    model rank j holding [j n, (j + 1) n) of it, a slice; the mLSTM's
    ``w_up`` its cell-input and output-gate columns
    (``layout.mlstm_up_columns``), an index array. Empty on one card."""
    if model.mctx.model_size == 1:
        return {}
    j, m, out = model.mctx.model_rank, model.mctx.model_size, {}
    for prefix, module in model.named_modules():
        for leaf, dim in getattr(module, "model_cuts", {}).items():
            n = getattr(module, leaf).shape[dim]
            name = f"{prefix}.{leaf}" if prefix else leaf
            out[name] = (dim, slice(j * n, (j + 1) * n))
            if isinstance(module, xlstm.MLSTM) and leaf == "w_up":
                out[name] = (dim, layout.mlstm_up_columns(
                    model.cfg.d_model, m, j))
    return out


def data_parts(model) -> Dict[str, Tuple[int, slice]]:
    """Parameter name -> (dim, this data rank's part of it) for every
    parameter stored FSDP (``build_model(..., fsdp=True)``): the dims the
    modules recorded (``common.cut_param``, the rule ``layout.data_dim``),
    data rank r holding [r n, (r + 1) n) of the dim. Empty without
    FSDP."""
    r, out = model.mctx.data_rank, {}
    for prefix, module in model.named_modules():
        for leaf, dim in getattr(module, "data_cuts", {}).items():
            n = getattr(module, leaf).shape[dim]
            name = f"{prefix}.{leaf}" if prefix else leaf
            out[name] = (dim, slice(r * n, (r + 1) * n))
    return out


def part_index(dim: int, rows, data=None) -> tuple:
    """The index of a part (``model_parts``: its dim and its rows, a slice
    or an index array) into its whole leaf, and of a data part
    (``data_parts``' (dim, rows)) where ``data`` gives one; the two cut
    different dims."""
    index = [slice(None)] * (dim + 1)
    index[dim] = rows
    if data is not None:
        index += [slice(None)] * (data[0] + 1 - len(index))
        index[data[0]] = data[1]
    return tuple(index)


def leaf_index(name: str, parts, dparts) -> tuple:
    """The index of parameter ``name``'s stored part into its whole leaf,
    from ``model_parts`` and ``data_parts`` (() where it is whole)."""
    if name in parts:
        return part_index(*parts[name], data=dparts.get(name))
    if name in dparts:
        return part_index(*dparts[name])
    return ()


def _whole_shape(p, name: str, parts, dparts, mctx) -> tuple:
    """The whole leaf's shape of parameter ``name`` (``p``, this rank's
    part of it)."""
    shape = list(p.shape)
    if name in parts:
        shape[parts[name][0]] *= mctx.model_size
    if name in dparts:
        shape[dparts[name][0]] *= mctx.data_size
    return tuple(shape)


def init_params(cfg, generator: torch.Generator, device="cuda",
                dtype=torch.float32, mesh=None, fsdp=False):
    """A model with weights drawn as the JAX package draws them: norm
    scales 1; the RG-LRU's ``lam`` 0.65 and its biases 0; the mLSTM's gate
    bias ``b_if`` 0 for the input gates and 3 for the forget gates, the
    sLSTM's ``b_in`` 0; every other weight truncated normal in [-2, 2]
    times ``cfg.init_scale``, drawn in float32 and cast to ``dtype`` (the
    float32 parameters stay float32).

    The draws run on the generator's device: a CUDA generator fills a
    model on the card in place (seconds for RecurrentGemma-9B's 8.6 B
    weights), a CPU generator draws on the host and copies. On a mesh
    every rank draws every weight in the same order, each cut one at its
    whole shape, and keeps its part (``model_parts``, and ``data_parts``
    where ``fsdp``): the one-card model's values."""
    model = build_model(cfg, device=device, dtype=dtype, mesh=mesh,
                        fsdp=fsdp)
    parts, dparts = model_parts(model), data_parts(model)
    for name, p in model.named_parameters():
        if name in parts or name in dparts:
            full = torch.empty(_whole_shape(p, name, parts, dparts,
                                            model.mctx),
                               dtype=torch.float32, device=generator.device)
            common.trunc_normal_(full, cfg.init_scale, generator)
            with torch.no_grad():
                p.copy_(full[leaf_index(name, parts, dparts)])
            del full
            continue
        leaf = name.rsplit(".", 1)[-1]
        with torch.no_grad():
            if leaf == "scale":
                p.fill_(1.0)
            elif leaf == "lam":
                p.fill_(recurrent.LAM_INIT)
            elif leaf == "b_if":
                xlstm.init_gate_bias_(p)
            elif leaf in recurrent.ZERO_INIT + xlstm.ZERO_INIT:
                p.zero_()
            else:
                common.trunc_normal_(p, cfg.init_scale, generator)
    return model


def _flatten(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (i,))
    elif tree is not None:
        yield path, np.asarray(tree)


def _stacking(cfg) -> Tuple[int, int]:
    """(layers per stacked super-block, number of super-blocks), as the
    JAX ``transformer.init_params`` stacks them."""
    plen = len(tuple(cfg.layer_pattern)) if cfg.layer_pattern else 1
    return plen, (cfg.num_layers - cfg.first_dense_layers) // plen


def _jax_location(name: str, cfg) -> Tuple[tuple, int, int]:
    """Module parameter name -> (JAX leaf path, layer index into a stacked
    leaf or -1, the stacked leaf's number of layers)."""
    parts = name.split(".")
    if parts[0] in ("enc_blocks", "dec_blocks"):
        n = cfg.encoder_layers if parts[0] == "enc_blocks" \
            else cfg.num_layers
        return (parts[0],) + tuple(parts[2:]), int(parts[1]), n
    if parts[0] != "layers":
        return tuple(parts), -1, 0
    i, rest = int(parts[1]), tuple(parts[2:])
    n_prefix = cfg.first_dense_layers
    plen, n_sb = _stacking(cfg)
    tail_start = n_prefix + n_sb * plen
    if i < n_prefix:
        return ("prefix", i) + rest, -1, 0
    if i >= tail_start:
        return ("tail", i - tail_start) + rest, -1, 0
    sb, k = divmod(i - n_prefix, plen)
    return ("blocks", k) + rest, sb, n_sb


def params_from_jax(tree, cfg, device="cuda", mesh=None, fsdp=False):
    """The port's model holding the JAX package's weights (on a mesh, this
    rank's part of each leaf the ranks cut, ``model_parts``, and where
    ``fsdp`` of each leaf the data ranks store cut, ``data_parts``).

    ``tree`` is the JAX parameter pytree as nested dicts, lists and tuples
    of numpy arrays (``jax.tree.map(np.asarray, params)``). The stacked
    layer axis of ``blocks`` (and of an encoder-decoder's ``enc_blocks``
    and ``dec_blocks``) is unstacked, the (d_in, d_out) layout kept.
    Every leaf's shape is checked against ``cfg``, and a leaf that no
    parameter consumed raises.
    """
    leaves: Dict[tuple, np.ndarray] = dict(_flatten(tree))
    model = build_model(cfg, device=device, dtype=torch.float32, mesh=mesh,
                        fsdp=fsdp)
    parts, dparts = model_parts(model), data_parts(model)
    consumed = set()
    for name, p in model.named_parameters():
        path, layer, n_stacked = _jax_location(name, cfg)
        if path not in leaves:
            raise KeyError(f"params_from_jax: no JAX leaf {path} for {name}")
        leaf = leaves[path]
        shape = _whole_shape(p, name, parts, dparts, model.mctx)
        want = shape if layer < 0 else (n_stacked,) + shape
        if leaf.shape != want:
            raise ValueError(f"params_from_jax: {path} has shape {leaf.shape},"
                             f" {cfg.name} needs {want}")
        value = leaf if layer < 0 else leaf[layer]
        value = value[leaf_index(name, parts, dparts)]
        with torch.no_grad():
            p.copy_(torch.from_numpy(np.array(value, np.float32)))
        consumed.add(path)
    extra = sorted(map(str, set(leaves) - consumed))
    if extra:
        raise ValueError(f"params_from_jax: leaves not consumed: {extra}")
    return model
