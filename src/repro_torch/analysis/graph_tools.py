"""A recorder of the aten ops an eager PyTorch entry dispatches: the
counterpart of the JAX package's ``jaxpr_tools`` for the trace-discipline
and lane-masking rules.

JAX checks a jaxpr, a program it traced without running. The port runs
eagerly, so its program is the stream of aten ops that one call of an
entry dispatches. ``Recorder`` is a ``TorchDispatchMode`` that runs the
entry (on the CPU, or on the card where a guard needs it) and keeps, for
every op:

* its name, its inputs' and outputs' dtypes and its Python scalar
  arguments (``OpRecord``);
* the innermost source frame that dispatched it (``Site``: repo-relative
  file, line, qualified function name), so an allowlist entry can name
  the function a finding sits in, and the qualified names of every
  source frame on the stack at that moment (``stack``), so a rule can ask
  whether an op ran inside a given function (the engine's ``_boundary``);
* a dataflow graph keyed by base storage
  (``untyped_storage().data_ptr()``): a node is one version of a storage's
  contents. An op reads the current version of each input's base, a fresh
  output is a new node, and an in-place op or a ``copy_`` into a view is
  a new version of its base that depends on every input and on the base's
  previous version. A view is no node: it reads and writes its base.

Dependence is conservative, as in ``jaxpr_tools``: every output of an op
depends on every input (but for the ops in ``VALUE_FREE``, whose outputs
take only their inputs' shapes), and a write into part of a buffer keeps
its previous version. So "this buffer depends on the active mask" can only
pass falsely if the code wired the mask in somewhere, and "the boundary
reaches only these buffers" can only fail falsely, never miss. The
recorder keeps every tensor it saw alive until it is dropped, so no
storage address is reused inside one recording.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from typing import Callable, Dict, FrozenSet, Iterable, List, Optional, \
    Set, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
# the repository root (``src/repro_torch/analysis`` -> three levels up)
ROOT = os.path.dirname(os.path.dirname(_PKG))

BAD_DTYPES = ("torch.float64", "torch.complex128")

# ops whose outputs carry none of their inputs' values, only their shapes
VALUE_FREE = {"zeros_like", "ones_like", "empty_like", "full_like",
              "new_zeros", "new_ones", "new_empty", "new_full",
              "empty_strided", "rand_like", "randn_like", "randint_like"}

# ops that only move values (a copy, a cast to the same values, a view
# materialized): a buffer whose every version since the entry's input was
# made by these is untouched
COPY_OPS = {"copy_", "clone", "_to_copy", "to", "contiguous", "lift_fresh",
            "lift_fresh_copy", "detach", "detach_", "alias"}

# in-place ops whose written argument's previous values do not matter
# where they cover the whole buffer (their read of it is no read)
OVERWRITE_OPS = {"copy_", "fill_", "zero_"}


@dataclasses.dataclass(frozen=True)
class Site:
    """A source position: repo-relative path ("" when the op had no source
    frame), line, and the qualified name of the function (``Class.method``,
    ``outer.inner``; ``<module>`` at module level)."""
    path: str
    line: int
    symbol: str

    def render(self) -> str:
        return f"{self.path}:{self.line} ({self.symbol})" if self.path \
            else "<no source frame>"


NO_SITE = Site("", 0, "<entry>")


@dataclasses.dataclass
class OpRecord:
    op: str                            # "aten.add.Tensor"
    name: str                          # "add" (the schema's base name)
    in_dtypes: Tuple[str, ...]
    out_dtypes: Tuple[str, ...]
    scalars: Tuple                     # bool / int / float arguments
    site: Site
    stack: FrozenSet[str]              # qualnames of the source frames
    made: Tuple[int, ...]              # node ids this op created

    @property
    def signature(self) -> Tuple:
        return (self.op, self.in_dtypes, self.out_dtypes)


def _qualname(code) -> str:
    q = getattr(code, "co_qualname", code.co_name)
    return q.replace(".<locals>", "")


def _is_source(filename: str) -> bool:
    fn = os.path.abspath(filename)
    return fn.startswith(ROOT + os.sep) and not fn.startswith(_HERE + os.sep)


def source_frames(frame=None) -> List:
    """The source frames on the stack, innermost first: frames of files
    under the repository root outside this package (the port, a corpus
    file, a test), never torch's or the standard library's."""
    f = frame or sys._getframe(1)
    out = []
    while f is not None:
        if _is_source(f.f_code.co_filename):
            out.append(f)
        f = f.f_back
    return out


def site_of(frame) -> Site:
    path = os.path.relpath(os.path.abspath(frame.f_code.co_filename), ROOT)
    return Site(path.replace(os.sep, "/"), frame.f_lineno,
                _qualname(frame.f_code))


def _storage_key(t: torch.Tensor):
    try:
        s = t.untyped_storage()
    except (NotImplementedError, RuntimeError):
        return None
    if s.nbytes() == 0:
        return None
    return (t.device.type, t.device.index, s.data_ptr())


def _tensors(tree) -> List[torch.Tensor]:
    flat, _ = tree_flatten(tree)
    return [x for x in flat if isinstance(x, torch.Tensor)]


class Recorder(TorchDispatchMode):
    """Records every aten op dispatched while it is active; see the module
    docstring. ``name(label, tensor)`` labels a tensor's base as a root
    before the run; ``node_of(tensor)`` is the current version of its
    base afterwards."""

    def __init__(self):
        super().__init__()
        self.ops: List[OpRecord] = []
        self.deps: List[FrozenSet[int]] = []   # node -> the nodes it read
        self.node_op: List[int] = []           # node -> op index, -1: root
        self.root_label: Dict[int, str] = {}
        self.read_keys: Set[Tuple] = set()     # bases some op read
        self._version: Dict[Tuple, int] = {}
        self._keep: List[torch.Tensor] = []

    # -- nodes -------------------------------------------------------------
    def _new_node(self, key, deps: Iterable[int], op: int) -> int:
        nid = len(self.deps)
        self.deps.append(frozenset(deps))
        self.node_op.append(op)
        if key is not None:
            self._version[key] = nid
        return nid

    def node_of(self, t: torch.Tensor) -> Optional[int]:
        """The current version of ``t``'s base; a new root the first time
        a base is seen. None for a tensor without storage bytes."""
        key = _storage_key(t)
        if key is None:
            return None
        nid = self._version.get(key)
        if nid is None:
            nid = self._new_node(key, (), -1)
            self._keep.append(t)
        return nid

    def name(self, label: str, t: torch.Tensor) -> None:
        nid = self.node_of(t)
        if nid is not None:
            self.root_label.setdefault(nid, label)

    # -- the dispatch hook ---------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        schema = func._schema
        base = schema.name.split("::")[-1]
        written: List[torch.Tensor] = []
        for i, arg in enumerate(schema.arguments):
            if arg.alias_info is None or not arg.alias_info.is_write:
                continue
            val = args[i] if i < len(args) else kwargs.get(arg.name)
            written += _tensors(val)
        written_keys = {_storage_key(t) for t in written}
        ins = _tensors((args, kwargs))
        reads, in_keys = [], set()
        for t in ins:
            k = _storage_key(t)
            if k is None:
                continue
            in_keys.add(k)
            reads.append(self.node_of(t))
            if not (base in OVERWRITE_OPS and any(t is w for w in written)):
                self.read_keys.add(k)
        frames = source_frames(sys._getframe(1))
        site = site_of(frames[0]) if frames else NO_SITE
        idx = len(self.ops)
        deps = () if base in VALUE_FREE else tuple(sorted(set(reads)))
        made = []
        for k in sorted((k for k in written_keys if k is not None),
                        key=str):
            made.append(self._new_node(k, deps, idx))
        outs = _tensors(out)
        for t in outs:
            k = _storage_key(t)
            if k is None or k in in_keys:
                continue           # a view of, or the written, input
            made.append(self._new_node(k, deps, idx))
            self._keep.append(t)
        self._keep.extend(ins)
        flat, _ = tree_flatten((args, kwargs))
        scalars = tuple(x for x in flat if isinstance(x, (bool, int, float))
                        and not isinstance(x, torch.Tensor))
        self.ops.append(OpRecord(
            op=str(func), name=base,
            in_dtypes=tuple(str(t.dtype) for t in ins),
            out_dtypes=tuple(str(t.dtype) for t in outs),
            scalars=scalars, site=site,
            stack=frozenset(_qualname(f.f_code) for f in frames),
            made=tuple(made)))
        return out

    # -- queries -------------------------------------------------------------
    def backward_slice(self, nid: int) -> Set[int]:
        seen, todo = set(), [nid]
        while todo:
            n = todo.pop()
            if n in seen:
                continue
            seen.add(n)
            todo.extend(self.deps[n])
        return seen

    def forward_taint(self, roots: Iterable[int]) -> Set[int]:
        """Every node computed from ``roots`` (node ids are in creation
        order, so one forward pass suffices)."""
        tainted = set(roots)
        if not tainted:
            return tainted
        for n in range(min(tainted), len(self.deps)):
            if n not in tainted and self.deps[n] & tainted:
                tainted.add(n)
        return tainted

    def op_of(self, nid: int) -> Optional[OpRecord]:
        i = self.node_op[nid]
        return None if i < 0 else self.ops[i]


def record(fn: Callable, *args, **kwargs) -> Tuple[Recorder, object]:
    """Run ``fn(*args, **kwargs)`` under a fresh ``Recorder``; returns the
    recorder and the result."""
    rec = Recorder()
    with rec:
        out = fn(*args, **kwargs)
    return rec, out


def float64_ops(rec: Recorder) -> List[OpRecord]:
    """The recorded ops with a float64 / complex128 input or output."""
    return [o for o in rec.ops
            if any(d in BAD_DTYPES for d in o.in_dtypes + o.out_dtypes)]


def leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """``(path, tensor)`` for every tensor of a nested dict, keys sorted
    (the carry's layout: ``"['traces']['sr']"``)."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += leaves(tree[k], f"{prefix}['{k}']")
    return out


def top_level_key(path: str) -> str:
    """``"['traces']['sr']"`` -> ``"traces"``."""
    return path.split("]")[0].lstrip("[").strip("'\"")
