"""Host-dispatch rules (HD*): AST lint over the port's host code, the
JAX package's ``analysis/host_rules.py`` recast for eager PyTorch.

In JAX the host's costs are throwaway executables and eager op soup; on a
card driven eagerly they are host-device copies and synchronizations, and
CUDA graphs captured more often than their structure changes:

* HD001: a device tensor built from host data inside a host loop
  (``torch.tensor`` / ``torch.as_tensor`` with a ``device=``,
  ``torch.from_numpy(...).to(dev)``, ``.cuda()`` in a ``for`` / ``while``
  body or a comprehension): one host-to-device copy an iteration.
* HD002: a synchronization of the host with the card in host code: a
  device-to-host read (``.item()``, ``.tolist()``, ``.nonzero()`` of a
  tensor, ``.cpu()``, ``.numpy()``, ``torch.nonzero``, or ``int()`` /
  ``float()`` / ``bool()`` of a tensor-valued expression), an explicit
  ``synchronize()``, entering ``torch.cuda.graph(...)`` (which
  synchronizes the card), or a blocking host-to-device copy (the forms of
  HD001 without ``non_blocking=True``) — every operation that
  ``torch.cuda.set_sync_debug_mode`` reports, so the runtime census
  (``runtime.SyncCensus``) can hold each sync it sees to a site named
  here.
* HD003: a ``torch.cuda.CUDAGraph()`` / ``torch.cuda.graph(...)`` /
  ``torch.compile(...)`` made inside a function that no
  ``functools.lru_cache`` / ``cache`` memoizes: a capture per call instead
  of one per structure. Anything else needs an allowlist entry naming its
  cache.
* HD004: a host call into the simulator engine's per-trip methods
  (``PER_TRIP``) outside the engine's own loop (``ENGINE_LOOP``: ``run``,
  ``_warm_up_and_capture``, ``_trips`` and ``trip`` themselves, and the
  debug hook ``lane_stepper``): the eager op soup the captured graph
  exists to avoid.

The body of ``with torch.cuda.graph(...)`` is exempt from all four, as a
traced context is in the JAX package: it runs once, at capture. The port
runs eagerly (no ``torch.compile``, ``vmap`` or ``jit``), so no other
context is exempt and every module of the port is host code.

HD002 decides which expressions hold tensors by a local dataflow, as the
JAX package's HD002 does for device arrays: names and ``self``
attributes bound to ``torch.*`` calls, to tensor methods of tensors, to
subscripts and arithmetic of tensors, to calls of the module's functions
and methods that return tensors, to calls of a callable held in a local or
an attribute (a forward, a metric) with a tensor argument, and containers
(dicts, lists) of tensors. It is flow-insensitive within a function and
sees nothing across modules: an imported function's result is not a
tensor to it.
"""
from __future__ import annotations

import ast
import builtins
from typing import Dict, List, Optional, Set

from repro_torch.analysis.findings import Finding, Severity

FAMILY = "host-dispatch"

# decorator basenames that exempt an enclosing def from HD003
CACHED_FACTORY_DECORATORS = {"lru_cache", "cache"}

ENGINE_FILE = "src/repro_torch/sim/jaxsim.py"
PER_TRIP = {"trip", "_trips", "_event", "_event_seg", "_boundary"}
ENGINE_LOOP = {"run", "_warm_up_and_capture", "_trips", "trip",
               "lane_stepper"}

# torch namespaces whose calls do not return tensors
NON_TENSOR_NS = {"cuda", "distributed", "backends", "utils", "jit",
                 "profiler", "multiprocessing", "testing", "library", "fx",
                 "_dynamo", "compiler", "hub", "onnx", "package",
                 "overrides"}
NON_TENSOR_TORCH = {
    "device", "dtype", "get_default_dtype", "set_default_dtype",
    "is_tensor", "is_floating_point", "is_complex", "is_grad_enabled",
    "is_inference_mode_enabled", "no_grad", "enable_grad",
    "inference_mode", "set_grad_enabled", "manual_seed", "seed",
    "initial_seed", "finfo", "iinfo", "compile", "promote_types",
    "result_type", "can_cast", "get_num_threads", "set_num_threads",
    "numel", "typename", "is_storage", "use_deterministic_algorithms",
    "set_printoptions", "broadcast_shapes", "save", "load",
    "set_float32_matmul_precision", "get_float32_matmul_precision"}
# tensor methods whose result is not a (device) tensor
NON_TENSOR_METHODS = {
    "item", "tolist", "numpy", "cpu", "dim", "ndimension", "size",
    "numel", "nelement", "element_size", "data_ptr", "stride",
    "storage_offset", "is_contiguous", "untyped_storage", "storage",
    "get_device", "is_floating_point", "is_complex", "backward",
    "register_hook", "is_pinned", "nbytes", "itemsize", "type",
    "__len__", "keys", "items", "values"}
TENSOR_ATTRS = {"T", "mT", "H", "mH", "real", "imag", "data", "grad"}
# device-to-host reads, by receiver
SYNC_METHODS_ANY = {"cpu", "numpy", "synchronize"}
SYNC_METHODS_TENSOR = {"item", "tolist", "nonzero"}
SYNC_TORCH = {"nonzero", "argwhere", "synchronize"}
# host-data tensor makers (a ``.to(...)`` of their result is a copy in)
HOST_MAKERS = {"tensor", "as_tensor", "from_numpy", "asarray"}
CAPTURES = {"CUDAGraph", "graph", "compile"}


def _basename(func: ast.expr) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _kw(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _is_true(node: Optional[ast.expr]) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


class _Env:
    """Names known to hold tensors, containers of tensors, and tensor
    factories (``functools.partial(torch.zeros, ...)``) in one scope."""

    def __init__(self, parent: Optional["_Env"] = None):
        self.tensors: Set[str] = set(parent.tensors) if parent else set()
        self.containers: Set[str] = \
            set(parent.containers) if parent else set()
        self.factories: Set[str] = set(parent.factories) if parent else set()


class _Module:
    """What the dataflow knows of one module across its functions."""

    def __init__(self, tree: ast.Module):
        self.roots: Dict[str, str] = {}   # alias -> torch module path
        self.bare: Dict[str, str] = {}    # name -> "torch.x.y"
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "torch" or a.name.startswith("torch."):
                        if a.asname:
                            self.roots[a.asname] = a.name
                        else:
                            self.roots[a.name.split(".")[0]] = "torch"
            elif isinstance(node, ast.ImportFrom) and node.module and (
                    node.module == "torch"
                    or node.module.startswith("torch.")):
                for a in node.names:
                    self.bare[a.asname or a.name] = \
                        f"{node.module}.{a.name}"
        self.class_tensors: Dict[str, Set[str]] = {}
        self.class_containers: Dict[str, Set[str]] = {}
        self.returns: Dict[str, str] = {}   # qualname -> tensor|container
        # names the module binds itself (imports, defs, classes, globals)
        # and each class's methods: a call of anything else is a call of a
        # callable held in a local or an attribute
        self.known: Set[str] = set(dir(builtins))
        self.methods: Dict[str, Set[str]] = {}
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                self.known.update((a.asname or a.name).split(".")[0]
                                  for a in node.names)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
                self.known.add(node.name)
            if isinstance(node, ast.ClassDef):
                self.methods[node.name] = {
                    d.name for d in node.body
                    if isinstance(d, (ast.FunctionDef, ast.AsyncFunctionDef))}
        for node in tree.body:
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    self.known.update(n.id for n in ast.walk(t)
                                      if isinstance(n, ast.Name))

    def chain(self, func: ast.expr) -> Optional[List[str]]:
        """The dotted torch path of a callee, or None."""
        parts: List[str] = []
        node = func
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        if node.id in self.roots:
            head = self.roots[node.id].split(".")
        elif node.id in self.bare:
            head = self.bare[node.id].split(".")
        else:
            return None
        return head + parts[::-1]


class _Scanner:
    def __init__(self, rel_path: str, tree: ast.Module, mod: _Module,
                 emit: bool):
        self.rel = rel_path
        self.mod = mod
        self.emit = emit
        self.findings: List[Finding] = []
        self.seen: Set[tuple] = set()
        self.defs: List[tuple] = []      # (name, cached, is_class)
        self.captured = 0
        self.loops = 0

    # -- scope helpers -------------------------------------------------------
    def _symbol(self) -> str:
        return ".".join(n for n, _, _ in self.defs) or "<module>"

    def _class(self) -> Optional[str]:
        for name, _, is_class in reversed(self.defs):
            if is_class:
                return name
        return None

    def _method_of_class(self) -> Optional[str]:
        """The class whose method body we are directly in, or None."""
        if len(self.defs) >= 2 and self.defs[-2][2] and not self.defs[-1][2]:
            return self.defs[-2][0]
        return None

    def _emit(self, rule: str, node: ast.AST, message: str):
        key = (rule, getattr(node, "lineno", 0))
        if not self.emit or key in self.seen:
            return
        self.seen.add(key)
        self.findings.append(Finding(
            rule, FAMILY, Severity.WARN, self.rel,
            getattr(node, "lineno", 0), self._symbol(), message))

    # -- the dataflow --------------------------------------------------------
    def is_tensor(self, e: ast.expr, env: _Env) -> bool:
        if isinstance(e, ast.Name):
            return e.id in env.tensors
        if isinstance(e, ast.Attribute):
            if isinstance(e.value, ast.Name) and e.value.id == "self":
                return e.attr in self.mod.class_tensors.get(
                    self._class() or "", set())
            return e.attr in TENSOR_ATTRS and self.is_tensor(e.value, env)
        if isinstance(e, ast.Subscript):
            return self.is_tensor(e.value, env) \
                or self.is_container(e.value, env)
        if isinstance(e, ast.BinOp):
            return self.is_tensor(e.left, env) \
                or self.is_tensor(e.right, env)
        if isinstance(e, ast.UnaryOp):
            return self.is_tensor(e.operand, env)
        if isinstance(e, ast.Compare):
            return any(self.is_tensor(x, env)
                       for x in [e.left] + list(e.comparators))
        if isinstance(e, ast.IfExp):
            return self.is_tensor(e.body, env) \
                or self.is_tensor(e.orelse, env)
        if isinstance(e, ast.Call):
            return self._call_kind(e, env) == "tensor"
        return False

    def is_container(self, e: ast.expr, env: _Env) -> bool:
        if isinstance(e, ast.Name):
            return e.id in env.containers
        if isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name) \
                and e.value.id == "self":
            return e.attr in self.mod.class_containers.get(
                self._class() or "", set())
        if isinstance(e, ast.Dict):
            return any(v is not None and self.is_tensor(v, env)
                       for v in e.values)
        if isinstance(e, (ast.List, ast.Tuple)):
            return any(self.is_tensor(v, env) for v in e.elts)
        if isinstance(e, (ast.DictComp,)):
            return self._comp_tensor(e, env, e.value)
        if isinstance(e, (ast.ListComp,)):
            return self._comp_tensor(e, env, e.elt)
        if isinstance(e, ast.Call):
            return self._call_kind(e, env) == "container"
        return False

    def _comp_tensor(self, comp, env, elt) -> bool:
        sub = _Env(env)
        for gen in comp.generators:
            self._bind_iter(gen.target, gen.iter, sub)
        return self.is_tensor(elt, sub)

    def _call_kind(self, e: ast.Call, env: _Env) -> Optional[str]:
        f = e.func
        ch = self.mod.chain(f)
        if ch is not None:
            if ch[0] != "torch":
                return None
            last = ch[-1]
            if any(p in NON_TENSOR_NS for p in ch[1:-1]) \
                    or last in NON_TENSOR_TORCH or not last[:1].islower() \
                    or last in NON_TENSOR_NS:
                return None
            return "tensor"
        if isinstance(f, ast.Name):
            if f.id in env.factories:
                return "tensor"
            if f.id in self.mod.returns or f.id in self.mod.known:
                return self.mod.returns.get(f.id)
            return "tensor" if self._tensor_arg(e, env) else None
        if isinstance(f, ast.Attribute):
            recv = f.value
            if isinstance(recv, ast.Name) and recv.id == "self":
                cls = self._class()
                key = f"{cls}.{f.attr}"
                if key in self.mod.returns \
                        or f.attr in self.mod.methods.get(cls or "", ()):
                    return self.mod.returns.get(key)
                return "tensor" if self._tensor_arg(e, env) else None
            if self.is_tensor(recv, env):
                return None if f.attr in NON_TENSOR_METHODS else "tensor"
            if self.is_container(recv, env) and f.attr in ("get", "pop"):
                return "tensor"
        return None

    def _tensor_arg(self, e: ast.Call, env: _Env) -> bool:
        """A callable held in a local or an attribute (a forward, a
        metric) is taken to map tensors to tensors."""
        return any(self.is_tensor(a, env) for a in
                   list(e.args) + [k.value for k in e.keywords])

    def _bind(self, target: ast.expr, value: Optional[ast.expr],
              env: _Env, tensor: Optional[bool] = None):
        if value is None and tensor is None:
            return
        is_t = tensor if tensor is not None else self.is_tensor(value, env)
        is_c = False if tensor is not None or value is None \
            else self.is_container(value, env)
        if isinstance(target, ast.Name):
            if is_t:
                env.tensors.add(target.id)
            elif is_c:
                env.containers.add(target.id)
            elif isinstance(value, ast.Call) \
                    and _basename(value.func) == "partial" and value.args \
                    and self.mod.chain(value.args[0]) is not None:
                env.factories.add(target.id)
        elif isinstance(target, ast.Attribute) \
                and isinstance(target.value, ast.Name) \
                and target.value.id == "self":
            cls = self._class()
            if cls is not None and is_t:
                self.mod.class_tensors.setdefault(cls, set()).add(
                    target.attr)
            elif cls is not None and is_c:
                self.mod.class_containers.setdefault(cls, set()).add(
                    target.attr)
        elif isinstance(target, (ast.Tuple, ast.List)):
            if isinstance(value, (ast.Tuple, ast.List)) \
                    and len(value.elts) == len(target.elts):
                for t, v in zip(target.elts, value.elts):
                    self._bind(t, v, env)
            elif value is not None and (
                    self.is_tensor(value, env)
                    or (isinstance(value, ast.Call)
                        and self._call_kind(value, env) == "tuple")):
                for t in target.elts:
                    self._bind(t, None, env, tensor=True)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, value, env, tensor)

    def _bind_iter(self, target, it, env: _Env):
        if self.is_tensor(it, env):
            self._bind(target, None, env, tensor=True)
        elif isinstance(it, ast.Call) and isinstance(it.func, ast.Attribute) \
                and self.is_container(it.func.value, env):
            if it.func.attr == "values":
                self._bind(target, None, env, tensor=True)
            elif it.func.attr == "items" and isinstance(target, ast.Tuple) \
                    and len(target.elts) == 2:
                self._bind(target.elts[1], None, env, tensor=True)
        elif isinstance(it, (ast.List, ast.Tuple)) \
                and any(self.is_tensor(v, env) for v in it.elts):
            self._bind(target, None, env, tensor=True)

    # -- statements ------------------------------------------------------------
    def block(self, stmts, env: _Env):
        for s in stmts:
            self.stmt(s, env)

    def stmt(self, s: ast.stmt, env: _Env):
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._def(s, env)
        elif isinstance(s, ast.ClassDef):
            for d in s.decorator_list:
                self.expr(d, env)
            self.defs.append((s.name, False, True))
            self.block(s.body, _Env(env))
            self.defs.pop()
        elif isinstance(s, ast.Assign):
            self.expr(s.value, env)
            for t in s.targets:
                self._bind(t, s.value, env)
                self.expr(t, env)
        elif isinstance(s, ast.AnnAssign):
            if s.value is not None:
                self.expr(s.value, env)
                self._bind(s.target, s.value, env)
        elif isinstance(s, ast.AugAssign):
            self.expr(s.value, env)
            if self.is_tensor(s.value, env):
                self._bind(s.target, None, env, tensor=True)
        elif isinstance(s, (ast.For, ast.AsyncFor)):
            self.expr(s.iter, env)
            self._bind_iter(s.target, s.iter, env)
            self.loops += 1
            self.block(s.body, env)
            self.loops -= 1
            self.block(s.orelse, env)
        elif isinstance(s, ast.While):
            self.loops += 1
            self.expr(s.test, env)
            self.block(s.body, env)
            self.loops -= 1
            self.block(s.orelse, env)
        elif isinstance(s, (ast.With, ast.AsyncWith)):
            capture = False
            for item in s.items:
                self.expr(item.context_expr, env)
                ce = item.context_expr
                if isinstance(ce, ast.Call) and \
                        (self.mod.chain(ce.func) or [])[-2:] == \
                        ["cuda", "graph"]:
                    capture = True
                if item.optional_vars is not None:
                    self._bind(item.optional_vars, item.context_expr, env)
            self.captured += capture
            self.block(s.body, env)
            self.captured -= capture
        elif isinstance(s, ast.Return):
            if s.value is not None:
                self.expr(s.value, env)
                self._note_return(s.value, env)
        else:
            for child in ast.iter_child_nodes(s):
                if isinstance(child, ast.stmt):
                    self.stmt(child, env)
                elif isinstance(child, ast.expr):
                    self.expr(child, env)
                elif isinstance(child, ast.excepthandler):
                    self.block(child.body, env)

    def _note_return(self, value, env):
        if not self.defs or self.defs[-1][2]:
            return
        kind = None
        if self.is_tensor(value, env):
            kind = "tensor"
        elif isinstance(value, ast.Tuple) \
                and any(self.is_tensor(v, env) for v in value.elts):
            kind = "tuple"
        elif self.is_container(value, env):
            kind = "container"
        if kind is None:
            return
        cls = self._method_of_class()
        name = self.defs[-1][0]
        key = f"{cls}.{name}" if cls else name
        if len(self.defs) == 1 or cls:
            self.mod.returns.setdefault(key, kind)

    def _def(self, node, env: _Env):
        decs = set()
        for d in node.decorator_list:
            self.expr(d, env)
            for sub in ast.walk(d):
                b = _basename(sub) if isinstance(
                    sub, (ast.Name, ast.Attribute)) else None
                if b:
                    decs.add(b)
        self.defs.append((node.name, bool(decs & CACHED_FACTORY_DECORATORS),
                          False))
        sub = _Env(env)
        for a in node.args.args + node.args.kwonlyargs:
            ann = a.annotation
            if ann is not None and _basename(ann) == "Tensor":
                sub.tensors.add(a.arg)
        loops, self.loops = self.loops, 0
        self.block(node.body, sub)
        self.loops = loops
        self.defs.pop()

    # -- expressions -----------------------------------------------------------
    def expr(self, e: ast.expr, env: _Env):
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                          ast.DictComp)):
            sub = _Env(env)
            first = True
            for gen in e.generators:
                if not first:
                    self.loops += 1
                self.expr(gen.iter, sub)
                if not first:
                    self.loops -= 1
                first = False
                self._bind_iter(gen.target, gen.iter, sub)
            self.loops += 1
            for gen in e.generators:
                for cond in gen.ifs:
                    self.expr(cond, sub)
            if isinstance(e, ast.DictComp):
                self.expr(e.key, sub)
                self.expr(e.value, sub)
            else:
                self.expr(e.elt, sub)
            self.loops -= 1
            return
        if isinstance(e, ast.Lambda):
            self.expr(e.body, env)
            return
        if isinstance(e, ast.Call):
            self._check_call(e, env)
            self.expr(e.func, env)
            for a in e.args:
                self.expr(a, env)
            for kw in e.keywords:
                self.expr(kw.value, env)
            return
        for child in ast.iter_child_nodes(e):
            if isinstance(child, ast.expr):
                self.expr(child, env)

    # -- the rules -------------------------------------------------------------
    def _h2d(self, e: ast.Call) -> bool:
        """A host-to-device copy: a host maker with ``device=``, ``.to()``
        of a host maker's result, or ``.cuda()``."""
        f = e.func
        ch = self.mod.chain(f)
        if ch is not None and ch[0] == "torch" and ch[-1] in HOST_MAKERS:
            dev = _kw(e, "device")
            return dev is not None and not (
                isinstance(dev, ast.Constant) and dev.value in (None, "cpu"))
        if isinstance(f, ast.Attribute) and f.attr == "cuda":
            return ch is None
        if isinstance(f, ast.Attribute) and f.attr == "to" \
                and isinstance(f.value, ast.Call):
            inner = self.mod.chain(f.value.func)
            return inner is not None and inner[0] == "torch" \
                and inner[-1] in HOST_MAKERS
        return False

    def _check_call(self, e: ast.Call, env: _Env):
        if not self.emit:
            return
        base = _basename(e.func)
        ch = self.mod.chain(e.func)
        if base in CAPTURES and ch is not None and (
                ch[-2:] in (["cuda", "CUDAGraph"], ["cuda", "graph"])
                or ch == ["torch", "compile"]) and self.defs \
                and not any(c for _, c, _ in self.defs):
            self._emit(
                "HD003", e,
                f"{'.'.join(ch)}(...) made inside a function that no "
                f"lru_cache memoizes captures per call, not per structure;"
                f" memoize the factory or allowlist the cache that holds "
                f"it")
        if self.captured:
            return
        h2d = self._h2d(e)
        if h2d and self.loops:
            self._emit(
                "HD001", e,
                "host data copied to the device inside a host loop: one "
                "host-to-device copy an iteration; stack on the host and "
                "copy once")
        if h2d and not _is_true(_kw(e, "non_blocking")):
            self._emit(
                "HD002", e,
                "blocking host-to-device copy: the host waits for it "
                "(a synchronization the sync debug mode reports)")
        sync = None
        if isinstance(e.func, ast.Attribute) and ch is None:
            if e.func.attr in SYNC_METHODS_ANY:
                sync = f".{e.func.attr}()"
            elif e.func.attr in SYNC_METHODS_TENSOR \
                    and self.is_tensor(e.func.value, env):
                sync = f".{e.func.attr}() of a tensor"
        elif ch is not None and ch[0] == "torch" and ch[-1] in SYNC_TORCH:
            sync = ".".join(ch)
        elif ch is not None and ch[-2:] == ["cuda", "graph"]:
            sync = "torch.cuda.graph (synchronizes on entry)"
        elif isinstance(e.func, ast.Name) \
                and e.func.id in ("int", "float", "bool") and e.args \
                and self.is_tensor(e.args[0], env):
            sync = f"{e.func.id}() of a tensor"
        if sync:
            self._emit(
                "HD002", e,
                f"{sync} in host code waits for the card (a device-to-host"
                f" sync); keep the value on the device or read it once")
        if isinstance(e.func, ast.Attribute) and e.func.attr in PER_TRIP \
                and ch is None:
            names = {n for n, _, _ in self.defs}
            if not (self.rel == ENGINE_FILE and names & ENGINE_LOOP):
                self._emit(
                    "HD004", e,
                    f"host call into the engine's per-trip "
                    f".{e.func.attr}() dispatches its ops eagerly outside"
                    f" the captured loop; go through _Engine.run (or "
                    f"lane_stepper, to inspect a trip)")


def scan_source(rel_path: str, source: str) -> List[Finding]:
    tree = ast.parse(source, filename=rel_path)
    mod = _Module(tree)
    for _ in range(2):      # settle the class attributes and the returns
        _Scanner(rel_path, tree, mod, emit=False).block(tree.body, _Env())
    scanner = _Scanner(rel_path, tree, mod, emit=True)
    scanner.block(tree.body, _Env())
    return scanner.findings


def _scan_files(ctx) -> List[Finding]:
    cache = ctx.__dict__.get("_hd_cache")
    if cache is None:
        cache = []
        for abs_path, rel_path in ctx.files:
            with open(abs_path, encoding="utf-8") as f:
                cache.extend(scan_source(rel_path, f.read()))
        ctx._hd_cache = cache
    return cache


def _make_rule(rule_id: str):
    def run(ctx) -> List[Finding]:
        return [f for f in _scan_files(ctx) if f.rule == rule_id]
    return run


rule_hd001 = _make_rule("HD001")
rule_hd002 = _make_rule("HD002")
rule_hd003 = _make_rule("HD003")
rule_hd004 = _make_rule("HD004")
