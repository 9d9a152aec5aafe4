"""Trace-discipline rules (TD*): properties of the ops the port's entry
points dispatch, recorded by ``graph_tools.Recorder``, not of source text.

The JAX package traces its jit boundaries into jaxprs; the port runs
eagerly, so each entry is run once on small CPU tensors under the
recorder (twice for TD002), and the rules read what it dispatched:

* TD001: no float64 / complex128 op. The deliberate sites (single-rounding
  fused multiply-adds that match XLA's bits, the device-sharded engine's
  float64 exchange buffer) are allowlist entries naming their function.
* TD002, the counterpart of weak types and of the x64 pass: under
  ``torch.set_default_dtype(torch.float64)`` each entry dispatches the
  same ops with the same dtypes as under float32, which holds only if no
  op takes its dtype from the default.
* TD003: the capture key is structure-only. ``static_of`` is invariant
  under a change of every traced field (and of the scheduler), and no op
  of a trip receives a traced per-point value as a Python scalar: a
  scalar argument would be baked into a captured CUDA graph and replayed
  for every later run of the same structure. The second check runs the
  entry with the traced fields set to sentinels and looks for them among
  the recorded scalar arguments.
* TD004, the counterpart of donation: every buffer that the engine's
  ``load`` fills is read, by the carry's initialization or by a trip;
  a buffer filled for every run and never read is a host-to-device copy
  for nothing.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis import graph_tools as gt
from repro_torch.analysis.findings import Finding, Severity

FAMILY = "trace-discipline"


@dataclasses.dataclass
class TraceEntry:
    """One entry point: ``build()`` -> ``(fn, args, kwargs)``; ``fn(*args,
    **kwargs)`` is what is recorded. ``build`` runs under the same default
    dtype as ``fn``."""
    name: str
    build: Callable[[], Tuple[Callable, tuple, dict]]


@dataclasses.dataclass
class StaticKeyEntry:
    """A capture-key audit: ``static_of(spec)`` must be invariant between
    ``spec_a`` and ``spec_b``, which differ in every traced field. With
    ``run``, ``run(spec_b)`` returns a thunk (a trip) that is recorded,
    and no recorded op may take one of ``spec_b``'s traced values as a
    Python scalar (so ``spec_b``'s values are chosen as sentinels)."""
    name: str
    static_of: Callable
    spec_a: object
    spec_b: object
    traced_fields: Sequence[str]
    run: Optional[Callable] = None


@dataclasses.dataclass
class LoadEntry:
    """A load audit: ``build()`` -> ``(buffers, run)``; every tensor of
    ``buffers`` (name -> tensor, filled by the load) must be read by some
    op of the recorded ``run()``. Zero-size buffers are exempt: they carry
    no bytes."""
    name: str
    build: Callable[[], Tuple[Dict[str, torch.Tensor], Callable]]


def _entry_path(name: str) -> str:
    return f"<entry:{name}>"


def record_entry(entry: TraceEntry, dtype=torch.float32) -> gt.Recorder:
    """Build and record ``entry`` with ``dtype`` as the default dtype."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        fn, args, kwargs = entry.build()
        rec, _ = gt.record(fn, *args, **kwargs)
    finally:
        torch.set_default_dtype(prev)
    return rec


def _recording(ctx, entry: TraceEntry, dtype) -> gt.Recorder:
    cache = ctx.__dict__.setdefault("_recordings", {})
    key = (id(entry), str(dtype))
    if key not in cache:
        cache[key] = record_entry(entry, dtype)
    return cache[key]


def float64_findings(name: str, rec: gt.Recorder) -> List[Finding]:
    """TD001 on one recording, one finding a (site, dtype)."""
    out, seen = [], set()
    for op in gt.float64_ops(rec):
        bad = sorted({d for d in op.in_dtypes + op.out_dtypes
                      if d in gt.BAD_DTYPES})
        if (op.site, tuple(bad)) in seen:
            continue
        seen.add((op.site, tuple(bad)))
        out.append(Finding(
            "TD001", FAMILY, Severity.ERROR,
            op.site.path or _entry_path(name), op.site.line,
            op.site.symbol,
            f"{op.op} on {'/'.join(d[6:] for d in bad)} in entry {name} — "
            f"the port is float32; give the producing site an explicit "
            f"float32 dtype or allowlist the deliberate site"))
    return out


def rule_td001(ctx) -> List[Finding]:
    """TD001: no float64 / complex128 op in a recorded entry."""
    out: List[Finding] = []
    for entry in ctx.trace_entries:
        out.extend(float64_findings(entry.name,
                                    _recording(ctx, entry, torch.float32)))
    return out


def rule_td002(ctx) -> List[Finding]:
    """TD002: the same ops with the same dtypes under a float64 default."""
    out: List[Finding] = []
    for entry in ctx.trace_entries:
        a = _recording(ctx, entry, torch.float32).ops
        b = _recording(ctx, entry, torch.float64).ops
        seen = set()
        for x, y in zip(a, b):
            if x.op != y.op:
                out.append(Finding(
                    "TD002", FAMILY, Severity.ERROR,
                    y.site.path or _entry_path(entry.name), y.site.line,
                    y.site.symbol,
                    f"under a float64 default entry {entry.name} "
                    f"dispatches {y.op} where float32 gives {x.op}"))
                break
            if x.signature != y.signature and y.site not in seen:
                seen.add(y.site)
                out.append(Finding(
                    "TD002", FAMILY, Severity.ERROR,
                    y.site.path or _entry_path(entry.name), y.site.line,
                    y.site.symbol,
                    f"{y.op} in entry {entry.name} takes its dtype from "
                    f"the default: {x.in_dtypes}->{x.out_dtypes} under "
                    f"float32, {y.in_dtypes}->{y.out_dtypes} under float64"
                    f" — pass dtype= explicitly"))
        else:
            if len(a) != len(b):
                out.append(Finding(
                    "TD002", FAMILY, Severity.ERROR,
                    _entry_path(entry.name), 0, "op-count",
                    f"entry {entry.name} dispatches {len(a)} ops under a "
                    f"float32 default and {len(b)} under float64"))
    return out


def _static_diff(sa, sb) -> str:
    if dataclasses.is_dataclass(sa) and dataclasses.is_dataclass(sb):
        diff = [f"{f.name}: {getattr(sa, f.name)!r} != "
                f"{getattr(sb, f.name)!r}" for f in dataclasses.fields(sa)
                if getattr(sa, f.name) != getattr(sb, f.name)]
        if diff:
            return ", ".join(diff)
    return f"{sa!r} != {sb!r}"


def sentinel_findings(entry: StaticKeyEntry) -> List[Finding]:
    """The recorded ops of ``entry.run(entry.spec_b)`` that take one of
    ``spec_b``'s traced values as a Python scalar."""
    values = {}
    for f in entry.traced_fields:
        values.setdefault(np.float32(getattr(entry.spec_b, f)), f)
    rec, _ = gt.record(entry.run(entry.spec_b))
    out, seen = [], set()
    for op in rec.ops:
        for s in op.scalars:
            if isinstance(s, bool) or not isinstance(s, float):
                continue
            field = values.get(np.float32(s))
            if field is None or (op.site, field) in seen:
                continue
            seen.add((op.site, field))
            out.append(Finding(
                "TD003", FAMILY, Severity.ERROR,
                op.site.path or _entry_path(entry.name), op.site.line,
                op.site.symbol,
                f"{op.op} in entry {entry.name} takes the traced field "
                f"{field} (= {s!r}) as a Python scalar: a captured graph "
                f"would replay this run's value for every later run of the "
                f"same structure; pass it as a tensor"))
    return out


def rule_td003(ctx) -> List[Finding]:
    """TD003: the capture key is structure-only and no traced value
    reaches an op as a Python scalar."""
    out: List[Finding] = []
    for entry in ctx.static_key_entries:
        sa = entry.static_of(entry.spec_a)
        sb = entry.static_of(entry.spec_b)
        if sa != sb:
            out.append(Finding(
                "TD003", FAMILY, Severity.ERROR,
                _entry_path(entry.name), 0, "static-key",
                f"static key changed under a traced-fields-only spec "
                f"change ({_static_diff(sa, sb)}) — a traced value leaked "
                f"into the capture key; every sweep point would build its "
                f"own engine and capture its own graph"))
        if entry.run is not None:
            out.extend(sentinel_findings(entry))
    return out


def rule_td004(ctx) -> List[Finding]:
    """TD004: every buffer a load fills is read."""
    out: List[Finding] = []
    for entry in ctx.load_entries:
        buffers, run = entry.build()
        rec, _ = gt.record(run)
        for name in sorted(buffers):
            key = gt._storage_key(buffers[name])
            if key is None or key in rec.read_keys:
                continue
            t = buffers[name]
            out.append(Finding(
                "TD004", FAMILY, Severity.ERROR,
                _entry_path(entry.name), 0, name,
                f"buffer {name} {tuple(t.shape)} {t.dtype} is filled by "
                f"the load and never read by the run"))
    return out


# ---------------------------------------------------------------------------
# default entries: the port's real entry points, on small CPU inputs
# ---------------------------------------------------------------------------
LINT_N, LINT_S = 3, 6
SEG_N = 2048          # the segmented engine's fleet (SEG_AUTO_MIN)


def sim_inputs(n: int = LINT_N, s: int = LINT_S, arrive: bool = False,
               seed: int = 0):
    """``(streams, dev_latency, slo, servers)`` of a small fleet."""
    from repro_torch.configs.cascade_tiers import ServerProfile
    from repro_torch.sim import synthetic
    streams = dict(synthetic.device_streams(n, s, 0.7, [0.9], seed))
    if arrive:
        streams["arrive"] = np.cumsum(np.full((n, s), 0.02, np.float32),
                                      axis=1, dtype=np.float32)
    lat = np.full(n, 0.05, np.float32)
    slo = np.full(n, 0.2, np.float32)
    srv = (ServerProfile("lint", "synthetic", 0.9, 0.05, 16),)
    return streams, lat, slo, srv


def build_engine(spec=None, *, n: int = LINT_N, s: int = LINT_S,
                 arrive: bool = False, device="cpu"):
    """A loaded ``jaxsim._Engine`` (MultiTASC++ with model switching by
    default) on ``device``: the engine ``run_sweep`` would build."""
    from repro_torch.sim import jaxsim
    spec = spec or jaxsim.JaxSimSpec("multitasc++", n, s,
                                     model_switching=True)
    streams, lat, slo, srv = sim_inputs(spec.n_devices,
                                        spec.samples_per_device, arrive)
    static, params, srvt, arrays, b, _ = jaxsim._prepare(
        spec, streams, lat, slo, srv, None, None, None, None)
    eng = jaxsim._Engine(static, b, torch.device(device))
    eng.load(params, srvt, arrays)
    return eng


def engine_trip(eng) -> None:
    """One trip of a loaded engine, as ``_Engine.run`` runs it."""
    with torch.inference_mode():
        eng.trip()


def _engine_entry(name: str, **kw) -> TraceEntry:
    def build():
        return functools.partial(engine_trip, build_engine(**kw)), (), {}
    return TraceEntry(name, build)


def device_engine_trip(n: int = LINT_N, s: int = LINT_S) -> None:
    """Build, load and step one trip of the device-sharded engine over a
    one-rank gloo group (initialized here and destroyed after, unless the
    process already has a default group of one rank)."""
    import torch.distributed as dist

    from repro_torch.sim import jaxsim
    spec = jaxsim.JaxSimSpec("multitasc++", n, s, model_switching=True)
    streams, lat, slo, srv = sim_inputs(n, s)
    static, params, srvt, arrays, _, _ = jaxsim._prepare(
        [spec], streams, lat, slo, srv, None, None, None, None,
        frontier_seg=True)
    made = not dist.is_initialized()
    if made:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        if dist.get_world_size() != 1:
            raise RuntimeError("the device-engine entry needs a process "
                               "group of one rank")
        eng = jaxsim._DeviceEngine(static, 1, 0, dist.group.WORLD,
                                   torch.device("cpu"))
        eng.load(params, srvt, arrays)
        engine_trip(eng)
    finally:
        if made:
            dist.destroy_process_group()


def _scheduler_entries() -> List[TraceEntry]:
    def build_mtpp():
        from repro_torch.core import multitascpp as mtpp
        st = {"thresh": torch.full((4,), 0.5, dtype=torch.float32),
              "mult": torch.ones(4, dtype=torch.float32)}
        fn = functools.partial(mtpp.update, cfg=mtpp.MultiTASCPPConfig())
        return fn, (st, torch.full((4,), 90.0, dtype=torch.float32)), {
            "sr_target": torch.full((4,), 95.0, dtype=torch.float32),
            "n_active": torch.tensor(4, dtype=torch.int32),
            "active": torch.ones(4, dtype=torch.bool)}

    def build_mt():
        from repro_torch.core import multitasc as mt
        st = {"thresh": torch.full((4,), 0.5, dtype=torch.float32)}
        return mt.update, (st, torch.tensor(4, dtype=torch.int32),
                           torch.tensor(8, dtype=torch.int32),
                           mt.MultiTASCConfig()), {
            "active": torch.ones(4, dtype=torch.bool)}

    def build_decide():
        from repro_torch.core import switching
        return switching.decide, (
            torch.full((6,), 0.5, dtype=torch.float32),
            torch.zeros(6, dtype=torch.int32), 3,
            torch.tensor(0.05, dtype=torch.float32),
            torch.full((3,), 0.8, dtype=torch.float32)), {
            "active": torch.ones(6, dtype=torch.bool)}

    return [TraceEntry("mtpp-update", build_mtpp),
            TraceEntry("mt-update", build_mt),
            TraceEntry("switching-decide", build_decide)]


def classify_step(device="cpu"):
    """``(fn, args)``: the serving classify function of ``tier-low`` at
    bucket 1 (a device client's call) and its inputs on ``device``."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving import executables
    model = init_params(get_config("tier-low"),
                        torch.Generator().manual_seed(0), device=device)
    fn = executables.classify_fn(model, 1)
    tokens = torch.zeros((1, 8), dtype=torch.int32, device=device)
    return fn, (model, tokens)


def _serving_classify_entry() -> TraceEntry:
    def build():
        fn, args = classify_step()
        return fn, args, {}
    return TraceEntry("serving-classify", build)


def _kernel_entries() -> List[TraceEntry]:
    """The four ``kernels/ops.py`` wrappers on CPU tensors (their plain
    versions)."""
    from repro_torch.kernels import ops
    f32 = torch.float32

    def build_bvsb():
        return ops.bvsb, (torch.zeros((8, 256), dtype=f32),), {}

    def build_flash():
        q = torch.zeros((2, 16, 4, 32), dtype=f32)
        kv = torch.zeros((2, 16, 2, 32), dtype=f32)
        return ops.flash_attention, (q, kv, kv), {"causal": True}

    def build_decode():
        q = torch.zeros((2, 4, 32), dtype=f32)
        kc = torch.zeros((2, 16, 2, 32), dtype=f32)
        return ops.decode_attention, (
            q, kc, kc, torch.full((2,), 9, dtype=torch.int32)), {}

    def build_rglru():
        a = torch.zeros((2, 16, 32), dtype=f32)
        return ops.rglru_scan, (a, a), {}

    return [TraceEntry("kernel-bvsb", build_bvsb),
            TraceEntry("kernel-flash", build_flash),
            TraceEntry("kernel-decode", build_decode),
            TraceEntry("kernel-rglru", build_rglru)]


def default_trace_entries() -> List[TraceEntry]:
    return ([_engine_entry("engine-trip"),
             _engine_entry("engine-trip-arrive", arrive=True),
             _engine_entry("engine-trip-seg", n=SEG_N),
             TraceEntry("device-engine-trip",
                        lambda: (device_engine_trip, (), {}))]
            + _scheduler_entries() + [_serving_classify_entry()]
            + _kernel_entries())


# the traced fields of the TD003 spec pair's second spec: odd values, so
# that none equals a constant of the engine by chance
SENTINELS = {"a": 0.0073125, "sr_target": 93.171875,
             "init_threshold": 0.42138672, "static_threshold": 0.37194824,
             "multitasc_step": 0.043701172, "mult_growth": 0.13793945,
             "c_lower": 0.061279297}


def static_key_specs():
    """TD003's spec pair: the defaults, and a spec that differs in every
    traced field (set to ``SENTINELS``), in the scheduler and in the real
    device count within the same padded width."""
    from repro_torch.sim import jaxsim
    spec_a = jaxsim.JaxSimSpec("multitasc++", LINT_N, LINT_S,
                               model_switching=True)
    spec_b = jaxsim.JaxSimSpec("multitasc", LINT_N + 2, LINT_S,
                               model_switching=True,
                               **{f: SENTINELS[f]
                                  for f in jaxsim.TRACED_FIELDS})
    return spec_a, spec_b


def _sentinel_run(spec):
    eng = build_engine(spec)

    def run():
        with torch.inference_mode():
            eng._init()
            eng.trip()
            eng.trip()
    return run


def default_static_key_entries() -> List[StaticKeyEntry]:
    from repro_torch.sim import jaxsim
    spec_a, spec_b = static_key_specs()
    return [StaticKeyEntry(
        name="jaxsim-static",
        static_of=lambda sp: jaxsim._static_of(sp, n_servers=1,
                                               max_lat=0.05),
        spec_a=spec_a, spec_b=spec_b,
        traced_fields=jaxsim.TRACED_FIELDS, run=_sentinel_run)]


def _load_entry(name: str, **kw) -> LoadEntry:
    def build():
        eng = build_engine(**kw)

        def run():
            with torch.inference_mode():
                eng._init()
                eng.trip()
        return dict(eng.c), run
    return LoadEntry(name, build)


def default_load_entries() -> List[LoadEntry]:
    return [_load_entry("engine-load"),
            _load_entry("engine-load-arrive", arrive=True),
            _load_entry("engine-load-seg", n=SEG_N)]
