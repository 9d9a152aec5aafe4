"""Lane-aligned closed-loop simulator: the multi-device cascade as one
event loop over a batch of sweep points, in PyTorch on one device.

Counterpart of the JAX package's ``sim/jaxsim.py`` (its module docstring
sets out the model: event jumps, the lane-aligned batched loop, the
static/traced split, churn and arrival scenarios). Every sweep point is a
lane of (B, ...) tensors; one loop trip advances every lane that has an
event due inside its current window by exactly that one event, then
closes the window of every lane whose frontier left it (scheduler update,
model switching, trace row). A lane with nothing to do in a trip is
bitwise frozen, so its results do not depend on B or on its companions.

How the JAX core maps onto PyTorch:

* ``lax.while_loop(any(active))`` becomes a host loop that runs
  ``GRAPH_TRIPS`` trips between two reads of ``any(active)``: extra trips
  of finished lanes are no-ops, so the card never waits on the host
  inside those trips. On the card the trips are captured once per
  (static structure, B) as one ``torch.cuda.CUDAGraph`` over persistent
  state buffers and replayed; the CPU runs the same trip function
  eagerly.
* The boundary ``lax.cond`` and the scheduler ``lax.switch`` become
  masked computations that run every trip: the three scheduler updates
  are computed for every lane and each lane keeps its own.
* ``.at[pos].set(..., mode="drop")`` becomes an in-place scatter into a
  buffer with one trash slot past ``cap`` (the queue ring) or past
  ``n_windows`` (the trace rows), never read back. The duplicate-index
  ``.at[devs].add`` stays on int32 counters (``scatter_add_``; atomics on
  the card are exact on integers).
* XLA on the CPU contracts ``x + y * z`` into one fused multiply-add where
  the JAX core writes it (the Eq. 4 step; a batch's finish time
  ``t + base * (1 + scaling * (b - 1))``, both of its multiply-adds); the
  port forms those in float64 from exact products (``_fma32``), so both
  devices give the jitted bits.

Semantics, inputs and outputs are those of the JAX ``run`` /
``run_sweep`` (same names, shapes and metric dict; arrays come back as
numpy). Streams are made on the host with numpy and moved to the device
once. Not ported yet (ROADMAP Queue A): the segmented frontier
(``frontier_seg``, automatic at ``n_pad >= SEG_AUTO_MIN``), the sharded
sweep (``run_sweep_sharded``), the device-sharded engine
(``run_device_sharded``) and ``lane_stepper``: they raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.cascade_tiers import BATCH_LADDER, ServerProfile
from repro_torch.core import multitasc as mt
from repro_torch.core import multitascpp as mtpp
from repro_torch.core import switching

MAX_POP = 64
N_BUCKET = 128          # device axis pads up to a multiple of this
MAX_TIERS = 4           # tier axis is padded to this fixed width
DURATION_QUANTUM = 30.0  # simulated duration rounds up to this grid (s)
SEG_AUTO_MIN = 2048      # n_pad from which the JAX package segments the
#                          frontier (not ported: such a fleet raises)
GRAPH_TRIPS = 32         # loop trips between two reads of any(active)

SCHED_CODES = {"multitasc++": 0, "multitasc": 1, "static": 2}

# per-point scalars that are inputs of the core (stacked on the sweep
# axis by run_sweep); structure lives in JaxSimStatic
TRACED_FIELDS = ("a", "sr_target", "init_threshold", "static_threshold",
                 "multitasc_step", "mult_growth", "c_lower")

TRACE_KEYS = ("thresh", "sr", "active", "server_idx", "fwd", "acc")

# carry fields a window boundary touches (the rest only events move)
BOUNDARY_FIELDS = ("thresh", "mult", "win_met", "win_total", "server_idx",
                   "w", "k", "active")

_NOT_PORTED = ("not ported to repro_torch yet (ROADMAP.md Queue A: the "
               "segmented frontier and the sharded sweeps)")

_F32, _I32 = torch.float32, torch.int32


@dataclasses.dataclass(frozen=True)
class JaxSimSpec:
    scheduler: str                  # "multitasc++" | "multitasc" | "static"
    n_devices: int
    samples_per_device: int
    window: float = 1.5
    a: float = mtpp.DEFAULT_A
    sr_target: float = 95.0
    init_threshold: float = 0.5
    static_threshold: float = 0.35
    multitasc_step: float = 0.05
    mult_growth: float = 0.1       # Alg. 1 accelerator; 0 disables it
    model_switching: bool = False
    c_lower: float = switching.DEFAULT_C_LOWER
    extra_time: float = 40.0
    server_init: int = 0
    # the server queue ring's capacity; the default (n_pad * samples +
    # MAX_POP) holds every sample forwarded at once. A smaller ring must
    # stay clear of the realized ``queue_peak``.
    queue_cap: int | None = None


@dataclasses.dataclass(frozen=True)
class JaxSimStatic:
    """The structure of a sweep: what sizes the state buffers and the
    loop, and so keys the captured graphs."""
    n_pad: int
    samples_per_device: int
    n_servers: int
    window: float
    n_windows: int
    max_events_per_window: int   # safety cap on events in one window
    cap: int
    has_arrive: bool = False
    seg: int = 0                 # segmented frontier width (not ported)


@dataclasses.dataclass
class SweepStats:
    """Process-wide counters for benchmark accounting."""
    engines_built: int = 0     # distinct (static, B, device) state sets
    graphs_captured: int = 0   # CUDA graphs of GRAPH_TRIPS trips
    points: int = 0            # sweep points simulated
    events: int = 0            # event-loop iterations across all points
    trips: int = 0             # loop trips, each over all lanes of a run


stats = SweepStats()


def stats_snapshot() -> Dict[str, int]:
    return dataclasses.asdict(stats)


def _seg_layout(n_pad: int, frontier_seg):
    """The flat frontier is all the port has: ``None`` below
    ``SEG_AUTO_MIN`` and ``False`` / ``0`` take it; anything that would
    segment the frontier in the JAX package raises."""
    flat = frontier_seg is False or (
        frontier_seg is not None and not isinstance(frontier_seg, bool)
        and int(frontier_seg) == 0)
    if flat or (frontier_seg is None and n_pad < SEG_AUTO_MIN):
        return 0, n_pad
    raise NotImplementedError(
        f"the segmented frontier (n_pad {n_pad}, frontier_seg "
        f"{frontier_seg!r}) is {_NOT_PORTED}")


def _static_of(spec: JaxSimSpec, n_servers: int, max_lat: float,
               n_stream: int | None = None, lead: float = 0.0,
               has_arrive: bool = False, frontier_seg=None) -> JaxSimStatic:
    # ``lead``: pooled worst-case head start before a device's last sample
    # can begin (max of join_t + arrive[-1]); zero when saturated
    duration = max_lat * spec.samples_per_device + lead + spec.extra_time
    duration = -(-duration // DURATION_QUANTUM) * DURATION_QUANTUM
    n_pad = -(-(n_stream or spec.n_devices) // N_BUCKET) * N_BUCKET
    seg, n_pad = _seg_layout(n_pad, frontier_seg)
    cap = n_pad * spec.samples_per_device + MAX_POP
    if spec.queue_cap is not None:
        if spec.queue_cap <= MAX_POP:
            raise ValueError(f"queue_cap must exceed MAX_POP={MAX_POP}")
        cap = min(cap, int(spec.queue_cap))
    return JaxSimStatic(
        n_pad=n_pad, samples_per_device=spec.samples_per_device,
        n_servers=n_servers, window=float(spec.window),
        n_windows=int(-(-duration // spec.window)),
        max_events_per_window=2 * n_pad * spec.samples_per_device + MAX_POP,
        cap=cap, has_arrive=has_arrive, seg=seg)


def _params_of(spec: JaxSimSpec, servers: Sequence[ServerProfile],
               slo_min: float) -> Dict[str, np.ndarray]:
    if spec.scheduler not in SCHED_CODES:
        raise ValueError(f"unknown scheduler {spec.scheduler!r}")
    p = {f: np.float32(getattr(spec, f)) for f in TRACED_FIELDS}
    p["scheduler"] = np.int32(SCHED_CODES[spec.scheduler])
    p["model_switching"] = np.int32(spec.model_switching)
    p["n_real"] = np.int32(spec.n_devices)
    p["b_opt"] = np.int32(mt.optimal_batch(servers[spec.server_init],
                                           slo_min))
    p["server_init"] = np.int32(spec.server_init)
    return p


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch.sim.jaxsim runs on the CUDA card by default and "
            "none is available; pass device='cpu' to run on the CPU")
    return dev


def run(spec: JaxSimSpec, streams, dev_latency, slo,
        servers: Sequence[ServerProfile], *, tier_ids=None, c_upper=None,
        offline_start=None, offline_for=None, join_t=None, leave_t=None,
        frontier_seg=None, device="cuda"):
    """Single sweep point: ``run_sweep`` with B=1, batch axis stripped.

    Arguments and the metric dict are the JAX package's ``jaxsim.run``
    (``streams``: ``confidence`` / ``correct_light`` (N, S),
    ``correct_heavy`` (N, S, P), optional ``arrive`` (N, S); device
    vectors scalar or (N,)); ``device`` is where the loop runs, the card
    unless the caller asks for the CPU.
    """
    out = run_sweep([spec], streams, dev_latency, slo, servers,
                    tier_ids=tier_ids, c_upper=c_upper,
                    offline_start=offline_start, offline_for=offline_for,
                    join_t=join_t, leave_t=leave_t,
                    frontier_seg=frontier_seg, device=device)
    out = {k: v[0] for k, v in out.items() if k != "traces"} | {
        "traces": {k: v[0] for k, v in out["traces"].items()}}
    return out


def _prepare(specs, streams, dev_latency, slo, servers, tier_ids, c_upper,
             offline_start, offline_for, join_t=None, leave_t=None,
             frontier_seg=None):
    """Validate and stack a sweep's host-side inputs, as the JAX package's
    ``_prepare``: returns ``(static, params, srv, arrays, b, n)``, all
    numpy (``params`` (B,)-stacked per-point scalars, ``srv`` the server
    tables, ``arrays`` the (B, ...) per-point tensors)."""
    if isinstance(specs, JaxSimSpec):
        specs = [specs]
    specs = list(specs)
    if not specs:
        raise ValueError("run_sweep needs at least one spec")

    if hasattr(streams, "materialize"):   # a synthetic.StreamChunks
        streams = streams.materialize()
    conf = np.asarray(streams["confidence"], np.float32)
    cl = np.asarray(streams["correct_light"], np.int32)
    ch = np.asarray(streams["correct_heavy"], np.int32)
    arrive = streams.get("arrive")
    arrive = None if arrive is None else np.asarray(arrive, np.float32)
    if conf.ndim == 2:
        conf, cl, ch = conf[None], cl[None], ch[None]
    if arrive is not None and arrive.ndim == 2:
        arrive = arrive[None]
    if ch.ndim == 3:
        ch = ch[..., None]
    b = max(len(specs), conf.shape[0])
    if len(specs) == 1 and b > 1:
        specs = specs * b
    if len(specs) != b:
        raise ValueError(
            f"{len(specs)} specs for stream batch {conf.shape[0]}")
    if conf.shape[0] == 1 and b > 1:
        conf = np.broadcast_to(conf, (b,) + conf.shape[1:])
        cl = np.broadcast_to(cl, (b,) + cl.shape[1:])
        ch = np.broadcast_to(ch, (b,) + ch.shape[1:])
    if arrive is not None and arrive.shape[0] == 1 and b > 1:
        arrive = np.broadcast_to(arrive, (b,) + arrive.shape[1:])

    n = max(sp.n_devices for sp in specs)
    s = specs[0].samples_per_device
    if conf.shape != (b, n, s):
        raise ValueError(f"streams shape {conf.shape} != {(b, n, s)}"
                         " (device axis = widest lane)")
    bad = [sp.samples_per_device for sp in specs
           if sp.samples_per_device != s]
    if bad:
        raise ValueError(
            f"all specs must share samples_per_device={s};"
            f" got {sorted(set(bad))}")
    if arrive is not None and arrive.shape != (b, n, s):
        raise ValueError(f"streams['arrive'] shape {arrive.shape} != "
                         f"{(b, n, s)} (cumulative seconds per sample)")
    n_real = np.asarray([sp.n_devices for sp in specs], np.int32)

    def per_point(x, fill, dtype, width, pad_fill=None):
        arr = (np.full((width,), fill, dtype) if x is None
               else np.atleast_1d(np.asarray(x, dtype)))
        if arr.ndim == 1 and arr.shape[0] == 1 and width != 1:
            arr = np.broadcast_to(arr, (width,))
        arr = np.broadcast_to(arr, (b, arr.shape[-1])).astype(dtype)
        if arr.shape[-1] < width:
            pad = np.full((b, width - arr.shape[-1]),
                          fill if pad_fill is None else pad_fill, dtype)
            arr = np.concatenate([arr, pad], axis=-1)
        return arr

    dev_lat_real = per_point(dev_latency, 0.0, np.float32, n)
    # the window count covers the slowest real device of the whole batch
    real_mask = np.arange(n)[None, :] < n_real[:, None]
    max_lat = float(dev_lat_real[real_mask].max())
    join_real = per_point(join_t, 0.0, np.float32, n)
    lead = join_real + (arrive[..., -1] if arrive is not None else 0.0)
    lead_max = float(lead[real_mask].max()) if np.any(real_mask) else 0.0

    statics = {_static_of(sp, len(servers), max_lat, n, lead_max,
                          arrive is not None, frontier_seg)
               for sp in specs}
    if len(statics) != 1:
        raise ValueError(
            "run_sweep points must share static structure; got "
            f"{len(statics)} distinct structures: {sorted(map(str, statics))}")
    static = statics.pop()
    n_pad = static.n_pad

    def pad_streams(x):
        if n_pad == n:
            return x
        out = np.zeros((b, n_pad) + x.shape[2:], x.dtype)
        out[:, :n] = x
        return out

    # devices beyond each lane's own n_devices are inert: infinite latency
    dev_lat = per_point(dev_lat_real, 0.0, np.float32, n_pad,
                        pad_fill=np.inf)
    dev_lat = np.where(np.arange(n_pad)[None, :] < n_real[:, None],
                       dev_lat, np.inf).astype(np.float32)
    slo_b = per_point(slo, 0.0, np.float32, n_pad)
    tier_b = per_point(tier_ids, 0, np.int32, n_pad)
    if int(tier_b.max()) + 1 > MAX_TIERS:
        raise ValueError(f"at most {MAX_TIERS} device tiers supported")
    c_upper_b = per_point(c_upper, 0.8, np.float32, MAX_TIERS)
    off_start_b = per_point(offline_start, np.inf, np.float32, n_pad)
    off_for_b = per_point(offline_for, 0.0, np.float32, n_pad)
    join_b = per_point(join_real, 0.0, np.float32, n_pad)
    leave_b = per_point(leave_t, np.inf, np.float32, n_pad, pad_fill=np.inf)
    arrive_b = (np.zeros((b, n_pad, 0), np.float32) if arrive is None
                else pad_streams(np.ascontiguousarray(arrive)))

    plist = [_params_of(sp, servers, float(slo_b[i, :sp.n_devices].min()))
             for i, sp in enumerate(specs)]
    params = {k: np.stack([p[k] for p in plist]) for k in plist[0]}
    srv = {
        "base_lat": np.asarray([p.base_latency for p in servers], np.float32),
        "scaling": np.asarray([p.batch_scaling for p in servers], np.float32),
        "max_batch": np.asarray([p.max_batch for p in servers], np.int32),
    }
    arrays = {"conf": pad_streams(conf), "cl": pad_streams(cl),
              "ch": pad_streams(ch), "arrive": arrive_b,
              "dev_latency": dev_lat, "slo": slo_b, "tier_ids": tier_b,
              "c_upper": c_upper_b, "off_start": off_start_b,
              "off_for": off_for_b, "join_t": join_b, "leave_t": leave_b}
    return static, params, srv, arrays, b, n


def run_sweep(specs: Union[JaxSimSpec, Sequence[JaxSimSpec]], streams,
              dev_latency, slo, servers: Sequence[ServerProfile], *,
              tier_ids=None, c_upper=None, offline_start=None,
              offline_for=None, join_t=None, leave_t=None,
              frontier_seg=None, device="cuda"):
    """Batched sweep: B points through one lane-aligned loop on ``device``
    (the card unless the caller asks for the CPU; no card raises).

    Arguments, shapes and the returned metric dict are the JAX package's
    ``jaxsim.run_sweep``: every leaf has a leading B axis (``sr`` (B,),
    ``traces[key]`` (B, n_windows), ...), numpy on the host. Trace rows
    after a lane's early exit are NaN.
    """
    dev = _device(device)
    static, params, srv, arrays, b, n = _prepare(
        specs, streams, dev_latency, slo, servers, tier_ids, c_upper,
        offline_start, offline_for, join_t, leave_t,
        frontier_seg=frontier_seg)
    eng = _engine(static, b, str(dev))
    eng.load(params, srv, arrays)
    eng.run()
    return _finalize(eng.metrics(), b, n)


def _finalize(out, b, n):
    for k in ("per_device_sr", "per_device_acc", "final_thresh"):
        out[k] = out[k][:, :n]
    stats.points += b
    stats.events += int(out["n_events"].sum())
    return out


def run_sweep_sharded(*args, **kwargs):
    """The B axis sharded over several cards: not ported yet."""
    raise NotImplementedError(f"run_sweep_sharded is {_NOT_PORTED}")


def run_device_sharded(*args, **kwargs):
    """One fleet's device axis sharded over several cards: not ported."""
    raise NotImplementedError(f"run_device_sharded is {_NOT_PORTED}")


def lane_stepper(*args, **kwargs):
    """The JAX package's single-trip debug hook: not ported yet."""
    raise NotImplementedError(f"lane_stepper is {_NOT_PORTED}")


def _ratio32(num, den):
    return num.to(_F32) / den.to(_F32)


def _fma32(x, y, z):
    """float32 x * y + z rounded once, as XLA's fused multiply-add on the
    CPU gives it: the float64 product of two float32 values is exact."""
    return (x.double() * y.double() + z.double()).float()


@functools.lru_cache(maxsize=8)
def _engine(static: JaxSimStatic, b: int, device: str) -> "_Engine":
    stats.engines_built += 1
    return _Engine(static, b, torch.device(device))


class _Engine:
    """Persistent (B, ...) buffers of one (static structure, B, device)
    and the loop over them: the JAX package's ``_batched_engine`` and
    ``_run_core_lanes``, with ``_init`` / ``_event`` / ``_boundary`` /
    ``metrics`` for its ``lane_init`` / ``lane_event`` /
    ``lane_boundary`` / ``lane_metrics`` written over all lanes at once.
    Buffers are filled anew by ``load`` for each run, so a CUDA graph
    captured over them serves every later run of the same structure."""

    def __init__(self, static: JaxSimStatic, b: int, device: torch.device):
        self.static, self.b, self.device = static, b, device
        self.graph = None
        n, cap, nw = static.n_pad, static.cap, static.n_windows
        kw = dict(device=device)
        self.lane_ix = torch.arange(b, dtype=torch.int64, **kw)
        self.dev_ix = torch.arange(n, **kw)
        self.pop_ix = torch.arange(MAX_POP, **kw)
        self.ladder = torch.tensor(BATCH_LADDER, **kw)
        self.one = torch.ones((), dtype=_F32, **kw)
        z32 = functools.partial(torch.zeros, dtype=_I32, **kw)
        z64 = functools.partial(torch.zeros, dtype=torch.int64, **kw)
        zf = functools.partial(torch.zeros, dtype=_F32, **kw)
        # the carry: one trash slot past cap in the rings, one trash
        # column past n_windows in the traces. Counters are int32 as in
        # the JAX core; what serves as an index (cursor, queue entries,
        # head, tail, batch size, server index) is int64, as torch's
        # gathers and scatters take it
        self.st = {
            "t": zf(b), "n_events": z32(b), "dev_next": zf(b, n),
            "cursor": z64(b, n), "thresh": zf(b, n), "mult": zf(b, n),
            "win_met": z32(b, n), "win_total": z32(b, n),
            "tot_met": z32(b, n), "tot": z32(b, n), "correct": z32(b, n),
            "fwd": z32(b, n), "q_start": zf(b, cap + 1),
            "q_dev": z64(b, cap + 1), "q_samp": z64(b, cap + 1),
            "head": z64(b), "tail": z64(b), "busy_until": zf(b),
            "last_batch": z64(b), "server_idx": z64(b),
            "last_done_t": zf(b), "max_qlen": z64(b), "w": z32(b),
            "k": z32(b), "frontier": zf(b),
            "active": torch.zeros(b, dtype=torch.bool, **kw),
        }
        self.traces = {key: zf(b, nw + 1) for key in TRACE_KEYS}
        self.c = None

    # -- inputs ----------------------------------------------------------
    def load(self, params, srv, arrays):
        """Move one run's inputs to the device (into the buffers of the
        previous run where a graph reads them) and set the initial carry."""
        dev = self.device
        new = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
               for k, v in {**params, **arrays}.items()}
        new.update({f"srv_{k}": torch.from_numpy(v).to(dev)
                    for k, v in srv.items()})
        new["srv_max_batch"] = new["srv_max_batch"].long()
        # constants the loop reads every trip, formed once per run
        new["met_local"] = new["dev_latency"] <= new["slo"]
        new["off_end"] = new["off_start"] + new["off_for"]
        new["valid"] = self.dev_ix[None, :] < new["n_real"][:, None]
        new["n_real_f"] = new["n_real"].to(_F32)
        self.n_prof = new["ch"].shape[-1]
        if self.c is not None and all(new[k].shape == v.shape
                                      for k, v in self.c.items()):
            for k, v in new.items():
                self.c[k].copy_(v)
        else:   # the first run, or heavy columns other than the last's
            self.c, self.graph = new, None
        self._init()

    def _init(self):
        st, c = self.st, self.c
        for v in st.values():
            v.zero_()
        for v in self.traces.values():
            v.fill_(float("nan"))
        init = torch.where(c["scheduler"] == SCHED_CODES["static"],
                           c["static_threshold"], c["init_threshold"])
        st["thresh"].copy_(init[:, None].expand_as(st["thresh"]))
        st["mult"].fill_(1.0)
        first = (torch.maximum(c["join_t"], c["arrive"][:, :, 0])
                 if self.static.has_arrive else c["join_t"])
        st["dev_next"].copy_(self._defer_offline(first + c["dev_latency"]))
        st["server_idx"].copy_(c["server_init"])
        st["frontier"].copy_(self._next_event_t(st))
        st["active"].copy_(~self._drained(st) & (self.static.n_windows > 0))

    # -- engine pieces ---------------------------------------------------
    def _defer_offline(self, t_complete):
        # a completion inside the device's offline window fires when the
        # device comes back online (the sample is not dropped)
        c = self.c
        offline = (t_complete >= c["off_start"]) & (t_complete < c["off_end"])
        return torch.where(offline, c["off_end"], t_complete)

    def _next_event_t(self, st):
        # next device completion, or the server while a batch is in
        # flight with samples waiting behind it
        s = self.static.samples_per_device
        inf = torch.full((), float("inf"), dtype=_F32, device=self.device)
        t_dev = torch.where(st["cursor"] < s, st["dev_next"], inf).amin(1)
        qlen = st["tail"] - st["head"]
        t_srv = torch.where((st["busy_until"] > st["t"]) & (qlen > 0),
                            st["busy_until"], inf)
        return torch.minimum(t_dev, t_srv)

    def _drained(self, st):
        s = self.static.samples_per_device
        return ((st["tail"] == st["head"])
                & ((st["cursor"] >= s) | ~self.c["valid"]).all(1))

    def _event_flags(self):
        st, sc = self.st, self.static
        t_end = (st["w"] + 1).to(_F32) * sc.window
        return (st["active"] & (st["frontier"] <= t_end)
                & (st["k"] < sc.max_events_per_window))

    def _event(self, go):
        """Advance every lane with ``go`` to its frontier event, in place;
        a lane without ``go`` is left bitwise as it was."""
        st, c, sc = self.st, self.c, self.static
        s, n, cap = sc.samples_per_device, sc.n_pad, sc.cap
        t = st["frontier"]
        dev_next, cursor = st["dev_next"], st["cursor"]

        # --- device completions at exactly this instant ------------------
        due = (dev_next <= t[:, None]) & (cursor < s) & go[:, None]
        departs = due & (dev_next >= c["leave_t"])
        done = due & ~departs
        cj = cursor.clamp(0, s - 1)[..., None]
        local = torch.gather(c["conf"], 2, cj)[..., 0] >= st["thresh"]  # Eq. 3
        comp_local = done & local
        met = comp_local & c["met_local"]
        cl_j = torch.gather(c["cl"], 2, cj)[..., 0]

        fwd_mask = done & ~local
        pos = st["tail"][:, None] + torch.cumsum(fwd_mask, 1) - 1
        # rows that do not forward aim at the trash slot cap
        posm = torch.where(fwd_mask, torch.remainder(pos, cap), cap)
        st["q_start"].scatter_(1, posm, dev_next - c["dev_latency"])
        st["q_dev"].scatter_(1, posm, self.dev_ix.expand(self.b, n))
        st["q_samp"].scatter_(1, posm, cj[..., 0])
        st["tail"].add_(fwd_mask.sum(1, dtype=_I32))

        # a departed device's stream counts as exhausted
        cursor2 = torch.where(departs, s, cursor + done)
        if sc.has_arrive:
            arrive_next = torch.gather(
                c["arrive"], 2, cursor2.clamp(0, s - 1)[..., None])[..., 0]
            start_next = torch.maximum(dev_next, arrive_next)
        else:
            start_next = dev_next
        dev_next2 = torch.where(
            done, self._defer_offline(start_next + c["dev_latency"]),
            dev_next)
        dev_next.copy_(torch.where(departs, float("inf"), dev_next2))
        cursor.copy_(cursor2)
        st["win_met"].add_(met)
        st["win_total"].add_(comp_local)
        st["tot_met"].add_(met)
        st["tot"].add_(comp_local)
        st["correct"].add_(cl_j * comp_local)
        st["fwd"].add_(fwd_mask)
        last_done_t = torch.where(comp_local.any(1), t, st["last_done_t"])

        # --- server dynamic batching ---------------------------------------
        head = st["head"]
        qlen = st["tail"] - head
        can_pop = (t >= st["busy_until"]) & (qlen > 0) & go
        sidx = st["server_idx"]
        braw = torch.minimum(qlen, c["srv_max_batch"][sidx])
        bsz = torch.where(self.ladder <= braw[:, None], self.ladder,
                          1).amax(1)
        take = (self.pop_ix < bsz[:, None]) & can_pop[:, None]
        qidx = torch.remainder(head[:, None] + self.pop_ix, cap)
        starts = torch.gather(st["q_start"], 1, qidx)
        devs = torch.where(take, torch.gather(st["q_dev"], 1, qidx), 0)
        samps = torch.gather(st["q_samp"], 1, qidx)
        # finish = t + base * (1 + scaling * (b - 1)): XLA contracts both
        # multiply-adds, so each rounds once
        finish = _fma32(c["srv_base_lat"][sidx],
                        _fma32(c["srv_scaling"][sidx], bsz - 1, self.one),
                        t)
        met_srv = ((finish[:, None] - starts
                    <= torch.gather(c["slo"], 1, devs)) & take).to(_I32)
        take_i = take.to(_I32)
        ch_j = c["ch"].view(-1)[
            ((self.lane_ix[:, None] * n + devs) * s + samps) * self.n_prof
            + sidx[:, None]]
        st["win_met"].scatter_add_(1, devs, met_srv)
        st["win_total"].scatter_add_(1, devs, take_i)
        st["tot_met"].scatter_add_(1, devs, met_srv)
        st["tot"].scatter_add_(1, devs, take_i)
        st["correct"].scatter_add_(1, devs, take_i * ch_j)
        head.add_(torch.where(can_pop, bsz, 0))
        st["busy_until"].copy_(torch.where(can_pop, finish,
                                           st["busy_until"]))
        st["last_batch"].copy_(torch.where(can_pop, bsz, st["last_batch"]))
        st["last_done_t"].copy_(torch.where(can_pop, finish, last_done_t))
        st["max_qlen"].copy_(torch.where(
            go, torch.maximum(st["max_qlen"], qlen), st["max_qlen"]))
        st["t"].copy_(torch.where(go, t, st["t"]))
        st["n_events"].add_(go)
        st["k"].add_(go)
        # the frontier moves only here: a boundary touches no queue,
        # cursor or server timing
        st["frontier"].copy_(torch.where(go, self._next_event_t(st), t))

    def _boundary(self, go):
        """Close the window of every lane with ``go``: scheduler update,
        model switching, trace row; other lanes are left as they were."""
        st, c, sc = self.st, self.c, self.static
        valid = c["valid"]
        t_end = ((st["w"] + 1).to(_F32) * sc.window)[:, None]
        # fleet membership closed-form from the churn schedule (a join at
        # exactly t_end counts present, a leave at exactly t_end departed)
        member = (t_end >= c["join_t"]) & (t_end < c["leave_t"])
        active = (~((t_end >= c["off_start"]) & (t_end < c["off_end"]))
                  & member & valid)
        win_met, win_total = st["win_met"], st["win_total"]
        hundred = torch.full((), 100.0, dtype=_F32, device=self.device)
        sr = torch.where(win_total > 0,
                         100.0 * _ratio32(win_met, win_total.clamp(min=1)),
                         hundred)
        thresh, mult = st["thresh"], st["mult"]

        # the three schedulers, each lane keeping its own
        pp = mtpp.update({"thresh": thresh, "mult": mult}, sr,
                         mtpp.MultiTASCPPConfig(
                             a=c["a"], sr_target=c["sr_target"],
                             mult_growth=c["mult_growth"]),
                         n_active=active.sum(1, dtype=_I32), active=active)
        mtu = mt.update({"thresh": thresh}, st["last_batch"], c["b_opt"],
                        mt.MultiTASCConfig(step=c["multitasc_step"]),
                        active=active)
        code = c["scheduler"][:, None]
        thresh2 = torch.where(code == SCHED_CODES["multitasc++"], pp["thresh"],
                              torch.where(code == SCHED_CODES["multitasc"],
                                          mtu["thresh"], thresh))
        mult2 = torch.where(code == SCHED_CODES["multitasc++"], pp["mult"],
                            mult)

        sw = switching.decide(thresh2, c["tier_ids"], MAX_TIERS,
                              c["c_lower"], c["c_upper"], active=active)
        server_idx = (st["server_idx"]
                      + torch.where(c["model_switching"] != 0, sw, 0)
                      ).clamp(0, sc.n_servers - 1)

        tot = st["tot"]
        one = torch.ones((), dtype=_F32, device=self.device)
        acc_run = torch.where(tot > 0, _ratio32(st["correct"],
                                                tot.clamp(min=1)), one)
        n_real_f = c["n_real_f"]
        zero = torch.zeros((), dtype=_F32, device=self.device)
        in_mean = active & ~torch.isnan(thresh2)
        row = {
            "thresh": torch.where(in_mean, thresh2, zero).sum(1)
                      / in_mean.sum(1, dtype=_I32).to(_F32),
            "sr": torch.where(valid, sr, zero).sum(1) / n_real_f,
            "active": active.sum(1, dtype=_I32).to(_F32) / n_real_f,
            "server_idx": server_idx.to(_F32),
            "fwd": torch.where(valid, st["fwd"], 0).sum(1, dtype=_I32)
                   .to(_F32),
            "acc": torch.where(valid, acc_run, zero).sum(1) / n_real_f,
        }
        # lanes not at a boundary write their row to the trash column
        wj = torch.where(go, st["w"], sc.n_windows).long()[:, None]
        for key in TRACE_KEYS:
            self.traces[key].scatter_(1, wj, row[key][:, None])

        g2 = go[:, None]
        w2 = st["w"] + go.to(_I32)
        drained = self._drained(st)
        thresh.copy_(torch.where(g2, thresh2, thresh))
        mult.copy_(torch.where(g2, mult2, mult))
        win_met.copy_(torch.where(g2 & active, 0, win_met))
        win_total.copy_(torch.where(g2 & active, 0, win_total))
        st["server_idx"].copy_(torch.where(go, server_idx, st["server_idx"]))
        st["k"].copy_(torch.where(go, 0, st["k"]))
        # a lane leaves the loop when its duration is exhausted or every
        # real sample drained (the early exit)
        st["active"].copy_(torch.where(go, (w2 < sc.n_windows) & ~drained,
                                       st["active"]))
        st["w"].copy_(w2)

    def trip(self):
        """One loop trip over all lanes: the event of every lane with one
        due in its window, then the boundary of every lane without."""
        self._event(self._event_flags())
        self._boundary(self.st["active"] & ~self._event_flags())

    # -- the loop --------------------------------------------------------
    def run(self):
        """Trips until no lane is active, ``GRAPH_TRIPS`` between two
        reads of any(active): on the card as replays of one captured
        graph, on the CPU eagerly."""
        on_card = self.device.type == "cuda"
        with torch.inference_mode():
            while True:
                if not on_card:
                    self._trips()
                elif self.graph is None:
                    self._warm_up_and_capture()
                else:
                    self.graph.replay()
                stats.trips += GRAPH_TRIPS
                if not bool(self.st["active"].any()):
                    break

    def _trips(self):
        for _ in range(GRAPH_TRIPS):
            self.trip()

    def _warm_up_and_capture(self):
        """Run GRAPH_TRIPS trips eagerly on a side stream (they advance
        the simulation like any others), then record GRAPH_TRIPS trips as
        one CUDA graph over the buffers; recording runs nothing."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._trips()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._trips()
        self.graph = graph
        stats.graphs_captured += 1

    def metrics(self):
        st, c = self.st, self.c
        valid, n_real_f = c["valid"], c["n_real_f"]
        tot = st["tot"].clamp(min=1)
        per_acc = _ratio32(st["correct"], tot)
        tot_sum = st["tot"].sum(1, dtype=_I32)
        zero = torch.zeros((), dtype=_F32, device=self.device)
        out = {
            "sr": 100.0 * _ratio32(st["tot_met"].sum(1, dtype=_I32),
                                   tot_sum.clamp(min=1)),
            "per_device_sr": 100.0 * _ratio32(st["tot_met"], tot),
            "per_device_acc": per_acc,
            "accuracy": torch.where(valid, per_acc, zero).sum(1) / n_real_f,
            "throughput": tot_sum.to(_F32)
                          / st["last_done_t"].clamp(min=1e-9),
            "forwarded_frac": _ratio32(st["fwd"].sum(1, dtype=_I32),
                                       tot_sum.clamp(min=1)),
            "completed": tot_sum,
            "queue_left": st["tail"] - st["head"],
            "queue_peak": st["max_qlen"],
            "n_events": st["n_events"],
            "final_thresh": st["thresh"],
        }
        out = {k: v.cpu().numpy() for k, v in out.items()}
        nw = self.static.n_windows
        out["traces"] = {k: v[:, :nw].cpu().numpy()
                         for k, v in self.traces.items()}
        return out
