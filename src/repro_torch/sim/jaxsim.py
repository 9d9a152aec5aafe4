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

* The segmented frontier (``frontier_seg``; on by default from
  ``n_pad >= SEG_AUTO_MIN``) keeps a (B, n_pad / G) tensor of per-segment
  minimum completion times. An event takes each lane's lowest-index
  segment at its frontier, gathers that segment's G-wide slices at a
  per-lane base (``base[:, None] + arange(G)``, static shapes, so it
  captures into the graph like the flat step), and scatters them back.
  Ties across segments drain one segment a trip and the batch launch
  waits for the last of them, so the trajectory is the flat engine's bit
  for bit and only ``n_events`` counts the extra trips, as in the JAX
  package.

* Sharding follows PyTorch's multi-process idiom instead of one
  controller over a ``jax.sharding`` mesh: every rank of a
  ``torch.distributed`` group calls the entry point with the same full
  host arrays and a mesh from ``launch.mesh.make_sweep_mesh``, runs its
  slice on its own device, and returns the same full metric dict.
  ``run_sweep_sharded`` gives each rank B / k lanes of the ordinary
  engine (its CUDA graphs unchanged) and gathers once at the end.
  ``run_device_sharded`` splits one fleet's device axis: ``_DeviceEngine``
  exchanges what the JAX package's collectives carry between the
  ``_seg_phases`` functions, in one ``all_reduce`` an event and two where
  a window closes, each over one float64 buffer that packs its operands
  (exact for the counts, ids and float32 values it carries).

Semantics, inputs and outputs are those of the JAX ``run`` /
``run_sweep`` / ``run_sweep_sharded`` / ``run_device_sharded`` (same
names, shapes and metric dict; arrays come back as numpy). Streams are
made on the host with numpy and moved to the device once.
``lane_stepper`` hands out the engine's state and its real trip.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.cascade_tiers import BATCH_LADDER, ServerProfile
from repro_torch.core import multitasc as mt
from repro_torch.core import multitascpp as mtpp
from repro_torch.core import switching
from repro_torch.launch.mesh import (device_axis_of, lane_position,
                                     mesh_group, n_lanes)

MAX_POP = 64
N_BUCKET = 128          # device axis pads up to a multiple of this
MAX_TIERS = 4           # tier axis is padded to this fixed width
DURATION_QUANTUM = 30.0  # simulated duration rounds up to this grid (s)
SEG_AUTO_MIN = 2048      # n_pad from which frontier_seg=None segments
#                          the frontier (below it the flat engine runs)
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
    seg: int = 0                 # segmented frontier width G (0: flat)


@dataclasses.dataclass
class SweepStats:
    """Process-wide counters for benchmark accounting."""
    engines_built: int = 0     # distinct (static, B, device) state sets
    graphs_captured: int = 0   # CUDA graphs of GRAPH_TRIPS trips
    points: int = 0            # sweep points simulated
    events: int = 0            # event-loop iterations across all points
    trips: int = 0             # loop trips, each over all lanes of a run
    sharded_points: int = 0    # points run by run_sweep_sharded over > 1 lane
    device_sharded_points: int = 0  # points run by run_device_sharded
    collectives: int = 0       # all_reduce calls of the device-sharded engine
    collective_ns: int = 0     # host time inside them (staging included)


stats = SweepStats()


def stats_snapshot() -> Dict[str, int]:
    return dataclasses.asdict(stats)


def _seg_layout(n_pad: int, frontier_seg, device_shards: int = 1):
    """Resolve ``(seg, n_pad)`` for the frontier structure, by the JAX
    package's rules: ``None`` segments from ``n_pad >= SEG_AUTO_MIN`` (or
    whenever the device axis is sharded), ``False`` / ``0`` keep the flat
    engine (and raise when ``device_shards > 1``), ``True`` takes the
    automatic width (G doubles from ``N_BUCKET`` until G * G covers
    ``n_pad``), and a positive multiple of ``N_BUCKET`` forces that width.
    Segmented, ``n_pad`` rounds up so every shard holds whole segments."""
    if frontier_seg is False or (frontier_seg is not None
                                 and not isinstance(frontier_seg, bool)
                                 and int(frontier_seg) == 0):
        if device_shards > 1:
            raise ValueError(
                "device-axis sharding requires the segmented frontier "
                "(frontier_seg must not be disabled)")
        return 0, n_pad
    if frontier_seg is None and device_shards <= 1 and n_pad < SEG_AUTO_MIN:
        return 0, n_pad
    if frontier_seg is None or isinstance(frontier_seg, bool):
        g = N_BUCKET
        while g * g < n_pad:
            g *= 2
    else:
        g = int(frontier_seg)
        if g <= 0 or g % N_BUCKET:
            raise ValueError(
                f"frontier_seg must be a positive multiple of {N_BUCKET},"
                f" got {g}")
    quantum = g * max(1, device_shards)
    return g, -(-n_pad // quantum) * quantum


def _static_of(spec: JaxSimSpec, n_servers: int, max_lat: float,
               n_stream: int | None = None, lead: float = 0.0,
               has_arrive: bool = False, frontier_seg=None,
               device_shards: int = 1) -> JaxSimStatic:
    # ``lead``: pooled worst-case head start before a device's last sample
    # can begin (max of join_t + arrive[-1]); zero when saturated
    duration = max_lat * spec.samples_per_device + lead + spec.extra_time
    duration = -(-duration // DURATION_QUANTUM) * DURATION_QUANTUM
    n_pad = -(-(n_stream or spec.n_devices) // N_BUCKET) * N_BUCKET
    seg, n_pad = _seg_layout(n_pad, frontier_seg, device_shards)
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
             frontier_seg=None, device_shards=1):
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
                          arrive is not None, frontier_seg, device_shards)
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
    return _finalize(_run_lanes(static, params, srv, arrays, b, dev), b, n)


def _run_lanes(static, params, srv, arrays, b, dev):
    eng = _engine(static, b, str(dev))
    eng.load(params, srv, arrays)
    eng.run()
    return eng.metrics()


def _finalize(out, b, n):
    for k in _DEVICE_OUT_SHARDED:
        out[k] = out[k][:, :n]
    stats.points += b
    stats.events += int(out["n_events"].sum())
    return out


# the per-device outputs (the device axis split over ranks in
# run_device_sharded); every other output is one value a point
_DEVICE_OUT_SHARDED = ("per_device_sr", "per_device_acc", "final_thresh")
# the per-device inputs (sliced to each rank's devices); c_upper is a
# per-tier table, replicated
_DEVICE_IN = ("conf", "cl", "ch", "arrive", "dev_latency", "slo", "tier_ids",
              "off_start", "off_for", "join_t", "leave_t")


def _mesh_device(mesh, device):
    dev = _device(device)
    if mesh.device_type != dev.type:
        raise ValueError(f"a {mesh.device_type!r} mesh cannot run on "
                         f"device {str(dev)!r}")
    return dev


def run_sweep_sharded(specs: Union[JaxSimSpec, Sequence[JaxSimSpec]],
                      streams, dev_latency, slo,
                      servers: Sequence[ServerProfile], *, mesh=None,
                      tier_ids=None, c_upper=None, offline_start=None,
                      offline_for=None, join_t=None, leave_t=None,
                      frontier_seg=None, device="cuda"):
    """``run_sweep`` with the B axis split over the ranks of ``mesh``
    (``launch.mesh.make_sweep_mesh``).

    Every rank of the mesh calls it with the same arguments and gets the
    same result, ``run_sweep``'s bit for bit. ``mesh=None``, a one-lane
    mesh or a single point runs the local path on ``device`` (a single
    point padded to the lane count would only run the same point on every
    rank). Otherwise B pads up to a multiple of the lane count k by
    repeating point 0; each rank runs its B / k lanes through the ordinary
    engine on its own ``device`` (on the card its current CUDA device),
    with no collective per event, and the ranks gather the results once
    at the end; the padded points are dropped.
    """
    lanes = n_lanes(mesh)
    if lanes <= 1:
        return run_sweep(specs, streams, dev_latency, slo, servers,
                         tier_ids=tier_ids, c_upper=c_upper,
                         offline_start=offline_start,
                         offline_for=offline_for, join_t=join_t,
                         leave_t=leave_t, frontier_seg=frontier_seg,
                         device=device)
    dev = _mesh_device(mesh, device)
    static, params, srv, arrays, b, n = _prepare(
        specs, streams, dev_latency, slo, servers, tier_ids, c_upper,
        offline_start, offline_for, join_t, leave_t,
        frontier_seg=frontier_seg)
    if b == 1:
        return _finalize(_run_lanes(static, params, srv, arrays, b, dev),
                         b, n)
    per = -(-b // lanes)
    lo = lane_position(mesh) * per
    rows = np.arange(lo, lo + per)
    rows = np.where(rows < b, rows, 0)          # the pads repeat point 0
    out = _run_lanes(static, {k: v[rows] for k, v in params.items()}, srv,
                     {k: v[rows] for k, v in arrays.items()}, per, dev)
    parts = [None] * dist.get_world_size(mesh_group(mesh))
    dist.all_gather_object(parts, (lo, out), group=mesh_group(mesh))
    parts = [o for _, o in sorted(parts, key=lambda p: p[0])]
    out = {k: np.concatenate([o[k] for o in parts])[:b]
           for k in out if k != "traces"}
    out["traces"] = {k: np.concatenate([o["traces"][k] for o in parts])[:b]
                     for k in parts[0]["traces"]}
    stats.sharded_points += b
    return _finalize(out, b, n)


def run_device_sharded(spec: JaxSimSpec, streams, dev_latency, slo,
                       servers: Sequence[ServerProfile], *, mesh=None,
                       tier_ids=None, c_upper=None, offline_start=None,
                       offline_for=None, join_t=None, leave_t=None,
                       frontier_seg=None, device="cuda"):
    """One sweep point with its DEVICE axis split over the ranks of a
    one-axis ``mesh`` (``launch.mesh.make_sweep_mesh((k,))``).

    Every rank calls it with the same arguments. Each holds ``n_pad / k``
    devices' state, streams and segment minima on its own ``device``;
    queue, server, time and window state are replicated, and every rank
    applies the same update to them (``_DeviceEngine``). Requires the
    segmented frontier (``frontier_seg=False`` raises ``ValueError``);
    B = 1 only. ``mesh=None`` or a one-lane mesh runs the local segmented
    ``run``.

    Returns ``run``'s metric dict, the same on every rank. Fleet dynamics
    and ``n_events`` equal the local segmented engine's bit for bit; the
    aggregates that sum floats over the ranks' partial sums (``accuracy``
    and the traces' ``thresh``, ``sr``, ``acc``) may differ in the last
    ulp.
    """
    if not isinstance(spec, JaxSimSpec):
        raise ValueError("run_device_sharded takes a single JaxSimSpec "
                         "(B=1); use run_sweep_sharded for sweeps")
    k = n_lanes(mesh)
    if mesh is None or k <= 1:
        return run(spec, streams, dev_latency, slo, servers,
                   tier_ids=tier_ids, c_upper=c_upper,
                   offline_start=offline_start, offline_for=offline_for,
                   join_t=join_t, leave_t=leave_t,
                   frontier_seg=True if frontier_seg is None
                   else frontier_seg, device=device)
    axis = device_axis_of(mesh)
    static, params, srv, arrays, b, n = _prepare(
        [spec], streams, dev_latency, slo, servers, tier_ids, c_upper,
        offline_start, offline_for, join_t, leave_t,
        frontier_seg=frontier_seg, device_shards=k)
    if b != 1:
        raise ValueError("run_device_sharded runs one sweep point (B=1); "
                         f"got a stream batch of {b}")
    dev = _mesh_device(mesh, device)
    pos = lane_position(mesh)
    eng = _DeviceEngine(static, k, pos, mesh.get_group(axis), dev)
    sl = slice(eng.dev_base, eng.dev_base + eng.static.n_pad)
    eng.load(params, srv, {key: v[:, sl] if key in _DEVICE_IN else v
                           for key, v in arrays.items()})
    eng.run()
    out = eng.metrics()
    for key in _DEVICE_OUT_SHARDED:
        out[key] = out[key][:n]
    stats.points += 1
    stats.events += int(out["n_events"])
    stats.device_sharded_points += 1
    return out


def lane_stepper(specs, streams, dev_latency, slo,
                 servers: Sequence[ServerProfile], *, tier_ids=None,
                 c_upper=None, offline_start=None, offline_for=None,
                 join_t=None, leave_t=None, device="cuda"):
    """Debug and test hook: the engine's initial state and a one-trip
    ``step``, the engine's own ``trip`` (not a mirror of it), on
    ``device``. Not a performance path.

    Arguments are ``run_sweep``'s. Returns ``(state, step, static)``:
    ``state`` is a dict of (B, ...) tensors, the JAX package's carry
    (``traces`` a dict of (B, n_windows) rows; the rings (B, cap); no
    trash slots), ``step`` maps a state to the state one trip later
    (leaving its argument as it was), and ``static`` is the structure key.
    ``state["active"].any()`` is the loop's condition.
    """
    dev = _device(device)
    static, params, srv, arrays, b, _ = _prepare(
        specs, streams, dev_latency, slo, servers, tier_ids, c_upper,
        offline_start, offline_for, join_t, leave_t)
    eng = _Engine(static, b, dev)
    eng.load(params, srv, arrays)

    def step(state):
        eng.set_state(state)
        with torch.inference_mode():
            eng.trip()
        return eng.state()

    return eng.state(), step, static


def _ratio32(num, den):
    return num.to(_F32) / den.to(_F32)


def _fma32(x, y, z):
    """float32 x * y + z rounded once, as XLA's fused multiply-add on the
    CPU gives it: the float64 product of two float32 values is exact."""
    return (x.double() * y.double() + z.double()).float()


def _seg_phases(static: JaxSimStatic, device: torch.device):
    """The segment-event arithmetic of the JAX package's ``_seg_phases``,
    on (B, ...) tensors. The segmented event step runs them in order; a
    device-sharded engine would splice its exchange between them, so they
    stay three functions:

    * ``completion(dev, t, base, gbase, has_due)``: every device
      completion at instant ``t`` (B,) of the G-wide segment starting at
      ``base`` (B,) of the arrays in ``dev`` ((B, n) per-device state and
      constants, (B, n * S) flat stream views); ``gbase`` is its global
      device-id base. Returns ``(seg_upd, append, seg_min_new,
      comp_any)``: (B, G) slices to write back at ``base``, the (B, G)
      ring append (``fwd`` a mask), the segment's new minimum and whether
      a completion stayed local. A lane without ``has_due`` computes its
      slices unchanged and appends nothing.
    * ``apply_append(q_start, q_dev, q_samp, tail, append)``: the ring
      writes, in place. A row that does not forward aims at the spare
      slot ``cap`` (rings are (B, cap + 1)), so no two real writes share
      an index; the tail moves by the rows that forward.
    * ``pop_calc(t, q_start, q_dev, q_samp, head, server_idx, srv, qlen,
      can_pop)``: the ladder batch assembled from the ring's head; returns
      the (B, MAX_POP) ``take`` mask, device ids and samples, the batch
      size ``b`` and the (B,) ``finish`` and (B, MAX_POP) ``latency``.
    """
    G, s, cap = static.seg, static.samples_per_device, static.cap
    seg_ix = torch.arange(G, device=device)
    pop_ix = torch.arange(MAX_POP, device=device)
    ladder = torch.tensor(BATCH_LADDER, device=device)
    one = torch.ones((), dtype=_F32, device=device)
    inf = torch.full((), float("inf"), dtype=_F32, device=device)

    def completion(dev, t, base, gbase, has_due):
        idx = base[:, None] + seg_ix

        def dsl(a):
            return torch.gather(a, 1, idx)

        dn, cur, th = dsl(dev["dev_next"]), dsl(dev["cursor"]), \
            dsl(dev["thresh"])
        lat, slo = dsl(dev["dev_latency"]), dsl(dev["slo"])
        offs, offf = dsl(dev["off_start"]), dsl(dev["off_for"])
        due = (dn <= t[:, None]) & (cur < s) & has_due[:, None]
        departs = due & (dn >= dsl(dev["leave_t"]))
        done = due & ~departs
        cj = cur.clamp(0, s - 1)
        flat_ix = idx * s + cj
        local = torch.gather(dev["conf_flat"], 1, flat_ix) >= th  # Eq. 3
        comp_local = done & local
        met = comp_local & (lat <= slo)
        fwd_mask = done & ~local
        cursor2 = torch.where(departs, s, cur + done)
        if static.has_arrive:
            arrive_next = torch.gather(dev["arrive_flat"], 1,
                                       idx * s + cursor2.clamp(0, s - 1))
            start_next = torch.maximum(dn, arrive_next)
        else:
            start_next = dn
        off_end = offs + offf
        t_c = start_next + lat
        t_c = torch.where((t_c >= offs) & (t_c < off_end), off_end, t_c)
        dn2 = torch.where(departs, inf, torch.where(done, t_c, dn))
        seg_upd = {
            "dev_next": dn2, "cursor": cursor2,
            "win_met": dsl(dev["win_met"]) + met,
            "win_total": dsl(dev["win_total"]) + comp_local,
            "tot_met": dsl(dev["tot_met"]) + met,
            "tot": dsl(dev["tot"]) + comp_local,
            "correct": dsl(dev["correct"])
                       + comp_local * torch.gather(dev["cl_flat"], 1, flat_ix),
            "fwd": dsl(dev["fwd"]) + fwd_mask,
        }
        append = {"start": dn - lat, "dev": gbase[:, None] + seg_ix,
                  "samp": cj, "fwd": fwd_mask}
        seg_min_new = torch.where(cursor2 < s, dn2, inf).amin(1)
        return seg_upd, append, seg_min_new, comp_local.any(1)

    def apply_append(q_start, q_dev, q_samp, tail, append):
        fwd = append["fwd"]
        pos = tail[:, None] + torch.cumsum(fwd, 1) - 1
        posm = torch.where(fwd, torch.remainder(pos, cap), cap)
        q_start.scatter_(1, posm, append["start"])
        q_dev.scatter_(1, posm, append["dev"])
        q_samp.scatter_(1, posm, append["samp"])
        tail.add_(fwd.sum(1, dtype=_I32))

    def pop_calc(t, q_start, q_dev, q_samp, head, server_idx, srv, qlen,
                 can_pop):
        braw = torch.minimum(qlen, srv["max_batch"][server_idx])
        b = torch.where(ladder <= braw[:, None], ladder, 1).amax(1)
        take = (pop_ix < b[:, None]) & can_pop[:, None]
        qidx = torch.remainder(head[:, None] + pop_ix, cap)
        starts = torch.gather(q_start, 1, qidx)
        devs = torch.where(take, torch.gather(q_dev, 1, qidx), 0)
        samps = torch.gather(q_samp, 1, qidx)
        # finish = t + base * (1 + scaling * (b - 1)): XLA contracts both
        # multiply-adds, so each rounds once
        finish = _fma32(srv["base_lat"][server_idx],
                        _fma32(srv["scaling"][server_idx], b - 1, one), t)
        return {"take": take, "devs": devs, "samps": samps, "b": b,
                "finish": finish, "latency": finish[:, None] - starts}

    return completion, apply_append, pop_calc


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
    captured over them serves every later run of the same structure.
    ``dev_base`` is the global id of the engine's first device (nonzero
    only in a rank of the device-sharded engine)."""

    dev_base = 0

    def __init__(self, static: JaxSimStatic, b: int, device: torch.device):
        self.static, self.b, self.device = static, b, device
        self.graph = None
        n, cap, nw = static.n_pad, static.cap, static.n_windows
        kw = dict(device=device)
        self.lane_ix = torch.arange(b, dtype=torch.int64, **kw)
        self.dev_ix = torch.arange(n, **kw)
        self.completion, self.apply_append, self.pop_calc = _seg_phases(
            static, device)
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
        if static.seg:
            # per-segment minimum of (cursor < S ? dev_next : inf), the
            # invariant the segmented event step keeps
            self.st["seg_min"] = zf(b, n // static.seg)
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
        new["valid"] = (self.dev_base + self.dev_ix)[None, :] \
            < new["n_real"][:, None]
        new["n_real_f"] = new["n_real"].to(_F32)
        self.n_prof = new["ch"].shape[-1]
        if self.c is not None and all(new[k].shape == v.shape
                                      for k, v in self.c.items()):
            for k, v in new.items():
                self.c[k].copy_(v)
        else:   # the first run, or heavy columns other than the last's
            self.c, self.graph = new, None
        self.srv = {k: self.c[f"srv_{k}"] for k in srv}
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
        if self.static.seg:
            st["seg_min"].copy_(self._pending(st).view(
                self.b, -1, self.static.seg).amin(2))
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

    def _pending(self, st):
        # each device's next completion; finished devices sit at +inf
        inf = torch.full((), float("inf"), dtype=_F32, device=self.device)
        return torch.where(st["cursor"] < self.static.samples_per_device,
                           st["dev_next"], inf)

    def _next_event_t(self, st):
        # next device completion (segmented: the minimum of the segment
        # minima), or the server while a batch is in flight with samples
        # waiting behind it. Segmented, a free server over a non-empty
        # queue is also due at the current instant: a tie's segments
        # drain one a trip before the launch
        inf = torch.full((), float("inf"), dtype=_F32, device=self.device)
        t_dev = (st["seg_min"] if self.static.seg
                 else self._pending(st)).amin(1)
        qlen = st["tail"] - st["head"]
        t_srv = torch.where((st["busy_until"] > st["t"]) & (qlen > 0),
                            st["busy_until"], inf)
        if self.static.seg:
            t_srv = torch.where((st["busy_until"] <= st["t"]) & (qlen > 0),
                                st["t"], t_srv)
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
        s, n = sc.samples_per_device, sc.n_pad
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
        self.apply_append(st["q_start"], st["q_dev"], st["q_samp"],
                          st["tail"], {"start": dev_next - c["dev_latency"],
                                       "dev": self.dev_ix.expand(self.b, n),
                                       "samp": cj[..., 0], "fwd": fwd_mask})

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
        qlen = st["tail"] - st["head"]
        can_pop = (t >= st["busy_until"]) & (qlen > 0) & go
        self._launch(t, go, qlen, can_pop, last_done_t)

    def _event_seg(self, go):
        """The segmented event step: every lane with ``go`` processes the
        completions of its lowest-index segment whose minimum is the
        frontier, and launches a batch only once no segment holds a
        completion at that instant (``t_dev > t``), so a tie across
        segments enqueues in device order before the ladder sizes the
        batch. Lanes without ``go`` are left bitwise as they were."""
        st, c, G = self.st, self.c, self.static.seg
        t, seg_min = st["frontier"], st["seg_min"]
        sidx = seg_min.argmin(1)        # the first segment at the minimum
        m = torch.gather(seg_min, 1, sidx[:, None])[:, 0]
        has_due = go & (m <= t)
        base = sidx * G
        dev = {k: st[k] for k in ("dev_next", "cursor", "thresh", "win_met",
                                  "win_total", "tot_met", "tot", "correct",
                                  "fwd")}
        dev.update({k: c[k] for k in ("dev_latency", "slo", "leave_t",
                                      "off_start", "off_for")})
        dev.update(conf_flat=c["conf"].view(self.b, -1),
                   cl_flat=c["cl"].view(self.b, -1),
                   arrive_flat=c["arrive"].view(self.b, -1))
        seg_upd, append, seg_min_new, comp_any = self.completion(
            dev, t, base, base, has_due)
        idx = base[:, None] + self.dev_ix[:G]
        for key, upd in seg_upd.items():
            st[key].scatter_(1, idx, upd)
        seg_min.scatter_(1, sidx[:, None],
                         torch.where(has_due, seg_min_new, m)[:, None])
        t_dev = seg_min.amin(1)
        self.apply_append(st["q_start"], st["q_dev"], st["q_samp"],
                          st["tail"], append)
        last_done_t = torch.where(comp_any, t, st["last_done_t"])
        qlen = st["tail"] - st["head"]
        can_pop = go & (t >= st["busy_until"]) & (qlen > 0) & (t_dev > t)
        self._launch(t, go, qlen, can_pop, last_done_t)

    def _launch(self, t, go, qlen, can_pop, last_done_t):
        """The event's server half, shared by both event steps: pop the
        ladder batch of every lane with ``can_pop`` and credit it at its
        launch, then close the event of every lane with ``go``."""
        st, c, sc = self.st, self.c, self.static
        s, n = sc.samples_per_device, sc.n_pad
        sidx = st["server_idx"]
        p = self.pop_calc(t, st["q_start"], st["q_dev"], st["q_samp"],
                          st["head"], sidx, self.srv, qlen, can_pop)
        devs, take = p["devs"], p["take"]
        met_srv = ((p["latency"] <= torch.gather(c["slo"], 1, devs))
                   & take).to(_I32)
        take_i = take.to(_I32)
        ch_j = c["ch"].view(-1)[
            ((self.lane_ix[:, None] * n + devs) * s + p["samps"])
            * self.n_prof + sidx[:, None]]
        st["win_met"].scatter_add_(1, devs, met_srv)
        st["win_total"].scatter_add_(1, devs, take_i)
        st["tot_met"].scatter_add_(1, devs, met_srv)
        st["tot"].scatter_add_(1, devs, take_i)
        st["correct"].scatter_add_(1, devs, take_i * ch_j)
        st["head"].add_(torch.where(can_pop, p["b"], 0))
        st["busy_until"].copy_(torch.where(can_pop, p["finish"],
                                           st["busy_until"]))
        st["last_batch"].copy_(torch.where(can_pop, p["b"],
                                           st["last_batch"]))
        st["last_done_t"].copy_(torch.where(can_pop, p["finish"],
                                            last_done_t))
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
        (self._event_seg if self.static.seg else self._event)(
            self._event_flags())
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

    # -- lane_stepper's view of the carry ----------------------------------
    def _views(self):
        cap, nw = self.static.cap, self.static.n_windows
        out = {k: v[:, :cap] if k in ("q_start", "q_dev", "q_samp") else v
               for k, v in self.st.items()}
        out["traces"] = {k: v[:, :nw] for k, v in self.traces.items()}
        return out

    def state(self):
        """A copy of the carry as the JAX package lays it out: the rings
        without their spare slot, the traces without their trash column."""
        views = self._views()
        out = {k: v.clone() for k, v in views.items() if k != "traces"}
        out["traces"] = {k: v.clone() for k, v in views["traces"].items()}
        return out

    def set_state(self, state):
        """Load a carry laid out as ``state`` returns it."""
        views = self._views()
        for k, v in views.items():
            if k != "traces":
                v.copy_(state[k])
        for k, v in views["traces"].items():
            v.copy_(state["traces"][k])

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
        # copies: on the CPU .numpy() would alias the engine's buffers,
        # which the next run of the same structure overwrites
        out = {k: np.array(v.cpu()) for k, v in out.items()}
        nw = self.static.n_windows
        out["traces"] = {k: np.array(v[:, :nw].cpu())
                         for k, v in self.traces.items()}
        return out


class _DeviceEngine(_Engine):
    """One rank's slice of the device-sharded event loop (B = 1): the JAX
    package's ``_device_engine`` and ``_run_core_device``.

    The rank holds ``n_pad / k`` devices' state, streams and segment
    minima (``static`` here is that slice's; ring capacity, window count
    and event cap stay the fleet's). Queue, server, time and window state
    are replicated, and every rank applies the same update to them. The
    event's arithmetic is ``_seg_phases``, the local segmented engine's
    own; the exchange between its phases carries what JAX's collectives
    carry, in fewer rounds:

    * JAX's ``pmin`` of the local best segment minimum, its ``pmin`` of
      the owner candidate, its ``pmin`` of the new minimum and its
      ``psum`` of the owner's append buffer become ONE all_reduce MIN per
      event: every rank fills its own slot of k with its segment minimum
      and, if it owns the event's segment, the append rows and whether a
      completion stayed local; the other ranks fill +inf, so the minimum
      is every rank's minimum and the owner's rows exactly. The k minima
      give the new frontier minimum, and also the next event's owner: the
      first rank at the minimum, at its own first segment there, which is
      the lowest global segment, as the local ``argmin`` over the
      concatenated minima (no trip changes the minima between two
      events).
    * JAX's ``psum`` of the popped entries' SLO and heavy correctness is
      not needed: only the rank that holds a popped device moves its
      counters, and it reads both locally.
    * The boundary's two rounds of partial sums (the active count, SR,
      forwarded, accuracy and undrained devices; then
      ``switching.decide_partials`` and the threshold sum, which
      ``decide_from_partials`` turns into S(C)) are two all_reduce SUMs,
      issued only on the trips where the window closes. Whether it closes
      is replicated state, the same on every rank, so every rank issues
      the same collectives in the same order.
    * At the end, the metrics' sums in one all_reduce SUM, and the
      per-device outputs gathered.

    Each all_reduce packs its operands in one float64 buffer: exact for
    the counts, ids and float32 values it carries. Everything fed back
    into state is an integer sum, a minimum or an owner's value, so the
    dynamics equal the local engine's bit for bit; only the reported
    float sums over ranks (``accuracy``, the traces' ``thresh``, ``sr``,
    ``acc``) take the reduction's order.

    A collective of a backend that stages through the host cannot sit
    inside a CUDA graph, so on the card the event runs as two captured
    pieces around its all_reduce (``_event_pre``, ``_event_post``; what
    crosses lives in fixed buffers), and the rare boundary eagerly.
    """

    def __init__(self, static: JaxSimStatic, k: int, pos: int, group,
                 device: torch.device):
        n_loc = static.n_pad // k
        super().__init__(dataclasses.replace(static, n_pad=n_loc), 1, device)
        self.k, self.pos, self.group = k, pos, group
        self.dev_base = pos * n_loc
        self.rank_ix = torch.arange(k, device=device)
        G = static.seg
        # what crosses a collective lives in fixed buffers, so the pieces
        # between collectives can be captured as CUDA graphs: the packed
        # exchange (k minima, the owner's start / dev / samp / fwd rows and
        # whether a completion stayed local), the gathered minima, and
        # whether the window closes
        self.xsplit = [k, G, G, G, G, 1]
        self.xbuf = torch.zeros(sum(self.xsplit), dtype=torch.float64,
                                device=device)
        self.best = torch.zeros(k, dtype=_F32, device=device)
        self.go_b = torch.zeros(1, dtype=torch.bool, device=device)
        self.pieces = None
        stats.engines_built += 1

    # -- collectives -------------------------------------------------------
    def _all_reduce(self, buf, op):
        t0 = time.perf_counter_ns()
        dist.all_reduce(buf, op=op, group=self.group)
        stats.collective_ns += time.perf_counter_ns() - t0
        stats.collectives += 1

    def _psum(self, *parts):
        """One all_reduce SUM over the ranks of ``parts``, packed in one
        float64 buffer; returns them summed, in their own dtypes."""
        flat = torch.cat([p.reshape(-1).double() for p in parts])
        self._all_reduce(flat, dist.ReduceOp.SUM)
        return [o.view(p.shape).to(p.dtype) for o, p in
                zip(flat.split([p.numel() for p in parts]), parts)]

    def _pack(self, mine, start, dev, samp, fwd, comp_any):
        """Fill ``xbuf`` for the event's all_reduce MIN: this rank's
        segment minimum in its own slot of k (+inf in the others), and the
        owned rows where ``mine`` holds (+inf on every other rank)."""
        inf = torch.full((), float("inf"), dtype=torch.float64,
                         device=self.device)
        own = self.rank_ix == self.pos
        parts = [torch.where(own, self.st["seg_min"].amin(1).double(), inf)]
        parts += [torch.where(mine, x.double(), inf).reshape(-1)
                  for x in (start, dev, samp, fwd, comp_any)]
        torch.cat(parts, out=self.xbuf)

    def _unpack(self):
        """The reduced ``xbuf``: sets ``best`` (every rank's segment
        minimum) and returns the owner's rows in their dtypes."""
        best, start, dev, samp, fwd, comp_any = self.xbuf.split(self.xsplit)
        self.best.copy_(best)
        return (start.float()[None], dev.long()[None], samp.long()[None],
                fwd.bool()[None], comp_any.bool())

    def _undrained(self, st):
        s = self.static.samples_per_device
        return (~((st["cursor"] >= s) | ~self.c["valid"]).all(1)).to(_I32)

    # -- engine pieces -----------------------------------------------------
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
        st["seg_min"].copy_(self._pending(st).view(
            1, -1, self.static.seg).amin(2))
        st["server_idx"].copy_(c["server_init"])
        # the queue is empty at t = 0: the frontier is the fleet's minimum
        G = self.static.seg
        none = torch.zeros((), dtype=torch.bool, device=self.device)
        self._pack(none, *(torch.zeros(1, G, dtype=_F32,
                                       device=self.device),) * 4,
                   none[None])
        self._all_reduce(self.xbuf, dist.ReduceOp.MIN)
        self._unpack()
        st["frontier"].fill_(0.0).add_(self.best.amin())
        (undrained,) = self._psum(self._undrained(st))
        st["active"].copy_((undrained > 0) & (self.static.n_windows > 0))

    def _event_pre(self):
        """The event up to its exchange: the owner's segment completions,
        its segment minimum, and the packed exchange buffer."""
        st, c, G = self.st, self.c, self.static.seg
        go = self._event_flags()
        t, seg_min = st["frontier"], st["seg_min"]
        # the owner: the first rank at the fleet's minimum, at its first
        # segment there
        t_dev0 = self.best.amin()
        mine = self.best.argmin() == self.pos
        has_due = go & (t_dev0 <= t) & mine
        widx = torch.where(mine, seg_min.argmin(1), 0)
        base = widx * G
        dev = {k: st[k] for k in ("dev_next", "cursor", "thresh", "win_met",
                                  "win_total", "tot_met", "tot", "correct",
                                  "fwd")}
        dev.update({k: c[k] for k in ("dev_latency", "slo", "leave_t",
                                      "off_start", "off_for")})
        dev.update(conf_flat=c["conf"].view(1, -1),
                   cl_flat=c["cl"].view(1, -1),
                   arrive_flat=c["arrive"].view(1, -1))
        seg_upd, append, seg_min_new, comp_any = self.completion(
            dev, t, base, self.dev_base + base, has_due)
        idx = base[:, None] + self.dev_ix[:G]
        for key, upd in seg_upd.items():
            st[key].scatter_(1, idx, upd)
        m = torch.gather(seg_min, 1, widx[:, None])[:, 0]
        seg_min.scatter_(1, widx[:, None],
                         torch.where(has_due, seg_min_new, m)[:, None])
        fwd = append["fwd"]
        self._pack(mine, torch.where(fwd, append["start"], 0.0),
                   append["dev"], append["samp"], fwd, comp_any)

    def _event_post(self):
        """The event after its exchange: the owner's append on every
        rank's ring, the launch, the new frontier; then whether the
        window closes (``go_b``)."""
        st = self.st
        go = self._event_flags()
        t = st["frontier"]
        start, devs, samp, fwd, comp_any = self._unpack()
        t_dev = self.best.amin()
        self.apply_append(st["q_start"], st["q_dev"], st["q_samp"],
                          st["tail"], {"start": start, "dev": devs,
                                       "samp": samp, "fwd": fwd})
        last_done_t = torch.where(comp_any, t, st["last_done_t"])
        qlen = st["tail"] - st["head"]
        can_pop = go & (t >= st["busy_until"]) & (qlen > 0) & (t_dev > t)
        self._launch_dev(t, go, qlen, can_pop, last_done_t, t_dev)
        self.go_b.copy_(st["active"] & ~self._event_flags())

    def _launch_dev(self, t, go, qlen, can_pop, last_done_t, t_dev):
        """``_launch`` for a slice of the fleet: a popped device's SLO,
        heavy correctness and counters live on the rank that holds it."""
        st, c, sc = self.st, self.c, self.static
        s, n_loc = sc.samples_per_device, sc.n_pad
        sidx = st["server_idx"]
        p = self.pop_calc(t, st["q_start"], st["q_dev"], st["q_samp"],
                          st["head"], sidx, self.srv, qlen, can_pop)
        ldev = p["devs"] - self.dev_base
        mine = (ldev >= 0) & (ldev < n_loc) & p["take"]
        lclip = ldev.clamp(0, n_loc - 1)
        met_i = ((p["latency"] <= torch.gather(c["slo"], 1, lclip))
                 & mine).to(_I32)
        take_i = mine.to(_I32)
        ch_j = c["ch"].view(-1)[(lclip * s + p["samps"]) * self.n_prof
                                + sidx[:, None]]
        st["win_met"].scatter_add_(1, lclip, met_i)
        st["win_total"].scatter_add_(1, lclip, take_i)
        st["tot_met"].scatter_add_(1, lclip, met_i)
        st["tot"].scatter_add_(1, lclip, take_i)
        st["correct"].scatter_add_(1, lclip, take_i * ch_j)
        st["head"].add_(torch.where(can_pop, p["b"], 0))
        st["busy_until"].copy_(torch.where(can_pop, p["finish"],
                                           st["busy_until"]))
        st["last_batch"].copy_(torch.where(can_pop, p["b"],
                                           st["last_batch"]))
        st["last_done_t"].copy_(torch.where(can_pop, p["finish"],
                                            last_done_t))
        st["max_qlen"].copy_(torch.where(
            go, torch.maximum(st["max_qlen"], qlen), st["max_qlen"]))
        st["t"].copy_(torch.where(go, t, st["t"]))
        st["n_events"].add_(go)
        st["k"].add_(go)
        qlen2 = st["tail"] - st["head"]
        busy = st["busy_until"]
        t_srv = torch.where(qlen2 > 0, torch.where(busy > t, busy, t),
                            float("inf"))
        st["frontier"].copy_(torch.where(go, torch.minimum(t_dev, t_srv), t))

    def _boundary_dev(self, go):
        """Close the window (``go``, replicated) of a slice of the fleet,
        with its two rounds of partial sums: the active count feeds the
        threshold update, whose thresholds feed the switching counts."""
        st, c, sc = self.st, self.c, self.static
        valid = c["valid"]
        t_end = ((st["w"] + 1).to(_F32) * sc.window)[:, None]
        member = (t_end >= c["join_t"]) & (t_end < c["leave_t"])
        active = (~((t_end >= c["off_start"]) & (t_end < c["off_end"]))
                  & member & valid)
        win_met, win_total = st["win_met"], st["win_total"]
        hundred = torch.full((), 100.0, dtype=_F32, device=self.device)
        sr = torch.where(win_total > 0,
                         100.0 * _ratio32(win_met, win_total.clamp(min=1)),
                         hundred)
        tot = st["tot"]
        one = torch.ones((), dtype=_F32, device=self.device)
        acc_run = torch.where(tot > 0, _ratio32(st["correct"],
                                                tot.clamp(min=1)), one)
        zero = torch.zeros((), dtype=_F32, device=self.device)
        n_active, sr_sum, fwd_sum, acc_sum, undrained = self._psum(
            active.sum(1, dtype=_I32), torch.where(valid, sr, zero).sum(1),
            torch.where(valid, st["fwd"], 0).sum(1, dtype=_I32),
            torch.where(valid, acc_run, zero).sum(1), self._undrained(st))

        thresh, mult = st["thresh"], st["mult"]
        pp = mtpp.update({"thresh": thresh, "mult": mult}, sr,
                         mtpp.MultiTASCPPConfig(
                             a=c["a"], sr_target=c["sr_target"],
                             mult_growth=c["mult_growth"]),
                         n_active=n_active, active=active)
        mtu = mt.update({"thresh": thresh}, st["last_batch"], c["b_opt"],
                        mt.MultiTASCConfig(step=c["multitasc_step"]),
                        active=active)
        code = c["scheduler"][:, None]
        thresh2 = torch.where(code == SCHED_CODES["multitasc++"], pp["thresh"],
                              torch.where(code == SCHED_CODES["multitasc"],
                                          mtu["thresh"], thresh))
        mult2 = torch.where(code == SCHED_CODES["multitasc++"], pp["mult"],
                            mult)
        part = switching.decide_partials(thresh2, c["tier_ids"], MAX_TIERS,
                                         c["c_lower"], c["c_upper"],
                                         active=active)
        *summed, thresh_sum = self._psum(
            *part.values(), torch.where(active, thresh2, zero).sum(1))
        sw = switching.decide_from_partials(dict(zip(part, summed)))
        server_idx = (st["server_idx"]
                      + torch.where(c["model_switching"] != 0, sw, 0)
                      ).clamp(0, sc.n_servers - 1)

        n_real_f, n_act_f = c["n_real_f"], n_active.to(_F32)
        nan = torch.full((), float("nan"), dtype=_F32, device=self.device)
        row = {
            "thresh": torch.where(n_active > 0,
                                  thresh_sum / n_act_f.clamp(min=1.0), nan),
            "sr": sr_sum / n_real_f,
            "active": n_act_f / n_real_f,
            "server_idx": server_idx.to(_F32),
            "fwd": fwd_sum.to(_F32),
            "acc": acc_sum / n_real_f,
        }
        wj = torch.where(go, st["w"], sc.n_windows).long()[:, None]
        for key in TRACE_KEYS:
            self.traces[key].scatter_(1, wj, row[key][:, None])

        g2 = go[:, None]
        w2 = st["w"] + go.to(_I32)
        drained = (st["tail"] == st["head"]) & (undrained == 0)
        thresh.copy_(torch.where(g2, thresh2, thresh))
        mult.copy_(torch.where(g2, mult2, mult))
        win_met.copy_(torch.where(g2 & active, 0, win_met))
        win_total.copy_(torch.where(g2 & active, 0, win_total))
        st["server_idx"].copy_(torch.where(go, server_idx, st["server_idx"]))
        st["k"].copy_(torch.where(go, 0, st["k"]))
        st["active"].copy_(torch.where(go, (w2 < sc.n_windows) & ~drained,
                                       st["active"]))
        st["w"].copy_(w2)

    def trip(self):
        """One trip: the event (its two pieces captured once on the card)
        around its all_reduce, then, if the window closes, the boundary,
        eagerly. ``go_b`` is replicated, so every rank takes the same
        branch and issues the same collectives."""
        if self.pieces:
            self.pieces[0].replay()
        else:
            self._event_pre()
        self._all_reduce(self.xbuf, dist.ReduceOp.MIN)
        if self.pieces:
            self.pieces[1].replay()
        else:
            self._event_post()
        if bool(self.go_b):
            self._boundary_dev(self.go_b)

    def run(self):
        """Trips until the fleet is inactive, ``GRAPH_TRIPS`` between two
        reads of the replicated ``active``. On the card (with ``CAPTURE``)
        the first ``GRAPH_TRIPS`` trips run eagerly and the event's two
        pieces are then captured as CUDA graphs, on every rank at the same
        trip; the CPU runs every trip eagerly."""
        capture = self.CAPTURE and self.device.type == "cuda"
        with torch.inference_mode():
            while True:
                self._trips()
                stats.trips += GRAPH_TRIPS
                if capture and self.pieces is None:
                    self.pieces = (self._capture(self._event_pre),
                                   self._capture(self._event_post))
                    stats.graphs_captured += 2
                if not bool(self.st["active"].any()):
                    break

    # timing tools may set this False to run the card's trips eagerly
    CAPTURE = True

    @staticmethod
    def _capture(fn):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return graph

    def metrics(self):
        """``run``'s metric dict for the whole fleet, on every rank: sums
        over the ranks, the per-device outputs gathered in device order."""
        st, c = self.st, self.c
        per_acc = _ratio32(st["correct"], st["tot"].clamp(min=1))
        zero = torch.zeros((), dtype=_F32, device=self.device)
        tot, tot_met, fwd, acc = self._psum(
            st["tot"].sum(1, dtype=_I32), st["tot_met"].sum(1, dtype=_I32),
            st["fwd"].sum(1, dtype=_I32),
            torch.where(c["valid"], per_acc, zero).sum(1))
        local = {
            "per_device_sr": 100.0 * _ratio32(st["tot_met"],
                                              st["tot"].clamp(min=1)),
            "per_device_acc": per_acc,
            "final_thresh": st["thresh"],
        }
        parts = [None] * self.k
        dist.all_gather_object(
            parts, (self.pos, {k: v[0].cpu().numpy()
                               for k, v in local.items()}),
            group=self.group)
        parts = [o for _, o in sorted(parts, key=lambda p: p[0])]
        out = {
            "sr": 100.0 * _ratio32(tot_met, tot.clamp(min=1)),
            "accuracy": acc / c["n_real_f"],
            "throughput": tot.to(_F32) / st["last_done_t"].clamp(min=1e-9),
            "forwarded_frac": _ratio32(fwd, tot.clamp(min=1)),
            "completed": tot,
            "queue_left": st["tail"] - st["head"],
            "queue_peak": st["max_qlen"],
            "n_events": st["n_events"],
        }
        out = {k: v.cpu().numpy()[0] for k, v in out.items()}
        out.update({k: np.concatenate([o[k] for o in parts])
                    for k in local})
        nw = self.static.n_windows
        out["traces"] = {k: np.array(v[0, :nw].cpu())
                         for k, v in self.traces.items()}
        return out
