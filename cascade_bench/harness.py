"""One run of one cell: set-up, the measured window, the trace slice, the
comparison with the reference, and the result line.

The window drives the program's ``serving.transport.run_transport`` over a
``ServerEngine`` (``fleet.TimedEngine``) that hosts the configuration's
model as its one ``ServedModel``, under the traffic's server profile, its
scheduler and its fleet of stream devices. The virtual clock decides which
batches form; the host clock times how long the card takes to serve them.
The cascade runs on a stand-in for the model until its virtual clock
reaches the traffic's ``window_opens_at_s``, the operating point its
scheduler has settled at; that prelude is set-up. The window opens there
and closes ``seconds`` later: the next ``execute`` raises and the cascade
is cut, not drained. A traced run then serves a slice of
``SLICE_BATCHES`` more batches alone under the profiler, so the window's
wall-clock numbers come from untraced batches.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.cascade_tiers import ServerProfile
from repro_torch.models.model import build_model
from repro_torch.serving import executables
from repro_torch.serving.engine import ServedModel
from repro_torch.serving.transport import run_transport
from repro_torch.sim.events import make_scheduler

from . import catalog, check, counts, reference, streams, weights
from .devtrace import DeviceTrace
from .fleet import Batch, StreamDevice, TimedEngine, WindowClosed

SLICE_BATCHES = 32   # batches the traced run's profiler covers
CHECK_BATCHES = 16   # window batches the reference recomputes


@dataclasses.dataclass
class Run:
    """What a metric reader reads (``metrics/<name>.py``)."""
    config: dict
    traffic: dict
    setup_s: float
    t_start: float                  # the window, host clock
    t_end: float
    executed: List[Batch]           # every batch launched in the window
    batches: List[Batch]            # completed inside the window
    slice_batches: List[Batch]      # served under the profiler
    slice_s: Optional[float]        # host seconds the slice took
    trace: Optional[Dict]           # trace.summarize() of the slice
    counts: object = counts

    @property
    def length(self) -> int:
        return int(self.traffic["sample_tokens"])

    @property
    def max_batch(self) -> int:
        return int(self.traffic["server_profile"]["max_batch"])


def arch_config(cfg: dict) -> ArchConfig:
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    return ArchConfig(**{k: v for k, v in cfg.items() if k in fields})


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _pick(batches: List[Batch], n: int, rng) -> List[Batch]:
    """Up to ``n`` batches drawn from the seed, one of the largest among
    them."""
    if len(batches) <= n:
        return list(batches)
    idx = set(rng.choice(len(batches), n - 1, replace=False).tolist())
    biggest = max(b.bucket for b in batches)
    big = [i for i, b in enumerate(batches) if b.bucket == biggest]
    idx.add(big[int(rng.integers(len(big)))])
    return [batches[i] for i in sorted(idx)]


def _per_sample(picked, samples, lower) -> List[dict]:
    """One record a checked batch for ``control.py``'s dump."""
    return [{"bucket": b.bucket, "conf_err": s["conf_err"].tolist(),
             "pred_gap": s["pred_gap"].tolist(),
             "control_conf_err": c["conf_err"].tolist(),
             "control_pred_gap": c["pred_gap"].tolist()}
            for b, s, c in zip(picked, samples, lower)]


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def run_cell(cell: catalog.Cell, seed: int, seconds: float, trace: bool,
             *, device="cuda", t_process: Optional[float] = None,
             control: bool = False) -> dict:
    """Run ``cell`` once; the result line's dict (``checks`` last). With
    ``control`` the dict also holds, under "control", the numbers of the
    reference computed in TF32 in the program's place, under "altered"
    those of the reference with every answer moved to the next class, both
    measured the same way, and the per-sample errors under "samples"
    (``control.py`` reads them; the benchmark's runs do not)."""
    clock = time.perf_counter
    t0 = clock() if t_process is None else t_process
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False   # the cell states float32
    torch.backends.cudnn.allow_tf32 = False
    cfg, tr = cell.config, cell.traffic
    if cfg.get("dtype") != "float32":
        raise ValueError("only float32 configurations are run")
    dp, sp, sch = tr["device_profile"], tr["server_profile"], tr["scheduler"]
    n_dev, m, length = tr["devices"], tr["samples_per_device"], \
        tr["sample_tokens"]

    # -- set-up --------------------------------------------------------
    marks = [("start", t0)]
    model = build_model(arch_config(cfg), device=dev, dtype=torch.float32)
    marks.append(("imports, card, model", clock()))
    weights.load_into(model, cfg, seed)
    _sync(dev)
    marks.append(("weights drawn", clock()))
    toks = weights.tokens(n_dev, m, length, cfg["vocab_size"], seed)
    marks.append(("tokens", clock()))
    st = streams.device_streams(n_dev, m, dp["accuracy"], sp["accuracy"],
                                seed)
    marks.append(("streams", clock()))
    clients = [StreamDevice(i, st["confidence"][i], st["correct_light"][i],
                            dp, tr["slo_s"], tr["window_s"],
                            sch["init_threshold"]) for i in range(n_dev)]
    profile = ServerProfile(sp["name"], sp["model"], sp["accuracy"],
                            sp["base_latency"], sp["max_batch"],
                            sp["batch_scaling"])
    engine = TimedEngine([ServedModel(sp["name"], model, profile)],
                         max_in_flight=tr["max_in_flight"])
    sched = make_scheduler(sch["name"], n_dev, server_profile=profile,
                           slo=tr["slo_s"], init_threshold=sch["init_threshold"],
                           sr_target=sch["sr_target"], a=sch["a"])
    for bucket in [b for b in tr["ladder"] if b <= sp["max_batch"]]:
        batch = torch.as_tensor(toks[0, :bucket], device=dev)
        for _ in range(2):
            conf, pred = executables.classify_fn(model, bucket)(model, batch)
            conf.cpu(), pred.cpu()
    _sync(dev)
    marks.append(("buckets warmed", clock()))
    tracer = DeviceTrace() if trace else None
    if tracer is not None:
        tracer.warm(lambda: (torch.ones(8, device=dev) + 1).cpu())
        marks.append(("profiler warmed", clock()))
    datasets = [toks[i] for i in range(n_dev)]

    # -- the window (and the traced slice) -----------------------------
    # run_transport runs on a thread of its own, so that this thread can
    # start and stop the profiler (the two must be on one thread) while a
    # worker holds the slice's first batch back.
    slice_ready, slice_go = threading.Event(), threading.Event()

    def on_slice():
        slice_ready.set()
        slice_go.wait()

    failure: list = []

    def drive():
        try:
            run_transport(clients, engine, sched, datasets, None,
                          window=tr["window_s"], model_switching=False)
            failure.append(None)         # the cascade ran out first
        except WindowClosed:
            pass
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            failure.append(e)

    engine.arm(tr["window_opens_at_s"], seconds,
               SLICE_BATCHES if trace else 0, on_slice if trace else None)
    runner = threading.Thread(target=drive, name="cascade")
    runner.start()
    while runner.is_alive() and not engine.opened.wait(0.05):
        pass
    if not engine.opened.is_set():
        runner.join()
        raise failure[0] if failure and failure[0] is not None else \
            RuntimeError("the cascade ended before the window opened")
    t_start, t_end = engine.t_start, engine.t_end
    marks.append(("prelude to the operating point", t_start))
    setup_s = t_start - t0
    log(f"set-up {setup_s:.3f} s: " + ", ".join(
        f"{name} {b - a:.3f}" for (_, a), (name, b) in zip(marks, marks[1:])))
    summary = None
    if tracer is not None:
        while runner.is_alive() and not slice_ready.wait(0.05):
            pass
        if slice_ready.is_set():
            tracer.start()
            slice_go.set()
            while runner.is_alive() and not engine.slice_done.wait(0.05):
                pass
            _sync(dev)
            summary = tracer.stop()
    runner.join()
    if failure and failure[0] is not None:
        raise failure[0]
    if failure:
        t_end = min(t_end, max((b.t1 for b in engine.batches), default=t_end))
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    executed = [b for b in engine.batches if b.phase == "window"]
    window = [b for b in executed if b.t1 <= t_end]
    in_slice = [b for b in engine.batches if b.phase == "slice"]
    slice_s = (max(b.t1 for b in in_slice) - engine.slice_t0) \
        if in_slice else None
    run = Run(cfg, tr, setup_s, t_start, t_end, executed,
              window, in_slice, slice_s, summary)
    metrics = catalog.metric_values(
        cell.per_layer if trace else cell.end_to_end, run)
    queued = [(r.device_id, r.payload[0])
              for r in engine.queue.pop_batch(len(engine.queue))]
    books = check.bookkeeping(engine.submitted,
                              [b.keys for b in engine.batches], queued,
                              engine.cut)
    log(f"window {seconds:.3f} s: {len(window)} batches, "
        f"{sum(len(b.keys) for b in window)} samples served; "
        f"{len(engine.submitted)} submitted, {len(queued)} queued at the "
        f"cut, {len(engine.cut)} in cut batches")

    # -- the program's state freed, then the reference -----------------
    del model, engine, clients, sched
    executables.clear_cache()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    picked = _pick(window, CHECK_BATCHES, weights.check_rng(seed))
    w = weights.reference_weights(cfg, seed, dev)
    samples, lower, altered = [], [], []
    for b in picked:
        rows = torch.as_tensor(toks[[d for d, _ in b.keys],
                                    [j for _, j in b.keys]], device=dev)
        logits = reference.last_logits(w, cfg, rows)
        conf_ref, top1, p1 = reference.bvsb(logits)
        ref = (logits.cpu().numpy(), conf_ref.cpu().numpy(), p1.cpu().numpy())
        samples.append(check.sample_readings(b.conf, b.pred, *ref))
        if control:
            # the fault of an answer altered where it is produced, read at
            # the cell's size: the reference in the program's place with
            # every top-1 moved to the next class
            altered.append(check.sample_readings(
                ref[1], (top1.cpu().numpy() + 1) % cfg["vocab_size"], *ref))
            conf_c, pred_c, _ = reference.bvsb(
                reference.last_logits(w, cfg, rows, precision="tf32"))
            lower.append(check.sample_readings(conf_c.cpu().numpy(),
                                               pred_c.cpu().numpy(), *ref))
    del w
    values = check.numbers(samples, books)
    correct, checks = check.verdict(values, cell.limits)
    # failed: samples past the widest error's limit, the samples served
    # twice or lost, and at least one where not correct
    past = np.sum(check.sample_errors(samples)
                  > cell.limits["sample_err_max"])
    failed = max(int(past + books["served_twice"] + books["lost"]),
                 int(not correct))

    out = {"correct": bool(correct),
           "attempted": int(sum(len(b.keys) for b in window)),
           "failed": int(failed),
           "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                      "kind": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else "cpu"),
                      "count": cell.chips,
                      "memory_peak_bytes": int(peak)}}
    if trace:
        out["device"]["busy_s"] = summary["busy_s"] if summary else 0.0
        out["device"]["window_s"] = slice_s or 0.0
        if summary:
            out["breakdown"] = {"device_ops": summary["device_ops"],
                                "idle_gaps": summary["idle_gaps"]}
    log(f"checked {sum(len(s['conf_err']) for s in samples)} samples in "
        f"{len(picked)} batches")
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    if control:
        out["control"] = check.numbers(lower, {"served_twice": 0, "lost": 0})
        out["altered"] = check.numbers(altered, {"served_twice": 0,
                                                 "lost": 0})
        out["tails"] = {"program": check.tails(samples),
                        "control": check.tails(lower)}
        out["samples"] = _per_sample(picked, samples, lower)
    out["checks"] = checks
    return out
