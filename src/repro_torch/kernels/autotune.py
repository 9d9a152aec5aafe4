"""Autotuner for the kernels' planners: sweeps each planner constant on the
card, holds every candidate to its plain version, reports it against its
bound, and persists the winners by card name.

Counterpart of the JAX package's ``kernels/autotune.py`` (its ``sweep``,
``pick`` and ``persist``). What is tuned are the constants from which the
port's planners cut every shape (``ops.PLAN_KNOBS``): BvSB's
``BLOCKS_PER_SM`` and ``MIN_CHUNK`` (``bvsb.chunks``), decode attention's
``BLOCKS_PER_SM`` (``splits``) and ``SHARD_MIN_KEYS`` (``shard_splits``),
the scan's ``IN_FLIGHT`` and ``STAGES`` (``tiles``) and ``BWD_STEPS``
(``bwd_tiles``). Each constant is swept alone, the others at their values
in force, over the shapes in ``SHAPES`` (the paths' shapes around the
plans' turning points); a candidate's time is the sum of its kernels'
device times (``timing.time_ms``) over those shapes, each shape's plan
timed once. A candidate's output at every shape must equal the plain
version's: BvSB and decode in float32 within ``F32_ATOL`` (BvSB's with an
exact top-1), in another type within ``NUMERIC_ATOL``, the scan and its
backward bit for bit; ``failures`` lists every cell that does not, and a
sweep with any is a fault of the kernel, not a slower candidate. Its time
is reported beside the bound (``roofline.analysis``) at the card's
data-sheet rates. The value in force is timed three times; ``pick`` keeps
it unless a candidate beats it by more than those times' spread.
The decode shard constant is timed as the partial entry plus the merge
over every rank's gathered splits; the gather itself (bytes it adds are
reported) costs nothing on one card and is not in the sum.

Tuning is offline: ``python -m repro_torch.kernels.autotune`` on the card
persists the winners into ``ops.TUNED_PLANS_PATH`` under the card's name
(``--dry-run`` reports without persisting), ``ops.reload_plans`` sets the
planners from it and ``ops.cache_token`` folds them into the executable
cache's key. Serving never tunes: timing noise must not pick other plans,
and so other executables, run to run.
"""
from __future__ import annotations

import argparse
import json
import pathlib
from typing import Dict, List, Optional

import torch

from repro_torch.kernels import _build, ops
from repro_torch.kernels import bvsb as _bvsb
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import rglru_scan as _rglru
from repro_torch.kernels.timing import time_ms
from repro_torch.roofline import analysis as ra

# a candidate against its plain version: the kernel checks' float32
# tolerances (BvSB's conf, decode's output), the repo's kernel gate in
# another type
F32_ATOL = {"bvsb": 1e-5, "decode_attention": 1e-4}
NUMERIC_ATOL = 2e-3
# timings of the value in force, whose spread is the noise a winner must beat
IN_FORCE_TIMINGS = 3

CANDIDATES = {
    ("bvsb", "BLOCKS_PER_SM"): (1, 2, 4, 8, 16),
    ("bvsb", "MIN_CHUNK"): (1024, 2048, 4096, 8192, 16384),
    ("decode_attention", "BLOCKS_PER_SM"): (1, 2, 4),
    ("decode_attention", "SHARD_MIN_KEYS"): (16, 32, 64, 128, 256),
    ("rglru_scan", "IN_FLIGHT"): (8192, 16384, 32768, 65536, 131072),
    ("rglru_scan", "STAGES"): (2, 3, 4, 6),
    ("rglru_scan", "BWD_STEPS"): (16, 32, 64, 128),
}

# the sweep shapes: BvSB (B, V) f32 rows, from the cascade's server batch
# to RecurrentGemma's head; decode (B, W, KV, G, hd) f32 rings full, and
# (B, W, KV, G, hd, ranks) rings cut over the model ranks (RecurrentGemma's
# and granite's, phase 13's); the scan (B, S, D, dtype) at RecurrentGemma's
# serving and training shapes
RG_S, RG_D = 3000, 4096
SHAPES = {
    ("bvsb", "BLOCKS_PER_SM"): ((8, 2048), (8, 8192), (8, 12288),
                                (8, 16384), (1, 16384), (64, 16384),
                                (8, 65536), (4, 256_000), (64, 256_000)),
    ("decode_attention", "BLOCKS_PER_SM"): ((4, 2048, 1, 16, 256),
                                            (64, 2048, 1, 16, 256)),
    ("decode_attention", "SHARD_MIN_KEYS"): ((4, 2048, 1, 16, 256, 4),
                                             (4, 2064, 8, 2, 64, 4)),
    ("rglru_scan", "IN_FLIGHT"): ((4, RG_S, RG_D, torch.float32),
                                  (1, RG_S, RG_D, torch.float32),
                                  (4, RG_S, RG_D, torch.bfloat16)),
    ("rglru_scan", "BWD_STEPS"): ((2, RG_S, RG_D, torch.float32),
                                  (1, RG_S, RG_D, torch.float32),
                                  (2, RG_S, RG_D, torch.bfloat16)),
}
SHAPES[("bvsb", "MIN_CHUNK")] = SHAPES[("bvsb", "BLOCKS_PER_SM")]
SHAPES[("rglru_scan", "STAGES")] = SHAPES[("rglru_scan", "IN_FLIGHT")]


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


class _Case:
    """One sweep shape of one knob: its inputs, the plain version's output,
    the plan a constant value gives, a run of the planned kernel(s), the
    check of an output and the bound."""

    def __init__(self, knob, shape, dev, seed, rates):
        self.knob, self.shape, self.dev = knob, shape, dev
        self.bw, self.flops = rates.hbm, rates.fp32
        kernel, name = knob
        g = _gen(dev, seed)
        sms = _build.sm_count(dev)
        if kernel == "bvsb":
            b, v = shape
            x = torch.randn(b, v, device=dev, generator=g) * 4
            self.plan = lambda: _bvsb.chunks(b, v, sms)
            self.run = lambda: _bvsb.run_entry(x)
            self.ref = _bvsb.bvsb_plain(x)
            self.bound_ms = ra.bvsb_bound_ms(b, v, 4, self.bw, self.flops)[0]
        elif name == "BLOCKS_PER_SM":
            b, w, kv, gq, hd = shape
            q, k, v, lens = self._ring(g, b, w, kv, gq, hd)
            self.plan = lambda: _decode.splits(b, kv, w, sms)
            self.run = lambda: _decode.run_entry(q, k, v, lens)
            self.ref = _decode.decode_attention_plain(q, k, v, lens)
            self.bound_ms = ra.decode_bound_ms(q, k, lens, self.bw,
                                               self.flops)[0]
        elif kernel == "decode_attention":
            self._shard_case(g, sms, *shape)
        else:
            self._scan_case(g, sms, name, *shape)

    def _ring(self, g, b, w, kv, gq, hd):
        q = torch.randn(b, kv * gq, hd, device=self.dev, generator=g)
        k = torch.randn(b, w, kv, hd, device=self.dev, generator=g)
        v = torch.randn(b, w, kv, hd, device=self.dev, generator=g)
        lens = torch.full((b,), w, dtype=torch.int32, device=self.dev)
        return q, k, v, lens

    def _shard_case(self, g, sms, b, w, kv, gq, hd, m):
        """Rank 0's partial entry on its shard, then the merge of every
        rank's partials (their sum: the gather)."""
        q, k, v, lens = self._ring(g, b, w, kv, gq, hd)
        ws = w // m
        shards = [(k[:, j * ws:(j + 1) * ws].contiguous(),
                   v[:, j * ws:(j + 1) * ws].contiguous()) for j in range(m)]

        def partials(j):
            return _decode.run_partials_entry(q, *shards[j], lens, j, m)

        def gathered():
            return torch.stack([partials(j) for j in range(m)]).sum(0)

        def shard_time():
            parts = gathered()
            part_ms = time_ms(lambda: partials(0))[0]
            merge_ms = time_ms(
                lambda: _decode.run_merge_entry(parts, q, kv))[0]
            self.extra = {"gathered_bytes": parts.numel() * 4,
                          "partial_us": part_ms * 1e3,
                          "merge_us": merge_ms * 1e3}
            self.bound_ms = ra.decode_partials_bound_ms(
                q, shards[0][0], lens, 0, self.plan()[0], self.bw,
                self.flops)[0] + ra.decode_merge_bound_ms(
                    parts, q, kv, self.bw, self.flops)[0]
            return part_ms + merge_ms
        self.plan = lambda: _decode.shard_splits(b, kv, ws, sms, m)
        self.run = lambda: _decode.run_merge_entry(gathered(), q, kv)
        self.time = shard_time
        self.ref = _decode.decode_attention_plain(q, k, v, lens)

    def _scan_case(self, g, sms, name, b, s, d, dt):
        a = torch.rand(b, s, d, device=self.dev, generator=g).to(dt)
        u = torch.randn(b, s, d, device=self.dev, generator=g).to(dt)
        elt = a.element_size()
        if name == "BWD_STEPS":
            h0 = torch.randn(b, d, device=self.dev, generator=g)
            h = _rglru.run_entry(a, u, h0)
            dh = torch.randn(b, s, d, device=self.dev, generator=g)
            self.plan = lambda: _rglru.bwd_tiles(b, s, d, elt, sms)
            self.run = lambda: _rglru.run_bwd_entry(a, h, dh, h0)
            self.ref = _rglru.rglru_scan_bwd_plain(a, h, dh, h0)
            self.bound_ms = ra.rglru_bwd_bound_ms(a, self.bw, self.flops)[0]
        else:
            self.plan = lambda: _rglru.tiles(b, s, d, elt, sms)
            self.run = lambda: _rglru.run_entry(a, u)
            self.ref = _rglru.rglru_scan_plain(a, u)
            self.bound_ms = ra.rglru_bound_ms(a, self.bw, self.flops)[0]

    def check(self):
        """(max |err| against the plain version, its tolerance (0: bit for
        bit), whether it passes)."""
        got = self.run()
        kernel = self.knob[0]
        if kernel == "rglru_scan":
            pairs = [(x, y) for x, y in zip(got, self.ref) if y is not None] \
                if isinstance(got, tuple) else [(got, self.ref)]
            same = all(torch.equal(x, y) for x, y in pairs)
            return max(_max_err(x, y) for x, y in pairs), 0.0, same
        if kernel == "bvsb":
            err, atol = _max_err(got[0], self.ref[0]), self.atol()
            return err, atol, err <= atol and torch.equal(got[1], self.ref[1])
        err, atol = _max_err(got, self.ref), self.atol()
        return err, atol, err <= atol

    def atol(self) -> float:
        dtype = self.ref[0].dtype if isinstance(self.ref, tuple) \
            else self.ref.dtype
        return F32_ATOL[self.knob[0]] if dtype == torch.float32 \
            else NUMERIC_ATOL

    def time(self) -> float:
        """Device ms of the planned kernel a call."""
        return time_ms(self.run)[0]


def sweep(knob, device="cuda", *, seed: int = 0, rates=None) -> List[dict]:
    """Every candidate value of ``knob`` = (kernel, constant name), and the
    value in force, the other constants at their values in force: for each
    shape of ``SHAPES[knob]`` the plan the value gives, its device us (each
    plan timed once), its bound and its check against the plain version.
    The value in force is timed IN_FORCE_TIMINGS times in all: its result's
    ``spread_us`` is their max - min. The constant is put back afterwards.
    Sorted fastest first."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("autotune sweeps run on a CUDA device")
    rates = rates or ra.rates_for(torch.cuda.get_device_name(dev))
    kernel, name = knob
    mod = ops.PLAN_KNOBS[kernel][0]
    cases = [_Case(knob, shape, dev, seed + i, rates)
             for i, shape in enumerate(SHAPES[knob])]
    keep = getattr(mod, name)
    timed: Dict[tuple, dict] = {}
    results = []
    try:
        for value in sorted(set(CANDIDATES[knob]) | {keep}):
            setattr(mod, name, value)
            cells = []
            for i, case in enumerate(cases):
                key = (i, case.plan())
                if key not in timed:
                    err, atol, ok = case.check()
                    ms = case.time()
                    timed[key] = dict(shape=_shape_name(case.shape),
                                      plan=list(key[1]), us=ms * 1e3,
                                      bound_us=case.bound_ms * 1e3,
                                      over_bound=ms / case.bound_ms,
                                      max_err=err, atol=atol, ok=ok,
                                      **getattr(case, "extra", {}))
                cells.append(timed[key])
            results.append(dict(kernel=kernel, knob=name, value=value,
                                current=value == keep,
                                us=sum(c["us"] for c in cells),
                                bound_us=sum(c["bound_us"] for c in cells),
                                numerics_ok=all(c["ok"] for c in cells),
                                cells=cells))
        setattr(mod, name, keep)
        current = next(r for r in results if r["current"])
        again = [sum(case.time() for case in cases) * 1e3
                 for _ in range(IN_FORCE_TIMINGS - 1)]
        readings = [current["us"]] + again
        current["spread_us"] = max(readings) - min(readings)
    finally:
        setattr(mod, name, keep)
    results.sort(key=lambda r: r["us"])
    return results


def _shape_name(shape) -> str:
    return "(" + ", ".join(str(x).removeprefix("torch.") for x in shape) + ")"


def sweep_all(device="cuda", *, seed: int = 0) -> Dict[tuple, List[dict]]:
    """``sweep`` of every knob of ``CANDIDATES``."""
    return {knob: sweep(knob, device, seed=seed) for knob in CANDIDATES}


def failures(swept: Dict[tuple, List[dict]]) -> List[str]:
    """Every (knob, value, shape) whose kernel disagreed with its plain
    version, with its error and tolerance."""
    return [f"{kernel}.{name}={r['value']} at {c['shape']} plan "
            f"{tuple(c['plan'])}: max|err| {c['max_err']:.3g} (atol "
            f"{c['atol']:g}"
            + (", top-1 or bits differ)" if c["max_err"] <= c["atol"]
               else ")")
            for (kernel, name), results in swept.items() for r in results
            for c in r["cells"] if not c["ok"]]


def pick(results: List[dict]) -> Optional[dict]:
    """The value in force, unless the fastest candidate whose every shape
    passed its check beats it by more than the in-force value's spread
    over its timings (``spread_us``), noise that must not change plans;
    None if no candidate passed."""
    passing = sorted((r for r in results if r["numerics_ok"]),
                     key=lambda r: r["us"])
    if not passing:
        return None
    current = next((r for r in passing if r["current"]), None)
    if current is not None and \
            current["us"] - passing[0]["us"] <= current["spread_us"]:
        return current
    return passing[0]


def persist(winners: Dict[str, Dict[str, int]], card: str,
            path=None) -> dict:
    """Write ``winners`` ({kernel: {constant: value}}) under ``card`` into
    the tuned file (``path``, default ``ops.TUNED_PLANS_PATH``), keeping
    other cards' entries, and reload the planners from it; the plans in
    force."""
    path = pathlib.Path(path or ops.TUNED_PLANS_PATH)
    tuned = json.loads(path.read_text()) if path.exists() else {}
    entry = tuned.setdefault(card, {})
    for kernel, knobs in winners.items():
        entry.setdefault(kernel, {}).update(knobs)
    path.write_text(json.dumps(tuned, indent=2, sort_keys=True) + "\n")
    return ops.reload_plans(path, card)


def winners_of(swept: Dict[tuple, List[dict]]) -> Dict[str, Dict[str, int]]:
    """The picked value of every swept knob, by kernel (a knob whose every
    candidate failed keeps its value in force)."""
    out: Dict[str, Dict[str, int]] = {}
    for (kernel, name), results in swept.items():
        best = pick(results)
        if best is not None:
            out.setdefault(kernel, {})[name] = best["value"]
    return out


def report(swept: Dict[tuple, List[dict]], card: str) -> None:
    """Print every candidate of every knob against its bound."""
    for (kernel, name), results in swept.items():
        best = pick(results)
        for r in results:
            cells = "; ".join(
                f"{c['shape']} plan {tuple(c['plan'])} {c['us']:.2f} us "
                f"({c['over_bound']:.2f}x bound)"
                + ("" if c["ok"] else " [NUMERICS FAIL]") for c in r["cells"])
            flag = " <- pick" if r is best else ""
            flag += (f" (in force, spread {r['spread_us']:.2f} us over "
                     f"{IN_FORCE_TIMINGS} timings)") if r["current"] else ""
            print(f"autotune {kernel}.{name}={r['value']}: {r['us']:.2f} us "
                  f"over {len(r['cells'])} shapes (bound "
                  f"{r['bound_us']:.4f} us){flag} on {card}: {cells}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dry-run", action="store_true",
                    help="sweep and report without persisting")
    ap.add_argument("--path", default=None,
                    help=f"tuned file (default {ops.TUNED_PLANS_PATH})")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("autotune: no CUDA device; the sweep runs on the card")
        return 1
    card = torch.cuda.get_device_name()
    swept = sweep_all()
    report(swept, card)
    bad = failures(swept)
    if bad:
        print("autotune: kernels disagree with their plain versions, "
              "nothing persisted:\n  " + "\n  ".join(bad))
        return 1
    winners = winners_of(swept)
    print(f"winners on {card}: {json.dumps(winners, sort_keys=True)}")
    if not args.dry_run:
        persist(winners, card, args.path)
        print(f"persisted to {args.path or ops.TUNED_PLANS_PATH}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
