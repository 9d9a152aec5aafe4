#!/usr/bin/env python3
"""Time the device-sharded engine's two trip forms on one card: every
trip eager, and the event's two pieces captured as CUDA graphs around its
all_reduce (``jaxsim._DeviceEngine.CAPTURE``, the default on the card).

    python3 tools/sharded_forms.py [N_DEVICES]   # from the repository root

The fleet is ``chip_smoke.py``'s phase 8(b): phase 7c's first lane
(``chip_smoke.SHARD_N`` devices unless N_DEVICES is given, S 3, seed 0,
MultiTASC++ with switching over three servers) through
``run_device_sharded`` over ``chip_smoke.SHARD_RANKS`` gloo ranks sharing
the card. It runs the forms in the order captured, eager, captured,
eager, each a fresh spawn of the ranks, checks that every run's result
is equal bit for bit, and prints per run the wall (the slowest rank's,
from a barrier), us an event and the host seconds inside the
collectives. Before the forms, the bare exchange: ``EXCHANGE_CALLS``
all_reduce MIN calls of the event's buffer (k + 4 G + 1 float64) with no
engine around them, of a CUDA tensor (gloo stages it through the host)
and of a CPU tensor, so the per-event time splits into the exchange
itself and the waiting for the other ranks' work. Prints the card's
name and power limit first.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.sim import jaxsim  # noqa: E402

FORMS = (True, False, True, False)   # captured, eager, captured, eager
EXCHANGE_CALLS = 2000


def exchange_work(mesh, dev, calls):
    """us a call of a bare all_reduce MIN of the event's exchange buffer,
    of a tensor on ``dev`` and of one on the CPU."""
    size = chip_smoke.SHARD_RANKS + 4 * jaxsim.N_BUCKET + 1
    out = {}
    for where in (dev, torch.device("cpu")):
        buf = torch.zeros(size, dtype=torch.float64, device=where)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(calls):
            dist.all_reduce(buf, op=dist.ReduceOp.MIN,
                            group=mesh.get_group())
        if where.type == "cuda":
            torch.cuda.synchronize()
        out[where.type] = (time.perf_counter() - t0) / calls * 1e6
    return out


def fleet_work(mesh, dev, n, capture):
    jaxsim._DeviceEngine.CAPTURE = capture
    (specs, streams, lat, slo, servers), kw = chip_smoke.seg_inputs(
        n, chip_smoke.SEG_S, 1)
    return chip_smoke.shard_timed(dev.type, lambda: jaxsim.run_device_sharded(
        specs[0], streams, lat, slo, servers, mesh=mesh, device=dev, **kw))


def same(a, b):
    return all(np.array_equal(a[k], b[k], equal_nan=True) for k in a
               if k != "traces") and all(
        np.array_equal(a["traces"][k], b["traces"][k], equal_nan=True)
        for k in a["traces"])


def main() -> int:
    if not torch.cuda.is_available():
        print("sharded_forms: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    n = int(sys.argv[1]) if len(sys.argv) > 1 else chip_smoke.SHARD_N
    results, _ = chip_smoke.shard_ranks("cuda", exchange_work,
                                        EXCHANGE_CALLS)
    for kind in ("cuda", "cpu"):
        per = [res[kind] for res in results]
        print(f"bare exchange, {EXCHANGE_CALLS} all_reduce MIN calls of a "
              f"{kind} buffer over {chip_smoke.SHARD_RANKS} ranks: "
              f"{max(per):.2f} us a call on the slowest rank (ranks "
              f"{', '.join(f'{x:.2f}' for x in per)})")
    first = None
    for capture in FORMS:
        results, spawn = chip_smoke.shard_ranks("cuda", fleet_work, n,
                                                capture)
        out, _, st = results[0]
        walls = [res[1] for res in results]
        coll = [res[2]["collective_ns"] / 1e9 for res in results]
        if first is None:
            first = out
        if not all(same(res[0], first) for res in results):
            raise AssertionError("the runs' results differ")
        n_ev = int(out["n_events"])
        print(f"{'captured' if capture else 'eager':8s} {n} devices over "
              f"{chip_smoke.SHARD_RANKS} ranks: wall {max(walls):.3f} s, "
              f"{n_ev} events, {max(walls) / n_ev * 1e6:.2f} us an event, "
              f"{st['collectives']} collectives, {max(coll):.3f} s inside "
              f"them on the slowest rank ({max(coll) / max(walls):.4f} of "
              f"the wall), graphs {st['graphs_captured']}; spawn to join "
              f"{spawn:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
