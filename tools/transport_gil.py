#!/usr/bin/env python3
"""Time the live cascade on one card through ``run_cascade`` and the async
``run_transport`` under several interpreter switch intervals.

    python3 tools/transport_gil.py        # from the repository root

The fleet is ``chip_smoke.py``'s phase 4 (16 tier-low clients x 128
samples, tier-server-fast / tier-server-heavy with switching). Every
torch call releases the GIL inside its C++ dispatch and takes it back
after; with several Python threads runnable, taking it back can wait up
to the switch interval (``sys.setswitchinterval``, 5 ms by default)
while another thread runs Python. Timing the same runs at shorter and
longer intervals shows how much of the transport's wall those hand-offs
cost. Each interval runs run_cascade and run_transport at 1 and 2
in-flight slots, in turns, ``REPEATS`` times; the results are checked
equal as in the smoke. Prints the card's name and power limit first.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

INTERVALS = (5e-3, 5e-4, 5e-5, 5e-2)   # the default first
REPEATS = 2


def timed(models, run, slots):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, res = chip_smoke.cascade(models, run, slots)
    return time.perf_counter() - t0, res


def main() -> int:
    if not torch.cuda.is_available():
        print("transport_gil: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    chip_smoke._build.library()
    models = chip_smoke.build_models(torch.device("cuda"))
    chip_smoke.cascade(models)                      # warm-up
    runs = [("run_cascade", chip_smoke.run_cascade, 1),
            ("run_transport", chip_smoke.run_transport, 1),
            ("run_transport", chip_smoke.run_transport, 2),
            ("run_cascade", chip_smoke.run_cascade, 2)]
    default = sys.getswitchinterval()
    try:
        for interval in INTERVALS:
            sys.setswitchinterval(interval)
            walls = {(name, slots): [] for name, _, slots in runs}
            results = {}
            for rep in range(REPEATS):
                order = runs if rep % 2 == 0 else runs[::-1]
                for name, run, slots in order:
                    wall, res = timed(models, run, slots)
                    walls[name, slots].append(wall)
                    ref = results.setdefault(slots, res)
                    bad = chip_smoke.same_result(res, ref)
                    if bad:
                        raise AssertionError(f"{name} at {slots} slot(s) "
                                             f"differs in {bad}")
            cells = "; ".join(
                f"{name} {slots} slot(s) "
                + ", ".join(f"{w:.3f}" for w in ws) + " s"
                for (name, slots), ws in walls.items())
            print(f"switch interval {interval * 1e3:g} ms: {cells}")
    finally:
        sys.setswitchinterval(default)
    return 0


if __name__ == "__main__":
    sys.exit(main())
