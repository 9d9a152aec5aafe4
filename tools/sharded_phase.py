#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 8 (the sharded sweeps) alone on one card.

    python3 tools/sharded_phase.py [N_DEVICES]   # from the repository root

First phase 6(a)'s sweep through ``jaxsim.run_sweep`` on the card (100
devices x 5,000 samples, 3 schedulers x 3 seeds), timed: the reference
of (a). Then ``chip_smoke.sharded_path``: the same sweep through
``run_sweep_sharded``, and phase 7c's first lane (``chip_smoke.SHARD_N``
devices unless N_DEVICES is given) through ``run_device_sharded`` and
through the local segmented engine, over ``chip_smoke.SHARD_RANKS``
gloo ranks sharing the card. Prints the card's name and power limit
first.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("sharded_phase: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    dev = torch.device("cuda")
    seg_n = int(sys.argv[1]) if len(sys.argv) > 1 else cs.SHARD_N
    args, kw = cs.sim_inputs("hetero", range(3 * len(cs.SIM_SEEDS)),
                             cs.SIM_S)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hetero = cs.jaxsim.run_sweep(*args, device=dev, **kw)
    h_wall = time.perf_counter() - t0
    print(f"local (a) wall {h_wall:.3f} s")
    t0 = time.perf_counter()
    cs.sharded_path(dev, (hetero, h_wall), seg_n=seg_n)
    print(f"phase 8 {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
