"""Run one cell of the benchmark once and print its result line.

    python3 cascade_bench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

From the root of a checkout of the repository, on a machine with the
cards the cell asks for. With ``--trace 0`` the line carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics. The last
line of standard output is one JSON object; the numbers that decided
``correct`` are the last lines of standard error. Exits non-zero, with no
result, when there is no card (or too few), when the program cannot be
imported, or when a module of the JAX package was loaded.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# every build and kernel cache of the run inside the checkout, at fixed
# paths (the program's own nvcc build goes to <checkout>/build/repro_torch)
CACHE = ROOT / "build" / "cascade_bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``repro_torch`` is the program, ``repro`` the JAX package)."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(CACHE / sub)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    if sys.path[2:3] == [str(HERE)]:
        del sys.path[2]

    from cascade_bench import catalog
    cell = catalog.load_cell(args.workload)

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    card = power_limit()

    from cascade_bench import harness
    line = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            device="cuda:0", t_process=T_PROCESS)
    line["device"]["card"] = card
    found = forbidden_modules()
    if found:
        print(f"modules of the JAX package loaded: {found}", file=sys.stderr)
        return 3
    harness.log(f"card {card}; peaks: FP32 {harness.counts.FP32_FLOPS:.3g} "
                f"FLOP/s, HBM {harness.counts.HBM_BPS:.3g} B/s (H100 SXM "
                f"data sheet)")
    for name, c in line["checks"].items():
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
