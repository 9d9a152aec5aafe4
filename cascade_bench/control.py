"""The control of ``correct``: readings of sound runs of the program and of
the reference computed one precision lower, in its place, on the chip.

    python3 cascade_bench/control.py --workload <cell> --seeds 1,2,3 \\
        --seconds 10 [--dump <file.jsonl>]

For each seed, in one process: a short window of the cell at its own load
(the program, judged as a benchmark run judges it), then the reference in
TF32 over the same checked batches, judged by ``check.verdict`` against
the cell's limits (``limits/<cell>.json``) exactly as the program is, and
the reference with each answer altered to the next class, the fault that
sets the upper reading of ``sample_err_max``. Prints one JSON line a seed,
with ``correct`` for the program, the control and the fault, and, last,
the largest reading of the program and the smallest of the control and
of the fault for each number: the readings a limit is set between. With
``--dump`` each checked batch's per-sample errors are written to a file,
one line a seed.
"""
import json
import pathlib
import sys

sys.path[:0] = [str(pathlib.Path(__file__).resolve().parents[1] / "src"),
                str(pathlib.Path(__file__).resolve().parents[1])]


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--dump")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from cascade_bench import catalog, check, harness
    cell = catalog.load_cell(args.workload)
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        out = harness.run_cell(cell, seed, args.seconds, False,
                               device="cuda:0", control=True)
        control_ok, _ = check.verdict(out["control"], cell.limits)
        altered_ok, _ = check.verdict(out["altered"], cell.limits)
        row = {"seed": seed, "correct": out["correct"],
               "control_correct": control_ok, "altered_correct": altered_ok,
               "program": {k: v["value"] for k, v in out["checks"].items()},
               "control": out["control"], "altered": out["altered"],
               "tails": out["tails"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.dump:
            with open(args.dump, "a") as f:
                f.write(json.dumps({"seed": seed,
                                    "batches": out["samples"]}) + "\n")
    summary = {"workload": cell.name, "seeds": len(rows),
               "program_correct": sum(r["correct"] for r in rows),
               "control_correct": sum(r["control_correct"] for r in rows),
               "altered_correct": sum(r["altered_correct"] for r in rows),
               "program_max": {k: max(r["program"][k] for r in rows)
                               for k in check.NUMBERS},
               "control_min": {k: min(r["control"][k] for r in rows)
                               for k in check.NUMBERS},
               "altered_min": {k: min(r["altered"][k] for r in rows)
                               for k in check.NUMBERS}}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
