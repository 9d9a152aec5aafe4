"""Render the §Dry-run and §Roofline tables from the dry-run's JSON files.

Counterpart of the JAX package's ``roofline/report.py``:

    PYTHONPATH=src python -m repro_torch.roofline.report results/dryrun_torch

The §Dry-run table has every cell of every mesh; the §Roofline table the
16 x 16 mesh's, its terms at the H100 SXM's data-sheet rates
(``roofline.analysis.H100_SXM``), not measured.
"""
from __future__ import annotations

import glob
import json
import os
import sys

from repro_torch.roofline.analysis import H100_SXM

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def load(out_dir: str):
    rows = []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    order = {s: i for i, s in enumerate(SHAPES)}
    return sorted(rows, key=lambda r: (r.get("mesh", ""), r.get("arch", ""),
                                       order.get(r.get("shape"), 9)))


def fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def roofline_table(rows, mesh: str) -> str:
    out = ["| arch | shape | compute | memory | collective | dominant | "
           "6·N·D FLOPs | useful | HBM GiB/chip (args+temp, est.) |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("mesh") != mesh or not r.get("ok"):
            continue
        rf = r["roofline"]
        hbm = r["memory_analysis"]["peak_bytes"] / 2**30
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(rf['compute_s'])} | "
            f"{fmt_s(rf['memory_s'])} | {fmt_s(rf['collective_s'])} | "
            f"**{rf['dominant']}** | {rf['model_flops']:.2e} | "
            f"{rf['useful_ratio']:.2f} | {hbm:.1f} |")
    return "\n".join(out)


def dryrun_table(rows) -> str:
    """A row per (arch, shape), the meshes side by side: bytes a rank
    (arguments, and the peak estimate), collective GiB a rank on a ring,
    the heaviest collective, the cell's wall on the CPU."""
    meshes = sorted({r["mesh"] for r in rows})
    cells = {}
    for r in rows:
        cells.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r
    gib = 2 ** 30

    def per_mesh(by, fn):
        return " / ".join(fn(by[m]) if m in by and by[m].get("ok")
                          else ("FAIL" if m in by else "-") for m in meshes)
    out = [f"| arch | shape | params | args GiB ({' / '.join(meshes)}) | "
           "peak GiB, est. | collective GiB | top collective | wall (CPU) |",
           "|---|---|---|---|---|---|---|---|"]
    for (arch, shape), by in cells.items():
        ok = [r for r in by.values() if r.get("ok")]
        if len(ok) < len(by):
            out.append(f"| {arch} | {shape} | FAIL: "
                       + "; ".join(r.get("error", "")[:60] for r in
                                   by.values() if not r.get("ok"))
                       + " | | | | | |")
            continue
        first = by[meshes[0]] if meshes[0] in by else ok[0]
        colls = first["collectives"]
        top = max(colls, key=lambda k: colls[k]["bytes"]) if colls else "-"
        out.append(
            f"| {arch} | {shape} | {first['n_params'] / 1e9:.2f}B | "
            + per_mesh(by, lambda r: f"{r['memory_analysis']['argument_bytes'] / gib:.2f}")
            + " | " + per_mesh(by, lambda r: f"{r['memory_analysis']['peak_bytes'] / gib:.1f}")
            + " | " + per_mesh(by, lambda r: f"{r['collective_bytes_per_device'] / gib:.2f}")
            + f" | {top} | "
            + per_mesh(by, lambda r: f"{r['wall_s']:.1f}s") + " |")
    return "\n".join(out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out_dir = argv[0] if argv else "results/dryrun_torch"
    rows = load(out_dir)
    meshes = sorted({r.get("mesh") for r in rows if r.get("mesh")})
    print("## §Dry-run\n")
    print(dryrun_table(rows))
    r = H100_SXM
    for mesh in meshes:
        if mesh.startswith("2x"):
            continue  # the roofline table is the single pod's
        print(f"\n## §Roofline (mesh {mesh}, per-chip terms; the {r.name} "
              f"data sheet, not measured: {r.bf16 / 1e12:.0f} TF/s bf16 "
              f"dense, {r.hbm / 1e12:.2f} TB/s HBM, {r.link / 1e9:.0f} GB/s "
              "NVLink a direction, a lower bound across nodes)\n")
        print(roofline_table(rows, mesh))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
