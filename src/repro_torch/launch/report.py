"""Tables from the dry-run's records (port of ``repro/launch/report.py``):
the dry-run table and the roofline table, with its "next lever" column,
for the H100 production meshes ``32x8`` and ``2x32x8``.

  PYTHONPATH=src python -m repro_torch.launch.report [--quant 4]
"""
from __future__ import annotations

import argparse

from repro_torch.launch import roofline

GIB = 2 ** 30


def dryrun_table(mesh: str, quant=None, art_dir: str | None = None) -> str:
    """Per-GPU counts of every cell: flops, bytes, collective bytes, the
    rank's memory (its argument bytes, with the replicated ``wo`` / ``swo``
    among them, and its peak), and the bytes per chip the GSPMD rules
    would hold."""
    rows = [
        "| arch | shape | status | per-chip FLOPs | per-chip HBM bytes | "
        "coll bytes | argument/chip (wo replicated) | GSPMD rules/chip | "
        "peak mem/chip | fits 80 GB | count |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in roofline.load_records(mesh, quant, art_dir=art_dir):
        if r["status"] == "skip":
            rows.append(f"| {r['arch']} | {r['shape']} | SKIP ("
                        f"{r['reason'].split(':', 1)[-1].strip()[:48]}) | — "
                        f"| — | — | — | — | — | — | — |")
            continue
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | ERROR "
                        f"({r['error'][:60]}) | — | — | — | — | — | — | — "
                        f"| — |")
            continue
        m = r["memory"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | ok | {r['flops']:.3e} | "
            f"{r['hlo_bytes']:.3e} | {r['coll_bytes']:.3e} | "
            f"{m['argument'] / GIB:.2f} GiB ({r['wo_bytes'] / GIB:.2f}) | "
            f"{r['argument_specs'] / GIB:.2f} GiB | {m['peak'] / GIB:.2f} "
            f"GiB | {'yes' if r['fits'] else 'no'} | {r['count_s']}s |")
    return "\n".join(rows)


def roofline_table(mesh: str, quant=None, art_dir: str | None = None) -> str:
    rows = [
        "| arch | shape | T_comp (ms) | T_mem (ms) | T_coll (ms) | dominant |"
        " MODEL_FLOPS/chip | useful ratio | roofline frac | next lever |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in roofline.load_records(mesh, quant, art_dir=art_dir):
        if r["status"] != "ok":
            continue
        rl = roofline.analyze(r, roofline.record_config(r))
        rows.append(
            f"| {r['arch']} | {r['shape']} | {rl.t_compute*1e3:.2f} | "
            f"{rl.t_memory*1e3:.2f} | {rl.t_collective*1e3:.2f} | "
            f"{rl.dominant} | {rl.model_flops_per_chip:.3e} | "
            f"{rl.useful_ratio:.3f} | {rl.roofline_frac:.3f} | "
            f"{_lever(r, rl)} |")
    return "\n".join(rows)


def _lever(r: dict, rl) -> str:
    if rl.dominant == "memory":
        if r["kind"] == "decode":
            return "quantize weights/cache (b/16 of bytes)"
        return "cut activation traffic (fused attention, no f32 copies)"
    if rl.dominant == "collective":
        return "overlap the TP gathers / shard wo"
    return "larger per-chip tiles / batch"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quant", type=int, default=None)
    args = ap.parse_args(argv)
    for mesh in ("32x8", "2x32x8"):
        print(f"\n### Dry-run {mesh}\n")
        print(dryrun_table(mesh, args.quant))
        print(f"\n### Roofline {mesh}\n")
        print(roofline_table(mesh, args.quant))


if __name__ == "__main__":
    main()
