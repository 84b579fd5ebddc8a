"""Roofline over the dry run's records; counterpart of
`repro.launch.roofline`, with one H100 SXM's rates in place of the TPU's.

Three terms per (arch x shape x mesh), in seconds a step:

  compute    = FLOPs_per_device / PEAK_FLOPS   (dense bf16 tensor cores)
  memory     = HBM_bytes_per_device / HBM_BW   (HBM3)
  collective = wire_bytes_per_device / NVLINK_BW  (one direction)

Every record is a trace of one device's work (`"per_device":
"trace"`: one card, or rank 0 of a sharded step), so every one has its
wire bytes and its collective term (0 on one card). The bound is the
largest term. `ideal` = MODEL_FLOPS / (devices x PEAK_FLOPS), the
time a perfect implementation would take; roofline_fraction = ideal /
bound; flops_ratio = MODEL_FLOPS / traced FLOPs (remat and padding
waste). For decode the floor is also every argument byte (weights and
cache) read once.

Usage: python -m repro_torch.launch.roofline [--dir artifacts/dryrun]
       [--mesh h100] [--csv out.csv]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

#: the card these rates are for, as nvidia-smi names it, and the power
#: limit they assume (a card set lower runs slower under load)
CARD = "NVIDIA H100 80GB HBM3"
POWER_LIMIT_W = 700.0
PEAK_FLOPS = 989e12        # dense bf16 operations/s
HBM_BW = 3.35e12           # bytes/s
NVLINK_BW = 450e9          # bytes/s, one direction


def load_cells(art_dir: Path, mesh: str | None = None) -> list[dict]:
    cells = []
    for p in sorted(art_dir.glob("*.json")):
        if p.name.endswith("FAILED.json"):
            continue
        rec = json.loads(p.read_text())
        if mesh and rec.get("mesh") != mesh:
            continue
        cells.append(rec)
    return cells


def roofline_row(rec: dict) -> dict:
    if rec.get("skipped"):
        return {"arch": rec["arch"], "shape": rec["shape"],
                "skipped": rec["reason"]}
    n = rec["n_devices"]
    compute_s = rec["flops_per_device"] / PEAK_FLOPS
    memory_s = rec["hbm_bytes_per_device"] / HBM_BW
    coll_s = rec["collective_wire_bytes"] / NVLINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    dominant = max(terms, key=terms.get)
    ideal = rec["model_flops"] / (n * PEAK_FLOPS)
    if rec["kind"] == "decode":
        # decode is bound by memory by construction: the floor is
        # reading every argument byte (weights and cache) once a step
        ideal = max(ideal, rec["memory"]["argument_bytes"] / HBM_BW)
    bound = max(terms.values())
    traced = rec["flops_per_device"] * n
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "compute_s": compute_s, "memory_s": memory_s, "collective_s": coll_s,
        "dominant": dominant,
        "ideal_s": ideal,
        "roofline_fraction": ideal / bound if bound else 0.0,
        "model_flops": rec["model_flops"],
        "traced_flops_total": traced,
        "flops_ratio": rec["model_flops"] / max(traced, 1),
        "hbm_fit_gib": (rec["memory"]["argument_bytes"]
                        + (rec["memory"]["temp_bytes"] or 0)) / 2**30,
        "fits": rec.get("fits"),
    }


def table(rows: list[dict]) -> str:
    out = [f"{'arch':20s} {'shape':11s} {'comp(s)':>9s} {'mem(s)':>9s} "
           f"{'coll(s)':>9s} {'dom':>10s} {'ideal(s)':>9s} {'frac':>6s} "
           f"{'useful':>7s} {'GiB':>8s} {'fits':>5s}"]
    for r in rows:
        if "skipped" in r:
            out.append(f"{r['arch']:20s} {r['shape']:11s}  -- skipped: "
                       f"{r['skipped'][:60]}")
            continue
        out.append(
            f"{r['arch']:20s} {r['shape']:11s} {r['compute_s']:9.4f} "
            f"{r['memory_s']:9.4f} {r['collective_s']:9.4f} "
            f"{r['dominant']:>10s} {r['ideal_s']:9.4f} "
            f"{r['roofline_fraction']:6.3f} {r['flops_ratio']:7.3f} "
            f"{r['hbm_fit_gib']:8.2f} {str(r['fits']):>5s}")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default="artifacts/dryrun")
    ap.add_argument("--mesh", default="h100")
    ap.add_argument("--csv", default=None)
    args = ap.parse_args(argv)
    cells = load_cells(Path(args.dir), args.mesh)
    rows = [roofline_row(c) for c in cells]
    live = [r for r in rows if "skipped" not in r]
    live.sort(key=lambda r: r["roofline_fraction"])
    skipped = [r for r in rows if "skipped" in r]
    print(f"{CARD} at {POWER_LIMIT_W:.0f} W: {PEAK_FLOPS:.3g} bf16 ops/s, "
          f"{HBM_BW:.3g} B/s HBM, {NVLINK_BW:.3g} B/s NVLink; mesh "
          f"{args.mesh}")
    print(table(live + skipped))
    if args.csv and live:
        import csv
        with open(args.csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(live[0]))
            w.writeheader()
            for r in live:
                w.writerow(r)
    if live:
        worst = live[0]
        print(f"\nworst roofline fraction: {worst['arch']}/{worst['shape']} "
              f"= {worst['roofline_fraction']:.3f} ({worst['dominant']}-"
              f"bound)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
