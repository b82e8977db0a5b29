"""Generate the roofline markdown table from the port's dry-run records
(``python -m repro_torch.launch.dryrun`` writes them).

    python scripts/gen_roofline_md_torch.py [mesh]

``mesh`` (h100x1, pod16x16 or pod2x16x16) keeps that mesh's rows, skips
and errors included; without it every record's row is printed.
"""
import json
import sys
from pathlib import Path

ART = (Path(__file__).resolve().parents[1] / "experiments" / "artifacts"
       / "dryrun_torch")


def fmt(x, digits=3):
    if x == 0:
        return "0"
    if x < 1e-3 or x >= 1e4:
        return f"{x:.2e}"
    return f"{x:.{digits}f}"


def main(mesh_filter=None):
    recs = [json.loads(p.read_text()) for p in sorted(ART.glob("*.json"))]
    recs = [r for r in recs if not mesh_filter or r["mesh"] == mesh_filter]
    print("| cell | mesh | bound | compute_s | memory_s | collective_s | "
          "coll GB/dev | useful_flops | roofline_frac | HBM/dev | "
          "fits 80GB | note |")
    print("|---|---|---|---|---|---|---|---|---|---|---|---|")
    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}
    recs.sort(key=lambda r: (r["arch"], order.get(r["shape"], 9), r["mesh"]))
    for r in recs:
        cell = f"{r['arch']} × {r['shape']}"
        if r["status"] == "skip":
            print(f"| {cell} | {r['mesh']} | — | — | — | — | — | — | — | — "
                  f"| — | skip: {r['reason'].split(':')[0]} |")
            continue
        if r["status"] != "ok":
            print(f"| {cell} | {r['mesh']} | ERROR | | | | | | | | | |")
            continue
        rf = r["roofline"]
        mem = r["memory"]
        print(f"| {cell} | {r['mesh']} | **{rf['bound']}** | "
              f"{fmt(rf['compute_s'])} | {fmt(rf['memory_s'])} | "
              f"{fmt(rf['collective_s'])} | "
              f"{fmt(rf['coll_bytes_per_device'] / 1e9)} | "
              f"{rf['useful_flop_fraction']:.2f} | "
              f"{rf['roofline_fraction']:.3f} | "
              f"{mem['hbm_estimate_bytes']/1e9:.1f}GB | "
              f"{'yes' if mem['fits_80gb'] else 'no'} | |")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
