"""Dump the top collectives of one dry-run cell of the port on a production
mesh, attributed to the port's call sites (the twin of
``scripts/probe_collectives.py``, which attributes them by XLA's
``op_name``).  The cell is traced as rank 0 of the mesh on ``meta``
tensors over a fake process group (``repro_torch.launch.dryrun``); no
card, a few seconds on a CPU.

  PYTHONPATH=src python scripts/probe_collectives_torch.py qwen2-7b train_4k single [top]

``single`` is pod16x16, ``multi`` pod2x16x16.  Each row: calls, op, the
payload of one call (the whole tensor a rank gives or takes), its shape
and dtype, the port's kind, the call site (the innermost frame of the port
outside ``launch/sharding.py``) and the ring-model wire bytes of all the
calls.
"""
import sys

from repro_torch.launch.dryrun import trace_cell

MESHES = {"single": "pod16x16", "multi": "pod2x16x16"}


def main():
    arch, shape_name, mesh_kind = sys.argv[1], sys.argv[2], sys.argv[3]
    top = int(sys.argv[4]) if len(sys.argv) > 4 else 20
    rec, stats = trace_cell(arch, shape_name, mesh=MESHES[mesh_kind])
    if stats is None:
        print(f"{arch} x {shape_name}: {rec['status']}: {rec['reason']}")
        return
    print(f"flops/dev {stats.flops:.3e}  "
          f"hbm_adj {stats.hbm_bytes_kernel_adj / 1e12:.2f}TB  "
          f"coll {stats.collective_bytes / 1e9:.1f}GB  "
          f"{stats.collective_bytes_by_op}")
    for row in stats.collective_sites[:top]:
        shape = f"{row['dtype'].removeprefix('torch.')}{row['shape']}"
        print(f"{row['calls']:5d}x {row['op']:14s} "
              f"{row['payload_bytes'] / 1e6:9.1f}MB "
              f"{shape:36s} {row['kind']:18s} {row['site']:44s} "
              f"{row['wire_bytes'] / 1e9:8.2f}GB")


if __name__ == "__main__":
    main()
