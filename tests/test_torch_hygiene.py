"""The port stands alone: no module of repro_torch, and not chip_smoke.py,
imports JAX or the JAX package."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _forbidden_imports(path: Path) -> list[str]:
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{path.relative_to(ROOT)}:{node.lineno}: {name}")
    return bad


#: the port's entry points outside the package: they stand alone too
ENTRY_POINTS = [ROOT / "chip_smoke.py",
                ROOT / "examples" / "online_reestimation_torch.py",
                ROOT / "examples" / "quickstart_torch.py",
                ROOT / "examples" / "heterogeneous_schedule_torch.py",
                ROOT / "examples" / "train_lm_torch.py",
                ROOT / "examples" / "serve_decode_torch.py",
                ROOT / "scripts" / "report_trace_torch.py",
                ROOT / "scripts" / "dev_smoke_torch.py",
                ROOT / "scripts" / "gen_roofline_md_torch.py"]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + ENTRY_POINTS,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    assert _forbidden_imports(path) == []


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 15, mods\n"
        "need = {'repro_torch.core.state', 'repro_torch.core.tick',\n"
        "        'repro_torch.obs.trace', 'repro_torch.obs.calibration',\n"
        "        'repro_torch.obs.profiling', 'repro_torch.obs.registry',\n"
        "        'repro_torch.obs.report', 'repro_torch.online.buffer',\n"
        "        'repro_torch.online.executor', 'repro_torch.online.fleet',\n"
        "        'repro_torch.launch.mesh', 'repro_torch.launch.train',\n"
        "        'repro_torch.optim.adamw', 'repro_torch.optim.compress',\n"
        "        'repro_torch.checkpoint.store'}\n"
        "assert need <= set(mods), sorted(need - set(mods))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
