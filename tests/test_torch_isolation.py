"""The port stands alone: importing every ``repro_torch`` module loads
neither JAX nor the JAX package (nor ``ml_dtypes``, which the card's
machine lacks), and no source line of the port or of ``chip_smoke.py``
imports them."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m in ("jax", "jaxlib", "repro", "ml_dtypes")
                or m.startswith(("jax.", "jaxlib.", "repro.", "ml_dtypes.")))
print(len(names), ",".join(leaked))
"""


def test_importing_the_port_loads_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, "-c", _PROBE], env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert run.returncode == 0, run.stderr
    count, leaked = run.stdout.split()[0], run.stdout.strip().partition(" ")[2]
    assert int(count) >= 20, run.stdout  # every module of the port was imported
    assert leaked == "", f"the port imported {leaked}"


def test_no_source_line_imports_jax_or_the_reference():
    pattern = re.compile(
        r"^\s*(import jax|from jax|import repro\b|from repro(\.| )|import ml_dtypes|from ml_dtypes)",
        re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []
