"""The port and chip_smoke.py import neither jax nor the JAX package."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(r"^\s*(import jax|from jax|import repro\.|"
                       r"import repro\b|from repro[\s.])", re.M)


def _sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_or_repro_import(path):
    text = path.read_text()
    hits = [m.group(0).strip() for m in FORBIDDEN.finditer(text)]
    assert not hits, f"{path}: {hits}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.serve, repro_torch.convert,"
            " repro_torch.kernels.cuda, repro_torch.kernels.build;"
            " bad = sorted(m for m in sys.modules"
            " if m == 'jax' or m.startswith(('jax.', 'repro.')) or m == 'repro');"
            " print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
