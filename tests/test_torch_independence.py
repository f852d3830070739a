"""The PyTorch port stands alone: no module of mere_fusion_tpu_torch, and not
chip_smoke.py, imports jax, flax or the JAX package."""
from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "mere_fusion_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "mere_fusion_tpu")


def _port_sources() -> list[str]:
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _dirs, files in os.walk(PORT):
        paths += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _imported_roots(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module)
    return roots


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import_in_source(path):
    bad = sorted(m for m in _imported_roots(path)
                 if m.split(".")[0] in FORBIDDEN
                 and not (m == "mere_fusion_tpu_torch" or m.startswith("mere_fusion_tpu_torch.")))
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "for name in ('jax', 'jaxlib', 'flax', 'mere_fusion_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import mere_fusion_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "assert not any(k.split('.')[0] in ('jax', 'flax') and sys.modules[k] is not None\n"
        "               for k in list(sys.modules))\n"
        "print(len(mods))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 25
