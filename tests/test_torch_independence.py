"""The PyTorch port stands alone: no module of mere_fusion_tpu_torch (its
scripts/ included), and not chip_smoke.py, imports jax, flax, optax, the JAX
package or the JAX package's scripts/; the optional tensorstore, h5py and
orbax are imported only inside the functions that read their formats."""
from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "mere_fusion_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mere_fusion_tpu", "scripts")
# modules the import walk must reach, among them each slice's newest
REQUIRED = (
    "mere_fusion_tpu_torch.engines.base",
    "mere_fusion_tpu_torch.transport.mp4",
    "mere_fusion_tpu_torch.transport.flv",
    "mere_fusion_tpu_torch.models.s3fd",
    "mere_fusion_tpu_torch.models.fan",
    "mere_fusion_tpu_torch.models.bisenet",
    "mere_fusion_tpu_torch.tools.genavatar",
    "mere_fusion_tpu_torch.convert",
    "mere_fusion_tpu_torch.asr.backends",
    "mere_fusion_tpu_torch.asr.streaming",
    "mere_fusion_tpu_torch.asr.sentences",
    "mere_fusion_tpu_torch.asr.vad",
    "mere_fusion_tpu_torch.asr.align",
    "mere_fusion_tpu_torch.asr.normalizers",
    "mere_fusion_tpu_torch.asr.numwords",
    "mere_fusion_tpu_torch.asr.spelling",
    "mere_fusion_tpu_torch.asr.writers",
    "mere_fusion_tpu_torch.asr.simulate",
    "mere_fusion_tpu_torch.asr.server",
    "mere_fusion_tpu_torch.asr.__main__",
    "mere_fusion_tpu_torch.brain.orchestrator",
    "mere_fusion_tpu_torch.llm",
    "mere_fusion_tpu_torch.perception",
    "mere_fusion_tpu_torch.perception.__main__",
    "mere_fusion_tpu_torch.models.yolo",
    "mere_fusion_tpu_torch.models.face_attrs",
    "mere_fusion_tpu_torch.models.ocr",
    "mere_fusion_tpu_torch.utils.yolo_convert",
    "mere_fusion_tpu_torch.utils.keras_convert",
    "mere_fusion_tpu_torch.utils.bpe",
    "mere_fusion_tpu_torch.utils.env",
    "mere_fusion_tpu_torch.server.upstream",
    "mere_fusion_tpu_torch.models.lpips",
    "mere_fusion_tpu_torch.train.metrics",
    "mere_fusion_tpu_torch.train.viewer",
    "mere_fusion_tpu_torch.tools.face_tracking",
    "mere_fusion_tpu_torch.tools.render_3dmm",
    "mere_fusion_tpu_torch.tools.nerf_data",
    "mere_fusion_tpu_torch.models.rtmpose",
    "mere_fusion_tpu_torch.ops.quant",
    "mere_fusion_tpu_torch.scripts.prof_r5_int8",
    "mere_fusion_tpu_torch.utils.checkpoint",
    "mere_fusion_tpu_torch.tools.convert_ckpt",
)
# optional packages a module may import only inside the function that needs
# them, each raising an ImportError that names it when absent
LAZY = ("tensorstore", "h5py", "orbax")


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


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_optional_packages_import_inside_functions(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    top = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            top |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            top.add(node.module.split(".")[0])
    assert not top & set(LAZY), f"{os.path.relpath(path, ROOT)} imports {top & set(LAZY)}"


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'mere_fusion_tpu', 'scripts',\n"
        "             'tensorstore', 'h5py', 'orbax'):\n"
        "    sys.modules[name] = None\n"
        "import mere_fusion_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "assert not any(k.split('.')[0] in ('jax', 'flax', 'optax')\n"
        "               and sys.modules[k] is not None\n"
        "               for k in list(sys.modules))\n"
        "print(' '.join(mods))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    mods = proc.stdout.split()
    assert len(mods) >= 25 and not set(REQUIRED) - set(mods), sorted(set(REQUIRED) - set(mods))
