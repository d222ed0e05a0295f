"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports ``jax`` or anything of the ``repro`` reference.

Checked twice: statically, by scanning every import statement's AST, and
dynamically, by importing every module in a fresh interpreter and reading
``sys.modules``.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_no_forbidden_import_statements():
    bad = []
    for path in _sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad
    assert len(_sources()) > 20         # the scan saw the whole package


def test_importing_every_module_loads_no_jax():
    code = """
import importlib, importlib.util, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
loaded = sorted(n for n in sys.modules
                if n.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len([n for n in sys.modules if n.startswith("repro_torch")]))
assert not loaded, loaded
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code,
                          str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 20


def test_core_and_configs_load_no_kernel_module():
    """The layers point down: ``core`` and ``configs`` import nothing of
    ``repro_torch.kernels`` (the kernels build on core, not the reverse)."""
    code = """
import sys
import repro_torch.configs, repro_torch.core.activations
import repro_torch.core.quantization
loaded = sorted(n for n in sys.modules
                if n.startswith(("repro_torch.kernels", "repro_torch.models")))
assert not loaded, loaded
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
