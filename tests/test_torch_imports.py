"""The port stands alone: nothing under src/repro_torch/, and not
chip_smoke.py, imports jax or the JAX package ``repro``."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_no_port_file_imports_jax_or_repro():
    files = _files()
    assert len(files) > 10 and all(f.exists() for f in files)
    bad = {str(f.relative_to(ROOT)): sorted(_imported_roots(f) & FORBIDDEN)
           for f in files if _imported_roots(f) & FORBIDDEN}
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(ROOT / "src" / "repro_torch")
                                  .with_suffix("").parts)
        for p in (ROOT / "src" / "repro_torch").rglob("*.py")
        if p.name != "__init__.py")
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print('clean', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("clean")
