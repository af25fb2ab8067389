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


def test_the_plan_layer_is_checked():
    """The statistics, plan, verifier and serving modules are among the
    files checked above."""
    names = {str(f.relative_to(ROOT)) for f in _files()}
    for mod in ("stats", "plan", "frame", "context", "verify", "faults",
                "plan_cache", "serving"):
        assert f"src/repro_torch/core/{mod}.py" in names, mod


def test_the_pipeline_and_the_harnesses_are_checked():
    """The data pipeline and the testing harnesses are among the files
    checked above, and importing them loads neither jax nor repro."""
    names = {str(f.relative_to(ROOT)) for f in _files()}
    for mod in ("data/synthetic", "data/pipeline", "testing/compare",
                "testing/plan_fuzz", "testing/chaos_cases",
                "testing/dist_cases"):
        assert f"src/repro_torch/{mod}.py" in names, mod
    code = ("import sys\n"
            "import repro_torch.data, repro_torch.testing.compare\n"
            "from repro_torch.data import RelationalTokenPipeline, Prefetcher\n"
            "from repro_torch.data import lm_samples_table, lm_labels_table\n"
            "from repro_torch.testing import plan_fuzz, chaos_cases, dist_cases\n"
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_the_mesh_modules_are_checked():
    """The mesh (``launch/mesh.py``, ``core/mesh.py``) and the modules that
    read it are among the files checked above, and importing them loads
    neither jax nor repro."""
    names = {str(f.relative_to(ROOT)) for f in _files()}
    for mod in ("launch/mesh", "core/mesh", "models/common", "models/layers",
                "train/steps", "train/checkpoint", "launch/train",
                "launch/serve"):
        assert f"src/repro_torch/{mod}.py" in names, mod
    code = ("import sys\n"
            "from repro_torch.launch.mesh import make_local_mesh, "
            "make_production_mesh\n"
            "from repro_torch.launch import serve, train\n"
            "from repro_torch.train.steps import _quantize\n"
            "make_local_mesh(8, model=2, pod=2).view(('pod',))\n"
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_the_dry_run_and_the_roofline_are_checked():
    """The shapes, the dry run, the hillclimb, the roofline and the kernels'
    meta route are among the files checked above (so they import neither
    jax nor repro), and importing the dry run sets no environment
    variable."""
    names = {str(f.relative_to(ROOT)) for f in _files()}
    for mod in ("configs/shapes", "launch/dryrun", "launch/hillclimb",
                "roofline/analysis", "roofline/report", "kernels/meta"):
        assert f"src/repro_torch/{mod}.py" in names, mod
    code = ("import os\n"
            "before = dict(os.environ)\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.hillclimb\n"
            "assert dict(os.environ) == before\n"
            "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0 and out.stdout.startswith("clean"), \
        out.stdout + out.stderr
